"""TD3 (Fujimoto et al., 2018): hyperparameters, actor init and the policy
(``repro.rl.td3``). The critic, target networks and ``update`` come with
the training slice; the state holds what serving needs."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.rl import networks as nets

DEFAULT_HYPERS = {
    "actor_lr": 3e-4, "critic_lr": 3e-4, "policy_freq": 0.5,
    "noise": 0.2, "discount": 0.99,
}
NOISE_CLIP = 0.5
TAU = 0.005


class TD3State(NamedTuple):
    actor: Any


def init(generator, obs_dim: int, act_dim: int, hidden=nets.HIDDEN, *,
         device="cpu") -> TD3State:
    return TD3State(actor=nets.actor_init(generator, obs_dim, act_dim,
                                          hidden=hidden, device=device))


def policy(actor_params, obs, generator=None,
           exploration_noise: float = 0.1):
    """Deterministic tanh action; with a generator, plus clipped gaussian
    exploration noise."""
    a = nets.actor_apply(actor_params, obs)
    if generator is not None:
        noise = torch.randn(a.shape, generator=generator,
                            device=generator.device).to(a.device)
        a = torch.clamp(a + exploration_noise * noise, -1.0, 1.0)
    return a
