"""The actors, critics and Q-networks of TD3, SAC and DQN, PPO's
categorical head and state-value critic with their log-probs and
entropies, and the population-batched applies (``repro.rl.networks``).

Standard size from Haarnoja et al. / Fujimoto et al.: 256-256 MLPs. DQN's
Q-network is that MLP, or the Atari torso of the paper's Fig. 2 DQN study
(84x84x4 frames -> 3136 features, then a [3136, 512, A] head).

The ``pop_*_apply`` family evaluates the same parametrization over
member-stacked parameters (leaves ``(N, ...)``) and member-batched inputs
``(N, B, ...)`` in one population-level call, each linear layer one
:func:`repro_torch.kernels.pop_matmul.pop_matmul` with the bias and
activation fused. Routing per linear is decided by ``fused``:

  * ``None`` / ``True`` — the ``pop_matmul`` wrapper: the CUDA kernel for a
    CUDA tensor (every shape; there is no tileability gate), its plain
    version for a CPU tensor;
  * ``False``           — always the plain einsum version.

Both routes are differentiable: the wrapper records its backward through
``repro_torch.kernels.pop_matmul.PopMatmul`` (batched matmuls), the plain
version through torch's own autograd.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.pop_matmul import (ACTIVATIONS, pop_matmul,
                                            pop_matmul_plain)
from repro_torch.nn.basic import (dqn_torso_apply, dqn_torso_init, mlp_apply,
                                  mlp_init)

HIDDEN = (256, 256)


def actor_init(generator, obs_dim: int, act_dim: int, hidden=HIDDEN, *,
               device="cpu"):
    return mlp_init(generator, [obs_dim, *hidden, act_dim], device=device)


def actor_apply(params, obs):
    return torch.tanh(mlp_apply(params, obs))


def gaussian_actor_init(generator, obs_dim: int, act_dim: int,
                        hidden=HIDDEN, *, device="cpu"):
    """SAC's actor: an MLP whose output is the mean and the log std."""
    return mlp_init(generator, [obs_dim, *hidden, 2 * act_dim],
                    device=device)


def _mean_log_std(out):
    mean, log_std = out.chunk(2, dim=-1)
    return mean, torch.clamp(log_std, -20.0, 2.0)


def gaussian_actor_apply(params, obs):
    """-> (mean, log_std), log_std clipped to [-20, 2]."""
    return _mean_log_std(mlp_apply(params, obs))


def sample_squashed(eps, mean, log_std):
    """Tanh-squashed gaussian sample and its log-prob (SAC), with the
    standard normal draw ``eps`` (the shape of ``mean``) given: the JAX
    package's ``sample_squashed`` and ``sac._squash``."""
    std = torch.exp(log_std)
    act = torch.tanh(mean + std * eps)
    logp = torch.sum(
        -0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
        - torch.log(torch.clamp(1 - act ** 2, min=1e-6)), dim=-1)
    return act, logp


def logits_init(generator, obs_dim: int, num_actions: int, hidden=HIDDEN,
                *, device="cpu"):
    """PPO's categorical-policy head (raw logits; apply with
    ``mlp_apply``)."""
    return mlp_init(generator, [obs_dim, *hidden, num_actions],
                    device=device)


def value_init(generator, obs_dim: int, hidden=HIDDEN, *, device="cpu"):
    """The state-value head V(s) (PPO's critic: no action input)."""
    return mlp_init(generator, [obs_dim, *hidden, 1], device=device)


def value_apply(params, obs):
    return mlp_apply(params, obs)[..., 0]


def gaussian_log_prob(mean, log_std, actions):
    """Diagonal-gaussian log-density of ``actions`` (summed over the action
    dims)."""
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((actions - mean) ** 2 / var + 2.0 * log_std
                             + math.log(2.0 * math.pi)), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e),
                     dim=-1)


def categorical_log_prob(logits, actions):
    # gather takes int64 indices; the trajectory buffer stores int32
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def critic_init(generator, obs_dim: int, act_dim: int, hidden=HIDDEN, *,
                device="cpu"):
    """Twin Q networks on ``concat(obs, act)``."""
    sizes = [obs_dim + act_dim, *hidden, 1]
    return {"q1": mlp_init(generator, sizes, device=device),
            "q2": mlp_init(generator, sizes, device=device)}


def critic_apply(params, obs, act):
    x = torch.cat([obs, act], dim=-1)
    return (mlp_apply(params["q1"], x)[..., 0],
            mlp_apply(params["q2"], x)[..., 0])


def q_net_init(generator, obs_dim: int, num_actions: int, hidden=HIDDEN,
               conv_torso: bool = False, *, device="cpu"):
    if conv_torso:          # Atari: 84x84x4 frames
        return {"torso": dqn_torso_init(generator, device=device),
                "head": mlp_init(generator, [3136, 512, num_actions],
                                 device=device)}
    return {"head": mlp_init(generator, [obs_dim, *hidden, num_actions],
                             device=device)}


def q_net_apply(params, obs):
    if "torso" in params:
        obs = dqn_torso_apply(params["torso"], obs)
    return mlp_apply(params["head"], obs)


def pop_linear_apply(p, x, *, activation: str = "none", fused=None):
    """Member-stacked linear: ``p`` {"w": (N,K,M), "b": (N,M)}, ``x``
    (N,B,K) -> act(x @ w + b), (N,B,M)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"pop_linear_apply: unsupported activation "
                         f"{activation!r} (none|relu|tanh)")
    fn = pop_matmul_plain if fused is False else pop_matmul
    return fn(x, p["w"], p.get("b"), activation=activation)


def pop_mlp_apply(p, x, *, activation: str = "relu",
                  final_activation: str | None = None, fused=None):
    """``mlp_apply`` over member-stacked params: same layer naming and
    activation placement, population-level."""
    n = len(p)
    for i in range(n):
        inner = activation if i < n - 1 else (final_activation or "none")
        x = pop_linear_apply(p[f"layer_{i}"], x, activation=inner,
                             fused=fused)
    return x


def pop_actor_apply(params, obs, *, fused=None):
    """Population-level ``actor_apply``: tanh MLP, (N,B,obs) -> (N,B,act)."""
    return pop_mlp_apply(params, obs, final_activation="tanh", fused=fused)


def pop_gaussian_actor_apply(params, obs, *, fused=None):
    """Population-level ``gaussian_actor_apply``: (N,B,obs) -> (mean,
    log_std), each (N,B,act)."""
    return _mean_log_std(pop_mlp_apply(params, obs, fused=fused))


def pop_value_apply(params, obs, *, fused=None):
    """Population-level ``value_apply``: (N,B,obs) -> (N,B)."""
    return pop_mlp_apply(params, obs, fused=fused)[..., 0]


def pop_critic_apply(params, obs, act, *, fused=None):
    """Population-level ``critic_apply``: (N,B,obs), (N,B,act) -> the twin
    Q values, each (N,B)."""
    x = torch.cat([obs, act], dim=-1)
    return (pop_mlp_apply(params["q1"], x, fused=fused)[..., 0],
            pop_mlp_apply(params["q2"], x, fused=fused)[..., 0])


def pop_q_net_apply(params, obs, *, fused=None):
    """Population-level ``q_net_apply`` of the MLP Q-network: (N,B,obs) ->
    (N,B,A). The Atari torso has no population-batched path, as in the JAX
    package."""
    if "torso" in params:
        raise ValueError("pop_q_net_apply: the Atari conv torso has no "
                         "population-batched path (MLP q-nets only)")
    return pop_mlp_apply(params["head"], obs, fused=fused)
