"""``Evaluator`` — deterministic evaluation episodes
(``repro.rollout.evaluator``).

PBT consumes a per-member fitness: one call plays the first episode of
``num_envs`` fresh envs per member with the deterministic policy
(exploration off) for ``num_steps`` steps (the env's episode length
unless given) and returns the mean first-episode return per member, an
(N,) tensor on the device. Every env stops accumulating at its first
episode end, so auto-reset never leaks a second episode into the score.

The action is the deterministic forward that
:meth:`repro_torch.serve.PolicyForward.member` defines (the exploration
policy with no generator), batched over members: each member acts on its
own envs, so the call is one ``pop_policy`` on (N, E, obs) and every layer
is one ``pop_matmul`` launch on the card. The fitness that promotes a
member therefore describes the policy that serves.
"""
from __future__ import annotations

import torch

from repro_torch.envs.core import Env
from repro_torch.rollout.vecenv import VecEnv
from repro_torch.tree import leaves


class Evaluator:
    def __init__(self, env: Env, pop_policy_fn, *, num_envs: int = 4,
                 num_steps: int | None = None):
        """``pop_policy_fn(actors, obs)``: the deterministic population
        forward, (N, E, obs) -> (N, E, act); ``num_steps`` caps an
        evaluation's steps (the JAX package's ``eval_steps``)."""
        self.pop_policy_fn = pop_policy_fn
        self.venv = VecEnv(env, num_envs)
        self.num_steps = num_steps or env.spec.episode_length

    @torch.no_grad()
    def evaluate(self, actors, generator, init_state=None):
        """Per-member fitness, shape (N,): mean deterministic first-episode
        return over ``num_envs`` fresh evaluation episodes (or from
        ``init_state``, a population VecEnvState)."""
        first = leaves(actors)[0]
        vs = init_state if init_state is not None else self.venv.reset(
            generator, first.shape[0], first.device)
        ret = torch.zeros_like(vs.episode_return)
        alive = torch.ones_like(vs.episode_return)
        for _ in range(self.num_steps):
            actions = self.pop_policy_fn(actors, vs.obs)
            vs, trans = self.venv.step(vs, actions, generator)
            ret = ret + trans["reward"] * alive
            # episode END (termination or truncation): the running length
            # resets to 0 on either
            alive = alive * (1.0 - (vs.episode_length == 0).float())
        return ret.mean(-1)
