"""``VecEnv`` — every member's ``num_envs`` environments as one batched
step (``repro.rollout.vecenv``).

The JAX package holds one member's envs and adds the member axis with an
outer ``vmap``; here every leaf of :class:`VecEnvState` is ``(N, E, ...)``
and one step moves all N*E envs. Episode accounting stays on the device:
running return and length per env, and completed-episode aggregates that
:func:`episode_stats` reduces to means.

Terminal observations follow :mod:`repro_torch.envs.core`: a transition's
``next_obs`` is the pre-reset terminal observation, while ``state.obs``
(the next policy input) is the post-reset observation. Episode accounting
counts terminations and time-limit truncations as episode ends, but the
transition's ``done`` is termination only, so TD targets bootstrap through
truncations; ``truncated`` rides along.

An env with a ``vec_step`` (hopper2d) takes it in place of the generic
path: its raw step, time limit, auto-reset and this accounting in one
kernel launch on the card, from the same reset draws.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.envs.core import Env


class VecEnvState(NamedTuple):
    env_state: Any                      # dict, leaves (N, E)
    obs: torch.Tensor                   # (N, E, obs_dim) next policy input
    episode_return: torch.Tensor        # (N, E) running return
    episode_length: torch.Tensor        # (N, E) int32 running length
    completed_episodes: torch.Tensor    # (N, E) int32
    completed_return_sum: torch.Tensor  # (N, E)
    completed_length_sum: torch.Tensor  # (N, E) int32
    last_episode_return: torch.Tensor   # (N, E) return of latest finished ep


def _split(x, n: int):
    return x.reshape((n, -1) + tuple(x.shape[1:]))


def _merge(x):
    return x.reshape((-1,) + tuple(x.shape[2:]))


class VecEnv:
    def __init__(self, env: Env, num_envs: int):
        self.env = env
        self.num_envs = num_envs
        self.spec = env.spec

    def reset(self, generator, n: int, device="cpu") -> VecEnvState:
        """Fresh envs for ``n`` members, drawn from ``generator``."""
        env_state, obs = self.env.reset(generator, n * self.num_envs, device)
        zf = torch.zeros((n, self.num_envs), device=device)
        zi = torch.zeros((n, self.num_envs), dtype=torch.int32, device=device)
        return VecEnvState(
            env_state={k: _split(v, n) for k, v in env_state.items()},
            obs=_split(obs, n), episode_return=zf, episode_length=zi,
            completed_episodes=zi, completed_return_sum=zf,
            completed_length_sum=zi, last_episode_return=zf)

    def step(self, state: VecEnvState, actions, generator):
        """One batched step of every env; auto-reset draws come from
        ``generator``. Returns ``(state, transition)`` with transition
        leaves (N, E, ...). An env with a ``vec_step`` (hopper2d) takes
        it: the whole step, accounting included, in one kernel launch on
        the card."""
        n = state.obs.shape[0]
        if self.env.vec_step is not None:
            return self._vec_step(state, actions, generator, n)
        env_state, terminal_obs, reward, done, truncated = self.env.step(
            {k: _merge(v) for k, v in state.env_state.items()},
            _merge(actions), generator)
        env_state = {k: _split(v, n) for k, v in env_state.items()}
        terminal_obs, reward, done, truncated = (
            _split(x, n) for x in (terminal_obs, reward, done, truncated))
        ep_ret = state.episode_return + reward
        ep_len = state.episode_length + 1
        new = VecEnvState(
            env_state=env_state,
            obs=_split(self.env.observe({k: _merge(v) for k, v in
                                         env_state.items()}), n),
            episode_return=torch.where(done, 0.0, ep_ret),
            episode_length=torch.where(done, 0, ep_len),
            completed_episodes=state.completed_episodes + done.int(),
            completed_return_sum=state.completed_return_sum
            + torch.where(done, ep_ret, 0.0),
            completed_length_sum=state.completed_length_sum
            + torch.where(done, ep_len, 0),
            last_episode_return=torch.where(done, ep_ret,
                                            state.last_episode_return))
        transition = {"obs": state.obs, "action": actions, "reward": reward,
                      "next_obs": terminal_obs,
                      "done": (done & ~truncated).float(),
                      "truncated": truncated.float()}
        return new, transition

    def _vec_step(self, state, actions, generator, n):
        env_state, obs, terminal_obs, reward, done, truncated, accounts = \
            self.env.vec_step({k: _merge(v) for k, v in
                               state.env_state.items()}, _merge(actions),
                              [_merge(x) for x in state[2:]], generator)
        new = VecEnvState({k: _split(v, n) for k, v in env_state.items()},
                          _split(obs, n), *(_split(x, n) for x in accounts))
        transition = {"obs": state.obs, "action": actions,
                      "reward": _split(reward, n),
                      "next_obs": _split(terminal_obs, n),
                      "done": _split(done, n),
                      "truncated": _split(truncated, n)}
        return new, transition


def episode_stats(state: VecEnvState):
    """Completed-episode means per member, reduced over the env axis."""
    count = state.completed_episodes.sum(-1)
    denom = torch.clamp(count, min=1).float()
    return {
        "episodes": count,
        "mean_return": state.completed_return_sum.sum(-1) / denom,
        "mean_length": state.completed_length_sum.sum(-1) / denom,
        "last_return": state.last_episode_return.mean(-1),
    }


def reset_stats(state: VecEnvState) -> VecEnvState:
    """Zero the completed-episode aggregates (a fresh logging window)
    without disturbing the environments themselves."""
    zi = torch.zeros_like(state.completed_episodes)
    return state._replace(
        completed_episodes=zi,
        completed_return_sum=torch.zeros_like(state.completed_return_sum),
        completed_length_sum=zi)
