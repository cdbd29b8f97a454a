"""Environments (``repro.envs.core``), batched over a leading env axis.

Where the JAX package writes one env and ``vmap``s it, the port writes the
batch out: a state is a dict of ``(num,)`` tensors.

    env = make("pendulum")
    state, obs = env.reset(generator, num, device)
    state, obs, reward, done, truncated = env.step(state, action, generator)
    policy_input = env.observe(state)

Raw steps report only true termination; :func:`make` adds the
``spec.episode_length`` time limit as truncation and auto-resets finished
envs with draws from the generator given to ``step`` (the JAX package
keeps a key in the state instead). On a ``done`` step the returned ``obs``
is the pre-reset terminal observation, and the next policy input comes
from ``env.observe(state)`` — the JAX package's terminal-observation
contract.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class EnvSpec:
    name: str
    obs_dim: int
    act_dim: int            # continuous dims, or number of discrete actions
    discrete: bool
    episode_length: int
    act_limit: float = 1.0


@dataclass(frozen=True)
class Env:
    spec: EnvSpec
    reset: Callable         # (generator, num, device) -> (state, obs)
    step: Callable          # (state, action, generator) ->
                            #   (state, obs, reward, done, truncated)
    observe: Callable       # state -> obs (post-auto-reset policy input)


# ---------------------------------------------------------------------------
# pendulum (continuous; the HalfCheetah stand-in for SAC/TD3 studies)
# ---------------------------------------------------------------------------

_PEND = dict(max_speed=8.0, max_torque=2.0, dt=0.05, g=10.0, m=1.0, l=1.0)


def _uniform(generator, num, lo, hi, device):
    u = torch.rand((num,), generator=generator, device=generator.device)
    return (lo + (hi - lo) * u).to(device)


def _pendulum_obs(s):
    th, thdot = s["theta"], s["thetadot"]
    return torch.stack([torch.cos(th), torch.sin(th),
                        thdot / _PEND["max_speed"]], -1)


def _pendulum_reset(generator, num: int, device="cpu"):
    state = {
        "theta": _uniform(generator, num, -math.pi, math.pi, device),
        "thetadot": _uniform(generator, num, -1.0, 1.0, device),
        "t": torch.zeros((num,), dtype=torch.int32, device=device),
    }
    return state, _pendulum_obs(state)


def _pendulum_step(state, action):
    mt = _PEND["max_torque"]
    u = torch.clamp(action[..., 0] * mt, -mt, mt)
    th, thdot = state["theta"], state["thetadot"]
    norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
    cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
    g, m, l, dt = (_PEND[k] for k in ("g", "m", "l", "dt"))
    thdot = thdot + (3 * g / (2 * l) * torch.sin(th)
                     + 3.0 / (m * l ** 2) * u) * dt
    thdot = torch.clamp(thdot, -_PEND["max_speed"], _PEND["max_speed"])
    th = th + thdot * dt
    new = dict(state, theta=th, thetadot=thdot, t=state["t"] + 1)
    # never terminates; episodes end by the wrapper's time-limit truncation
    return (new, _pendulum_obs(new), -cost / 10.0,
            torch.zeros_like(th, dtype=torch.bool))


# ---------------------------------------------------------------------------
# reacher (continuous point-mass reaching; the Humanoid stand-in for DvD)
# ---------------------------------------------------------------------------


def _reacher_obs(s):
    return torch.cat([s["pos"], s["vel"], s["target"] - s["pos"]], -1)


def _reacher_reset(generator, num: int, device="cpu"):
    u = torch.rand((num, 2), generator=generator, device=generator.device)
    zeros = torch.zeros((num, 2), dtype=torch.float32, device=device)
    state = {
        "pos": zeros, "vel": zeros.clone(),
        "target": (-1.0 + 2.0 * u).to(device),
        "t": torch.zeros((num,), dtype=torch.int32, device=device),
    }
    return state, _reacher_obs(state)


def _reacher_step(state, action):
    a = torch.clamp(action, -1.0, 1.0)
    vel = 0.9 * state["vel"] + 0.1 * a
    pos = torch.clamp(state["pos"] + 0.1 * vel, -2.0, 2.0)
    dist = torch.linalg.vector_norm(pos - state["target"], dim=-1)
    reward = -dist - 0.01 * torch.sum(a ** 2, -1)
    new = dict(state, pos=pos, vel=vel, t=state["t"] + 1)
    return (new, _reacher_obs(new), reward,
            torch.zeros_like(dist, dtype=torch.bool))


# ---------------------------------------------------------------------------


def _rows(mask, like):
    """An (num,) mask shaped to select whole rows of ``like`` (num, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.ndim - 1))


def _with_auto_reset(reset_fn, raw_step, episode_length: int):
    """Time limit + auto-reset: finished envs restart from fresh draws; the
    returned ``obs`` stays the pre-reset terminal observation."""
    def step(state, action, generator):
        new, obs, reward, terminated = raw_step(state, action)
        truncated = ~terminated & (new["t"] >= episode_length)
        done = terminated | truncated
        fresh, _ = reset_fn(generator, done.shape[0], done.device)
        state = {k: torch.where(_rows(done, new[k]), fresh[k], new[k])
                 for k in new}
        return state, obs, reward, done, truncated
    return step


_REGISTRY = {
    "pendulum": (EnvSpec("pendulum", 3, 1, False, 200, 1.0),
                 _pendulum_reset, _pendulum_step, _pendulum_obs),
    "reacher": (EnvSpec("reacher", 6, 2, False, 100, 1.0),
                _reacher_reset, _reacher_step, _reacher_obs),
}
_NOT_PORTED = ("cartpole", "mountain_car", "acrobot", "hopper2d")


def make(name: str) -> Env:
    if name in _NOT_PORTED:
        raise NotImplementedError(f"env {name!r} is not ported yet "
                                  f"(ported: {sorted(_REGISTRY)})")
    if name not in _REGISTRY:
        raise ValueError(f"unknown env {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    spec, reset, raw_step, observe = _REGISTRY[name]
    return Env(spec=spec, reset=reset,
               step=_with_auto_reset(reset, raw_step, spec.episode_length),
               observe=observe)
