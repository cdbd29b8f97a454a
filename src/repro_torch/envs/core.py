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

import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.envs.hopper2d import (hopper2d_observe, hopper2d_reset,
                                       hopper2d_step, hopper2d_vec_step)


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
    # VecEnv.step's route where the env has one launch for its whole step
    # (hopper2d): (state, action, accounts, generator) -> (state, obs,
    # terminal_obs, reward, done_f, truncated_f, accounts), every tensor
    # with a leading (num,) axis; None takes the generic path
    vec_step: Callable | None = None


# ---------------------------------------------------------------------------
# pendulum (continuous; the HalfCheetah stand-in for SAC/TD3 studies)
# ---------------------------------------------------------------------------

_PEND = dict(max_speed=8.0, max_torque=2.0, dt=0.05, g=10.0, m=1.0, l=1.0)


def _uniform(generator, num, lo, hi, device):
    u = member_draw(torch.rand, (num,), generator)
    return (lo + (hi - lo) * u).to(device)


def _wrap(x):
    """An angle into [-pi, pi): ``torch.remainder`` takes the divisor's
    sign, as the JAX package's ``%`` does (``fmod`` would not)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


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
    norm_th = _wrap(th)
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
    u = member_draw(torch.rand, (num, 2), generator)
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
# cartpole (discrete; the Atari stand-in for DQN)
# ---------------------------------------------------------------------------


def _cartpole_obs(s):
    return s["x"]


def _cartpole_reset(generator, num: int, device="cpu"):
    u = member_draw(torch.rand, (num, 4), generator)
    state = {"x": (-0.05 + 0.1 * u).to(device),
             "t": torch.zeros((num,), dtype=torch.int32, device=device)}
    return state, _cartpole_obs(state)


def _cartpole_step(state, action):
    gravity, mc, mp, lp, fmag, dt = 9.8, 1.0, 0.1, 0.5, 10.0, 0.02
    x, xd, th, thd = state["x"].unbind(-1)
    force = torch.where(action.to(torch.int32) == 1, fmag, -fmag)
    cth, sth = torch.cos(th), torch.sin(th)
    tmp = (force + mp * lp * thd ** 2 * sth) / (mc + mp)
    thacc = (gravity * sth - cth * tmp) / (
        lp * (4.0 / 3 - mp * cth ** 2 / (mc + mp)))
    xacc = tmp - mp * lp * thacc * cth / (mc + mp)
    nx = torch.stack([x + dt * xd, xd + dt * xacc, th + dt * thd,
                      thd + dt * thacc], -1)
    fail = (nx[:, 0].abs() > 2.4) | (nx[:, 2].abs() > 0.2095)
    reward = 1.0 - fail.float()
    new = dict(state, x=nx, t=state["t"] + 1)
    return new, _cartpole_obs(new), reward, fail


# ---------------------------------------------------------------------------
# mountain_car (continuous; sparse-reward exploration scenario)
# ---------------------------------------------------------------------------

_MC = dict(power=0.0015, min_pos=-1.2, max_pos=0.6, max_speed=0.07,
           goal_pos=0.45)


def _mountain_car_obs(s):
    return torch.stack([s["pos"], s["vel"]], -1)


def _mountain_car_reset(generator, num: int, device="cpu"):
    state = {"pos": _uniform(generator, num, -0.6, -0.4, device),
             "vel": torch.zeros((num,), dtype=torch.float32, device=device),
             "t": torch.zeros((num,), dtype=torch.int32, device=device)}
    return state, _mountain_car_obs(state)


def _mountain_car_step(state, action):
    force = torch.clamp(action[..., 0], -1.0, 1.0)
    vel = state["vel"] + force * _MC["power"] \
        - 0.0025 * torch.cos(3 * state["pos"])
    vel = torch.clamp(vel, -_MC["max_speed"], _MC["max_speed"])
    pos = torch.clamp(state["pos"] + vel, _MC["min_pos"], _MC["max_pos"])
    vel = torch.where((pos <= _MC["min_pos"]) & (vel < 0), 0.0, vel)
    goal = pos >= _MC["goal_pos"]
    reward = 100.0 * goal.float() - 0.1 * force ** 2
    new = dict(state, pos=pos, vel=vel, t=state["t"] + 1)
    return new, _mountain_car_obs(new), reward, goal


# ---------------------------------------------------------------------------
# acrobot (discrete, 3 actions; the harder DQN scenario: 2-link swing-up)
# ---------------------------------------------------------------------------

_ACRO = dict(m=1.0, l=1.0, lc=0.5, i=1.0, g=9.8, dt=0.2,
             max_vel1=4 * math.pi, max_vel2=9 * math.pi)


def _acrobot_obs(s):
    th1, th2, d1, d2 = s["q"].unbind(-1)
    return torch.stack([torch.cos(th1), torch.sin(th1), torch.cos(th2),
                        torch.sin(th2), d1 / _ACRO["max_vel1"],
                        d2 / _ACRO["max_vel2"]], -1)


def _acrobot_reset(generator, num: int, device="cpu"):
    u = member_draw(torch.rand, (num, 4), generator)
    state = {"q": (-0.1 + 0.2 * u).to(device),
             "t": torch.zeros((num,), dtype=torch.int32, device=device)}
    return state, _acrobot_obs(state)


def _acrobot_dsdt(q, torque):
    m, l, lc, i, g = (_ACRO[k] for k in ("m", "l", "lc", "i", "g"))
    th1, th2, dth1, dth2 = q.unbind(-1)
    d1 = m * lc ** 2 + m * (l ** 2 + lc ** 2 + 2 * l * lc * torch.cos(th2)) \
        + 2 * i
    d2 = m * (lc ** 2 + l * lc * torch.cos(th2)) + i
    phi2 = m * lc * g * torch.cos(th1 + th2 - math.pi / 2)
    phi1 = (-m * l * lc * dth2 ** 2 * torch.sin(th2)
            - 2 * m * l * lc * dth2 * dth1 * torch.sin(th2)
            + (m * lc + m * l) * g * torch.cos(th1 - math.pi / 2) + phi2)
    ddth2 = ((torque + d2 / d1 * phi1 - m * l * lc * dth1 ** 2
              * torch.sin(th2) - phi2) / (m * lc ** 2 + i - d2 ** 2 / d1))
    ddth1 = -(d2 * ddth2 + phi1) / d1
    return torch.stack([dth1, dth2, ddth1, ddth2], -1)


def _acrobot_step(state, action):
    torque = action.float() - 1.0        # {0, 1, 2} -> {-1, 0, +1}
    q, dt = state["q"], _ACRO["dt"]
    # RK4 over the continuous dynamics (gym's integrator)
    k1 = _acrobot_dsdt(q, torque)
    k2 = _acrobot_dsdt(q + dt / 2 * k1, torque)
    k3 = _acrobot_dsdt(q + dt / 2 * k2, torque)
    k4 = _acrobot_dsdt(q + dt * k3, torque)
    nq = q + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    nq = torch.stack([_wrap(nq[:, 0]), _wrap(nq[:, 1]),
                      torch.clamp(nq[:, 2], -_ACRO["max_vel1"],
                                  _ACRO["max_vel1"]),
                      torch.clamp(nq[:, 3], -_ACRO["max_vel2"],
                                  _ACRO["max_vel2"])], -1)
    solved = -torch.cos(nq[:, 0]) - torch.cos(nq[:, 1] + nq[:, 0]) > 1.0
    reward = torch.where(solved, 0.0, -1.0)
    new = dict(state, q=nq, t=state["t"] + 1)
    return new, _acrobot_obs(new), reward, solved


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
    "cartpole": (EnvSpec("cartpole", 4, 2, True, 500),
                 _cartpole_reset, _cartpole_step, _cartpole_obs),
    "mountain_car": (EnvSpec("mountain_car", 2, 1, False, 200, 1.0),
                     _mountain_car_reset, _mountain_car_step,
                     _mountain_car_obs),
    "acrobot": (EnvSpec("acrobot", 6, 3, True, 500),
                _acrobot_reset, _acrobot_step, _acrobot_obs),
    # the physics tier (repro_torch.envs.hopper2d): rigid-body planar
    # hopper, one kernel launch a control step on the card
    "hopper2d": (EnvSpec("hopper2d", 11, 3, False, 400, 1.0),
                 hopper2d_reset, hopper2d_step, hopper2d_observe),
}
# the envs whose vector step is one kernel launch: the raw step, time
# limit, auto-reset and episode accounting together
_VEC_STEPS = {"hopper2d": hopper2d_vec_step}


def make(name: str) -> Env:
    if name not in _REGISTRY:
        raise ValueError(f"unknown env {name!r}; registered: "
                         f"{sorted(_REGISTRY)}")
    spec, reset, raw_step, observe = _REGISTRY[name]
    vec_step = _VEC_STEPS.get(name)
    return Env(spec=spec, reset=reset,
               step=_with_auto_reset(reset, raw_step, spec.episode_length),
               observe=observe,
               vec_step=None if vec_step is None else functools.partial(
                   vec_step, episode_length=spec.episode_length))
