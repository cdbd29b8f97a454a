"""The experience contract (``repro.data.experience``): one protocol, two
storage disciplines.

  * ``replay``     — the population's FIFO ring
                     (:mod:`repro_torch.data.replay_buffer`): off-policy
                     learners (TD3, SAC, DQN) insert transitions and sample
                     uniform batches.
  * ``trajectory`` — :class:`TrajectoryBuffer`: on-policy learners (PPO)
                     store ONE fixed-length rollout an iteration, the
                     extras the acting policy emitted (``log_prob``,
                     ``value``) included, compute GAE on the device
                     (:func:`compute_gae`), and consume the rollout as
                     shuffled epoch minibatches before it is replaced.

The rollout engine picks the ops bundle from the agent's
``experience_kind`` (:func:`experience_ops`). Specs are ``name ->
(shape, dtype)`` of one item; buffers store exactly the keys their spec
declares, so a richer transition dict (the collector emits ``truncated``
and the extras unconditionally) is filtered down on ``add``.

The JAX package writes one member's buffer and ``vmap``s it; here the
population's buffer is one tree, every data leaf ``(N, T, E, ...)``
(time-major over the ``E`` envs of a member) and ``pos`` ``(N,)``, as the
replay ring is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.data.replay_buffer import (buffer_add, buffer_can_sample,
                                            buffer_init)
from repro_torch.device import device_tensor
from repro_torch.tree import leaves


def transition_spec(spec) -> dict:
    """One replay item for an env spec: name -> (shape, dtype)."""
    f32 = torch.float32
    action = (((), torch.int32) if spec.discrete
              else ((spec.act_dim,), f32))
    return {"obs": ((spec.obs_dim,), f32),
            "action": action,
            "reward": ((), f32),
            "next_obs": ((spec.obs_dim,), f32),
            "done": ((), f32)}


def trajectory_spec(spec, extras=("log_prob", "value")) -> dict:
    """One on-policy rollout step: the transition, the truncation flag (an
    episode end that must still bootstrap) and one float32 scalar per
    policy extra."""
    item = dict(transition_spec(spec))
    item["truncated"] = ((), torch.float32)
    for name in extras:
        item[name] = ((), torch.float32)
    return item


def select_items(batch, spec):
    """Filter a (possibly richer) transition dict down to a spec's keys."""
    return {k: batch[k] for k in spec}


# ---------------------------------------------------------------------------
# trajectory buffer: fixed-length on-policy rollouts
# ---------------------------------------------------------------------------


class TrajectoryBuffer(NamedTuple):
    """A population's fixed-length rollout store: data leaves ``(N, T, E,
    ...)`` and the fill position of each member, ``pos`` ``(N,)`` int32."""
    data: Any
    pos: torch.Tensor


def traj_init(n: int, num_steps: int, num_envs: int, item_spec: dict,
              device="cpu") -> TrajectoryBuffer:
    """``item_spec``: name -> (shape, dtype) of one step of one env (e.g.
    :func:`trajectory_spec`)."""
    data = {k: torch.zeros((n, num_steps, num_envs) + tuple(shape),
                           dtype=dtype, device=device)
            for k, (shape, dtype) in item_spec.items()}
    return TrajectoryBuffer(data=data, pos=torch.zeros(
        (n,), dtype=torch.int32, device=device))


def traj_add(buf: TrajectoryBuffer, steps) -> TrajectoryBuffer:
    """Append ``t`` time-major steps (leaves ``(N, t, E, ...)``) at each
    member's fill position. Keys beyond the buffer's spec are dropped;
    adding past capacity wraps around to the start (on-policy consumers
    drain the buffer every iteration, so a wrap is a caller's bug that
    ``pos`` makes visible).

    The steps are written into the buffer's tensors in place, indexed on
    the device (the position is never read back), so the returned buffer
    shares its data with ``buf``: keep using the returned one."""
    steps = select_items(steps, buf.data)
    n, t = leaves(steps)[0].shape[:2]
    cap = leaves(buf.data)[0].shape[1]
    dev = buf.pos.device
    rows = torch.arange(n, device=dev)[:, None]
    idx = (buf.pos[:, None].long() + torch.arange(t, device=dev)) % cap
    for k, store in buf.data.items():
        store[rows, idx] = steps[k].to(store.dtype)
    return TrajectoryBuffer(data=buf.data, pos=buf.pos + t)


def traj_full(buf: TrajectoryBuffer):
    """(N,) bool: which members' buffers hold a full rollout."""
    return buf.pos >= leaves(buf.data)[0].shape[1]


def traj_reset(buf: TrajectoryBuffer) -> TrajectoryBuffer:
    """Rewind the fill positions (the data is dead; the next add
    overwrites it). On-policy iterations reset before every collect."""
    return TrajectoryBuffer(data=buf.data, pos=torch.zeros_like(buf.pos))


# ---------------------------------------------------------------------------
# GAE, on the device, for the whole population at once
# ---------------------------------------------------------------------------


def compute_gae(reward, value, next_value, done, ep_end, discount, lam):
    """Generalized Advantage Estimation over time-major rollouts.

    Array args are ``(N, T, ...)`` (member, time, then any env axes);
    ``discount`` and ``lam`` are scalars or ``(N,)`` per-member tensors.

        delta_t = r_t + discount * V(s'_t) * (1 - done_t) - V(s_t)
        A_t     = delta_t + discount * lam * (1 - ep_end_t) * A_{t+1}

    The two masks differ on purpose: ``done`` is TERMINATION only, so a
    time-limit step still bootstraps from ``next_value`` (the value of the
    pre-reset terminal observation); ``ep_end`` is termination OR
    truncation, so the lambda chain never crosses an episode boundary (the
    auto-reset starts a fresh episode at t+1).

    A reverse loop over T. Returns ``(advantages, returns)`` with
    ``returns = advantages + value``."""
    def per_member(x):
        x = device_tensor(x, reward.dtype, reward.device)
        return x if x.ndim == 0 else x.reshape((-1,) + (1,) *
                                               (reward.ndim - 1))

    g, gl = per_member(discount), per_member(lam)
    delta = reward + g * next_value * (1.0 - done) - value
    decay = g * gl * (1.0 - ep_end)
    adv = torch.empty_like(reward)
    last = torch.zeros_like(reward[:, 0])
    for t in range(reward.shape[1] - 1, -1, -1):
        last = delta[:, t] + decay[:, t] * last
        adv[:, t] = last
    return adv, adv + value


# ---------------------------------------------------------------------------
# the ops bundle (protocol instance per experience kind)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExperienceOps:
    """The uniform half of the experience contract: what the rollout
    engine can do to ANY population buffer without knowing its kind.

    ``init(env_spec, n, device, **cfg) -> buf`` builds the population's
    buffer; ``add(buf, items) -> buf`` stores one collect's output
    (filtered to the spec: appended FIFO for replay, REPLACING the rollout
    for trajectory, whose data lives one iteration); ``ready(buf,
    batch_size) -> (N,) bool`` says which members can feed an update (a
    replay ring must hold a batch, a trajectory buffer a full rollout).
    """
    kind: str
    init: Callable
    add: Callable
    ready: Callable
    item_spec: Callable


def _replay_init(env_spec, n, device="cpu", *, capacity: int, **_):
    return buffer_init(n, capacity, transition_spec(env_spec), device)


def _trajectory_init(env_spec, n, device="cpu", *, num_steps: int,
                     num_envs: int, extras=("log_prob", "value"), **_):
    return traj_init(n, num_steps, num_envs,
                     trajectory_spec(env_spec, extras), device)


def _trajectory_store(buf, steps):
    """One iteration's rollout replaces the last one (its data is
    off-policy once the update has run)."""
    return traj_add(traj_reset(buf), steps)


EXPERIENCE_KINDS = {
    "replay": ExperienceOps(kind="replay", init=_replay_init, add=buffer_add,
                            ready=buffer_can_sample,
                            item_spec=transition_spec),
    "trajectory": ExperienceOps(kind="trajectory", init=_trajectory_init,
                                add=_trajectory_store,
                                ready=lambda buf, _=None: traj_full(buf),
                                item_spec=trajectory_spec),
}


def experience_ops(kind: str) -> ExperienceOps:
    ops = EXPERIENCE_KINDS.get(kind)
    if ops is None:
        raise ValueError(f"unknown experience kind {kind!r}; registered: "
                         f"{sorted(EXPERIENCE_KINDS)}")
    return ops
