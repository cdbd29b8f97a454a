"""hopper2d: a planar hopper of four rigid bodies (``repro.envs.hopper2d``),
batched over a leading env axis.

The physics tier of the paper's §4 GPU-sim argument: every body carries
its own pose and velocity (maximal coordinates), joints are spring-dampers
that pin anchor points together (with actuation, relative-angle damping
and soft angle limits), ground contacts are penalty springs with smooth
Coulomb friction, and ``substeps`` semi-implicit Euler steps make one
control step. The constants and tables are the JAX package's.

A state is a dict of ``pos`` (num, 4, 2), ``th`` (num, 4), ``vel``
(num, 4, 2), ``om`` (num, 4) and ``t`` (num,) int32. Body order: torso,
thigh, leg, foot.

:func:`hopper2d_step_plain` is the plain PyTorch control step, written a
body at a time so that forces and torques accumulate in the JAX code's
order (the ``.at[c].add(fj).at[p].add(-fj)`` sequence): float32 sums then
round as JAX's do. The env's raw step sends CPU tensors to it and CUDA
tensors to the hand-written kernel (:mod:`repro_torch.kernels.hopper2d`),
which runs every substep of one env in registers.

:func:`hopper2d_vec_step` is ``VecEnv.step``'s route on hopper2d: the
reset draws, then the raw step, the time limit, the auto-reset and the
episode accounting in one launch of the kernel's second entry point;
:func:`hopper2d_vec_step_plain` is the same composition as tensor code.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.distributed import member_draw

# body order: 0 torso, 1 thigh, 2 leg, 3 foot
H2D = dict(
    dt=0.002,            # integrator substep
    substeps=5,          # substeps per control step (control dt = 10 ms)
    gravity=9.8,
    length=(0.40, 0.45, 0.50, 0.39),      # rod lengths
    mass=(3.5, 4.0, 2.7, 5.1),            # ~ gym hopper link masses
    joint_k=4000.0,      # joint anchor spring stiffness
    joint_c=40.0,        # joint anchor damping
    rot_c=2.0,           # relative-angle damping at each joint
    limit_k=60.0,        # soft joint-limit spring (torque / rad)
    torque=(30.0, 30.0, 15.0),            # actuator gains (hip, knee, ankle)
    contact_k=6000.0,    # ground penalty stiffness
    contact_c=30.0,      # ground penalty damping
    friction=0.9,
    v_smooth=0.1,        # tanh friction smoothing velocity
    z_min=0.7,           # torso-height termination
    th_max=1.0,          # torso-angle termination
)

# joints: (parent, parent-frame anchor, child, child-frame anchor,
#          limit_lo, limit_hi): hip, knee, ankle
JOINTS = (
    (0, (0.0, -0.20), 1, (0.0, 0.225), -1.0, 1.0),
    (1, (0.0, -0.225), 2, (0.0, 0.25), -1.2, 1.2),
    (2, (0.0, -0.25), 3, (-0.0975, 0.0), -0.8, 0.8),
)

# ground-contact candidate points: (body, body-frame offset)
CONTACTS = (
    (3, (0.195, 0.0)), (3, (-0.195, 0.0)),    # foot toe / heel
    (2, (0.0, -0.25)),                        # leg bottom (kneeling)
    (0, (0.0, -0.20)), (0, (0.0, 0.20)),      # torso ends (falling over)
)

# upright rest pose: foot hovering at z=0.06, leg/thigh/torso stacked
# vertically above the ankle anchor (all body angles zero)
REST_POS = ((-0.0975, 1.21), (-0.0975, 0.785), (-0.0975, 0.31), (0.0, 0.06))


def _rot(th, lx, lz):
    """A body-frame offset rotated into the world frame: (x, z)."""
    c, s = torch.cos(th), torch.sin(th)
    return c * lx - s * lz, s * lx + c * lz


def _point_vel(vx, vz, om, rx, rz):
    """v + om x r, with om x (rx, rz) = om (-rz, rx) in 2D."""
    return vx + om * -rz, vz + om * rx


def _cross2(rx, rz, fx, fz):
    return rx * fz - rz * fx


def _forces(pos, th, vel, om, a):
    """Net world force (fx, fz lists of 4 (num,) tensors) and torque (list
    of 4) on every body, accumulated in the JAX code's order."""
    px, pz = list(pos[..., 0].unbind(-1)), list(pos[..., 1].unbind(-1))
    vx, vz = list(vel[..., 0].unbind(-1)), list(vel[..., 1].unbind(-1))
    th, om = list(th.unbind(-1)), list(om.unbind(-1))
    zero = torch.zeros_like(th[0])
    fx = [zero] * 4
    fz = [zero - H2D["gravity"] * torch.tensor(m, dtype=torch.float32)
          for m in H2D["mass"]]
    tau = [zero] * 4

    for j, (p, ra, c, rb, lo, hi) in enumerate(JOINTS):
        wax, waz = _rot(th[p], *ra)
        wbx, wbz = _rot(th[c], *rb)
        dx = (px[p] + wax) - (px[c] + wbx)
        dz = (pz[p] + waz) - (pz[c] + wbz)
        pvx, pvz = _point_vel(vx[p], vz[p], om[p], wax, waz)
        cvx, cvz = _point_vel(vx[c], vz[c], om[c], wbx, wbz)
        fjx = H2D["joint_k"] * dx + H2D["joint_c"] * (pvx - cvx)
        fjz = H2D["joint_k"] * dz + H2D["joint_c"] * (pvz - cvz)
        fx[c], fz[c] = fx[c] + fjx, fz[c] + fjz
        fx[p], fz[p] = fx[p] + -fjx, fz[p] + -fjz
        tau[c] = tau[c] + _cross2(wbx, wbz, fjx, fjz)
        tau[p] = tau[p] + _cross2(wax, waz, -fjx, -fjz)
        rel = th[c] - th[p]
        tj = (H2D["torque"][j] * a[:, j]
              - H2D["rot_c"] * (om[c] - om[p])
              - H2D["limit_k"] * (torch.clamp(rel - hi, min=0.0)
                                  + torch.clamp(rel - lo, max=0.0)))
        tau[c] = tau[c] + tj
        tau[p] = tau[p] + -tj

    for b, off in CONTACTS:
        rx, rz = _rot(th[b], *off)
        pwz = pz[b] + rz
        vwx, vwz = _point_vel(vx[b], vz[b], om[b], rx, rz)
        pen = torch.clamp(-pwz, min=0.0)
        active = (pen > 0.0).float()
        fn = torch.clamp(H2D["contact_k"] * pen - H2D["contact_c"] * vwz,
                         min=0.0) * active
        ft = -H2D["friction"] * fn * torch.tanh(vwx / H2D["v_smooth"])
        fx[b], fz[b] = fx[b] + ft, fz[b] + fn
        tau[b] = tau[b] + _cross2(rx, rz, ft, fn)
    return fx, fz, tau


KEYS = ("pos", "th", "vel", "om")


@functools.cache
def _constants(device):
    """Masses, inertias and the rest pose on ``device``, made once: a copy
    from the host inside a captured CUDA graph is refused."""
    m = torch.tensor(H2D["mass"], dtype=torch.float32, device=device)
    length = torch.tensor(H2D["length"], dtype=torch.float32, device=device)
    rest = torch.tensor(REST_POS, dtype=torch.float32, device=device)
    return m, m * length ** 2 / 12.0, rest   # thin rods about their centers


def hopper2d_obs(pos, th, vel, om):
    """The 11 observations: torso height, torso angle, the three relative
    joint angles, torso velocity, torso spin and the three relative joint
    spins."""
    return torch.stack([
        pos[:, 0, 1], th[:, 0], th[:, 1] - th[:, 0], th[:, 2] - th[:, 1],
        th[:, 3] - th[:, 2], vel[:, 0, 0], vel[:, 0, 1], om[:, 0],
        om[:, 1] - om[:, 0], om[:, 2] - om[:, 1], om[:, 3] - om[:, 2]], -1)


def hopper2d_step_plain(pos, th, vel, om, action):
    """One control step of ``num`` envs, the plain PyTorch version:
    ``(pos, th, vel, om, obs, reward, terminated)``."""
    a = torch.clamp(action, -1.0, 1.0)
    m, inertia, _ = _constants(pos.device)
    dt = H2D["dt"]
    x0 = pos[:, 0, 0]
    for _ in range(H2D["substeps"]):
        fx, fz, tau = _forces(pos, th, vel, om, a)
        f = torch.stack([torch.stack(fx, -1), torch.stack(fz, -1)], -1)
        vel = vel + dt * f / m[:, None]        # semi-implicit Euler:
        om = om + dt * torch.stack(tau, -1) / inertia   # velocities first,
        pos = pos + dt * vel                   # then positions from the
        th = th + dt * om                      # NEW velocities
    fwd = (pos[:, 0, 0] - x0) / (dt * H2D["substeps"])
    reward = fwd + 1.0 - 1e-3 * torch.sum(a ** 2, -1)
    terminated = (pos[:, 0, 1] < H2D["z_min"]) | \
        (torch.abs(th[:, 0]) > H2D["th_max"])
    return pos, th, vel, om, hopper2d_obs(pos, th, vel, om), reward, \
        terminated


def hopper2d_observe(state):
    return hopper2d_obs(state["pos"], state["th"], state["vel"], state["om"])


def reset_draws(generator, num: int, device="cpu"):
    """The uniform draws of ``num`` resets, ``(u_pos (num, 4, 2), u_th
    (num, 4))``, from ``generator`` (poses first)."""
    u_pos = member_draw(torch.rand, (num, 4, 2), generator).to(device)
    u_th = member_draw(torch.rand, (num, 4), generator).to(device)
    return u_pos, u_th


def fresh_state(u_pos, u_th):
    """Envs at the rest pose, each pose coordinate and angle moved by
    ``-5e-3 + 1e-2 u``, at rest, at t = 0."""
    num, device = u_th.shape[0], u_th.device
    return {
        "pos": _constants(device)[2] + (-5e-3 + 1e-2 * u_pos),
        "th": -5e-3 + 1e-2 * u_th,
        "vel": torch.zeros((num, 4, 2), dtype=torch.float32, device=device),
        "om": torch.zeros((num, 4), dtype=torch.float32, device=device),
        "t": torch.zeros((num,), dtype=torch.int32, device=device),
    }


def hopper2d_reset(generator, num: int, device="cpu"):
    """Fresh envs at the rest pose, each pose coordinate and angle moved by
    a uniform draw in [-5e-3, 5e-3) from ``generator`` (poses first)."""
    state = fresh_state(*reset_draws(generator, num, device))
    return state, hopper2d_observe(state)


def hopper2d_step(state, action):
    """The raw step: the CUDA kernel for CUDA tensors, the plain version
    for CPU ones. Returns ``(state, obs, reward, terminated)``."""
    from repro_torch.kernels.hopper2d import hopper2d_step as step
    pos, th, vel, om, obs, reward, terminated = step(
        *(state[k].contiguous() for k in KEYS), action.contiguous())
    new = dict(state, pos=pos, th=th, vel=vel, om=om, t=state["t"] + 1)
    return new, obs, reward, terminated


def hopper2d_vec_step_plain(pos, th, vel, om, t, action, u_pos, u_th,
                            accounts, episode_length: int):
    """The vector env's whole step on ``num`` envs, the plain PyTorch
    version: the raw step, the time limit and the auto-reset of
    :func:`repro_torch.envs.core.make` (finished envs take
    :func:`fresh_state` of the draws ``u_pos``, ``u_th``), and the episode
    accounting and transition flags of
    :meth:`repro_torch.rollout.vecenv.VecEnv.step`. ``accounts`` are the
    six (num,) accounting tensors, in ``VecEnvState``'s order. Returns ``(pos, th, vel, om,
    t, obs, terminal_obs, reward, done, truncated, done_f, truncated_f,
    accounts)``: ``obs`` after the reset, ``terminal_obs`` before it,
    ``done_f`` the transition's ``done & ~truncated`` as float."""
    *new, terminal_obs, reward, terminated = hopper2d_step_plain(
        pos, th, vel, om, action)
    new = dict(zip(KEYS, new), t=t + 1)
    truncated = ~terminated & (new["t"] >= episode_length)
    done = terminated | truncated
    fresh = fresh_state(u_pos, u_th)
    new = {k: torch.where(done.reshape(done.shape + (1,) * (v.ndim - 1)),
                          fresh[k], v) for k, v in new.items()}
    ret, length, episodes, ret_sum, len_sum, last = accounts
    ep_ret = ret + reward
    ep_len = length + 1
    accounts = (torch.where(done, 0.0, ep_ret), torch.where(done, 0, ep_len),
                episodes + done.int(), ret_sum + torch.where(done, ep_ret, 0.0),
                len_sum + torch.where(done, ep_len, 0),
                torch.where(done, ep_ret, last))
    return (*(new[k] for k in (*KEYS, "t")), hopper2d_observe(new),
            terminal_obs, reward, done, truncated,
            (done & ~truncated).float(), truncated.float(), accounts)


def hopper2d_vec_step(state, action, accounts, generator,
                      episode_length: int):
    """``VecEnv.step``'s route on hopper2d: the reset draws from
    ``generator`` (those :func:`hopper2d_reset` makes, on every step), then
    the whole step in one launch of the CUDA kernel for CUDA tensors, the
    plain version for CPU ones. ``state`` and ``action`` have a leading
    (num,) axis, ``accounts`` are the six (num,) accounting tensors.
    Returns ``(state, obs, terminal_obs, reward, done_f, truncated_f,
    accounts)``."""
    from repro_torch.kernels.hopper2d import hopper2d_vec_step as step
    u_pos, u_th = reset_draws(generator, action.shape[0], action.device)
    (*new, obs, terminal_obs, reward, _, _, done_f, truncated_f,
     accounts) = step(*(state[k].contiguous() for k in (*KEYS, "t")),
                      action.contiguous(), u_pos, u_th,
                      [a.contiguous() for a in accounts], episode_length)
    return (dict(state, **dict(zip((*KEYS, "t"), new))), obs, terminal_obs,
            reward, done_f, truncated_f, accounts)
