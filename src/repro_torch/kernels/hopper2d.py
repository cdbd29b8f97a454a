"""One control step of the planar hopper for every env at once, and the
vector env's whole step on it.

Two wrappers, each sending CPU tensors to its plain version and CUDA
tensors to its hand-written kernel in ``csrc/hopper2d.cu`` or raising;
there is no fallback:

* :func:`hopper2d_step`, the raw step (``Env.step``): the plain version is
  :func:`repro_torch.envs.hopper2d.hopper2d_step_plain`, tensor code a
  body at a time;
* :func:`hopper2d_vec_step`, ``VecEnv.step``'s route on hopper2d: the raw
  step, the time limit, the auto-reset from draws the caller makes, the
  episode accounting and the transition's flags. Its plain version is
  :func:`repro_torch.envs.hopper2d.hopper2d_vec_step_plain`, the generic
  path's composition in one function.

The kernels are the port's own: the JAX package has no Pallas kernel for
the step (XLA fuses it), while the plain versions are some 2,000 launches
a control step. Four threads an env, one a body, run all substeps in
registers. ``hopper2d_step.launches`` counts the launches of both;
``hopper2d_step.launches_by_route`` splits them into ``raw`` and ``vec``.

Layout: pos (num, 4, 2), th (num, 4), vel (num, 4, 2), om (num, 4),
action (num, 3), float32; t (num,) int32; the draws u_pos (num, 4, 2) and
u_th (num, 4), float32; the accounting tensors (num,) as ``ACCOUNTS``
types them. The kernels take contiguous tensors and launch on
``torch.cuda.current_stream()``, so a CUDA graph captures them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SHAPES = {"pos": (4, 2), "th": (4,), "vel": (4, 2), "om": (4,),
          "action": (3,), "t": (), "u_pos": (4, 2), "u_th": (4,)}
OBS_DIM = 11
ROUTES = ("raw", "vec")
# the vector env's accounting tensors, in VecEnvState's order
ACCOUNTS = {"episode_return": torch.float32,
            "episode_length": torch.int32,
            "completed_episodes": torch.int32,
            "completed_return_sum": torch.float32,
            "completed_length_sum": torch.int32,
            "last_episode_return": torch.float32}


def _check(what, named, dtypes):
    num = named["pos"].shape[0] if named["pos"].ndim else -1
    device = named["pos"].device
    for name, t in named.items():
        dtype = dtypes.get(name, torch.float32)
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got "
                            f"{t.dtype}")
        shape = (num,) + SHAPES.get(name, ())
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{what}: tensors on different devices")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {device}")
    return num, device


@functools.cache
def _lib():
    from repro_torch.kernels import build
    lib = build.load("hopper2d")
    lib.hopper2d_step_f32.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.hopper2d_vec_step_f32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.hopper2d_kernel_info.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 4
    for fn in (lib.hopper2d_step_f32, lib.hopper2d_vec_step_f32,
               lib.hopper2d_kernel_info):
        fn.restype = ctypes.c_int
    lib.hopper2d_error_string.argtypes = [ctypes.c_int]
    lib.hopper2d_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({_lib().hopper2d_error_string(rc).decode()})")


def kernel_info(route: str = "raw") -> dict:
    """A built kernel's (``route``: ``raw`` or ``vec``) registers a
    thread, threads a block, threads an env and the blocks an SM can hold
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); needs
    the card."""
    out = [ctypes.c_int(0) for _ in range(4)]
    _raise_on(_lib().hopper2d_kernel_info(
        ROUTES.index(route), *(ctypes.byref(x) for x in out)),
        "hopper2d kernel info")
    regs, threads, per_env, blocks = (x.value for x in out)
    return {"registers": regs, "threads_per_block": threads,
            "threads_per_env": per_env, "blocks_per_sm": blocks}


def _launch(route, fn, inputs, outputs, *args):
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError(f"hopper2d {route}: the kernel takes contiguous "
                         f"tensors")
    device = inputs[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [t.data_ptr() for t in (*inputs, *outputs)]
        if route == "vec":
            rc = fn((ctypes.c_void_p * len(ptrs))(*ptrs), *args, stream)
        else:
            rc = fn(*ptrs, *args, stream)
    _raise_on(rc, f"hopper2d {route} kernel launch")
    hopper2d_step.launches += 1
    hopper2d_step.launches_by_route[route] += 1


def hopper2d_step(pos, th, vel, om, action):
    """``(pos, th, vel, om, obs, reward, terminated)`` after one control
    step: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors, an error for anything else."""
    inputs = dict(pos=pos, th=th, vel=vel, om=om, action=action)
    num, device = _check("hopper2d_step", inputs, {})
    if device.type == "cpu":
        from repro_torch.envs.hopper2d import hopper2d_step_plain
        return hopper2d_step_plain(pos, th, vel, om, action)
    outs = [torch.empty_like(t) for t in (pos, th, vel, om)]
    obs = torch.empty((num, OBS_DIM), dtype=torch.float32, device=device)
    reward = torch.empty((num,), dtype=torch.float32, device=device)
    terminated = torch.empty((num,), dtype=torch.bool, device=device)
    _launch("raw", _lib().hopper2d_step_f32, list(inputs.values()),
            (*outs, obs, reward, terminated), num)
    return (*outs, obs, reward, terminated)


hopper2d_step.launches = 0
hopper2d_step.launches_by_route = dict.fromkeys(ROUTES, 0)


def hopper2d_vec_step(pos, th, vel, om, t, action, u_pos, u_th, accounts,
                      episode_length: int):
    """The vector env's whole step on hopper2d: ``(pos, th, vel, om, t,
    obs, terminal_obs, reward, done, truncated, done_f, truncated_f,
    accounts)``, finished envs (terminated, or at ``episode_length``)
    reset to the rest pose moved by ``-5e-3 + 1e-2 u``; ``obs`` after the
    reset, ``terminal_obs`` before it, ``done_f`` the transition's ``done
    & ~truncated`` as float, ``accounts`` (six, ``ACCOUNTS``) updated. The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors, an
    error for anything else."""
    accounts = tuple(accounts)
    if len(accounts) != len(ACCOUNTS):
        raise ValueError(f"hopper2d_vec_step: {len(ACCOUNTS)} accounting "
                         f"tensors ({', '.join(ACCOUNTS)}), got "
                         f"{len(accounts)}")
    inputs = dict(pos=pos, th=th, vel=vel, om=om, t=t, action=action,
                  u_pos=u_pos, u_th=u_th, **dict(zip(ACCOUNTS, accounts)))
    num, device = _check("hopper2d_vec_step", inputs,
                         {"t": torch.int32, **ACCOUNTS})
    if device.type == "cpu":
        from repro_torch.envs.hopper2d import hopper2d_vec_step_plain
        return hopper2d_vec_step_plain(pos, th, vel, om, t, action, u_pos,
                                       u_th, accounts, episode_length)
    empty = functools.partial(torch.empty, device=device)
    outs = [*(torch.empty_like(x) for x in (pos, th, vel, om, t)),
            empty((num, OBS_DIM)), empty((num, OBS_DIM)), empty((num,)),
            empty((num,), dtype=torch.bool), empty((num,), dtype=torch.bool),
            empty((num,)), empty((num,))]
    new_accounts = tuple(torch.empty_like(a) for a in accounts)
    _launch("vec", _lib().hopper2d_vec_step_f32, list(inputs.values()),
            (*outs, *new_accounts), num, episode_length)
    return (*outs, new_accounts)
