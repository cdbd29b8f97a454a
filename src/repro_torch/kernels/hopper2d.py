"""One control step of the planar hopper for every env at once.

The wrapper every caller uses is :func:`hopper2d_step`: a CPU tensor goes
to the plain version (:func:`repro_torch.envs.hopper2d.hopper2d_step_plain`,
tensor code a body at a time), a CUDA tensor to the hand-written kernel in
``csrc/hopper2d.cu`` or raises; there is no fallback. The kernel is the
port's own: the JAX package has no Pallas kernel for the step (XLA fuses
it), while the plain version is some 2,000 launches a control step. One
thread per env runs all substeps in registers and writes the new pose and
velocities, the observation, the reward and the termination flag.
``hopper2d_step.launches`` counts kernel launches.

Layout: pos (num, 4, 2), th (num, 4), vel (num, 4, 2), om (num, 4),
action (num, 3), float32, contiguous. The launch goes to
``torch.cuda.current_stream()``, so a CUDA graph captures it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

SHAPES = {"pos": (4, 2), "th": (4,), "vel": (4, 2), "om": (4,),
          "action": (3,)}
OBS_DIM = 11


def _check(pos, th, vel, om, action):
    named = dict(pos=pos, th=th, vel=vel, om=om, action=action)
    num = pos.shape[0] if pos.ndim else -1
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"hopper2d_step takes float32 tensors, got "
                            f"{name} {t.dtype}")
        if tuple(t.shape) != (num,) + SHAPES[name]:
            raise ValueError(f"hopper2d_step: {name} must be "
                             f"{(num,) + SHAPES[name]}, got "
                             f"{tuple(t.shape)}")
        if t.device != pos.device:
            raise ValueError("hopper2d_step: tensors on different devices")


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    lib = build.load("hopper2d")
    fn = lib.hopper2d_step_f32
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.hopper2d_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def kernel_info() -> dict:
    """The built kernel's registers a thread, threads a block and the
    blocks an SM can hold at once (``cudaOccupancyMaxActiveBlocksPer
    Multiprocessor``); needs the card."""
    from repro_torch.kernels import build
    fn = build.load("hopper2d").hopper2d_kernel_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    regs, threads, blocks = (ctypes.c_int(0) for _ in range(3))
    rc = fn(ctypes.byref(regs), ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"hopper2d kernel info: CUDA error {rc} "
                           f"({_kernel()[1](rc).decode()})")
    return {"registers": regs.value, "threads_per_block": threads.value,
            "blocks_per_sm": blocks.value}


def _launch(pos, th, vel, om, action):
    tensors = (pos, th, vel, om, action)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hopper2d_step: the kernel takes contiguous "
                         "tensors")
    num = pos.shape[0]
    outs = [torch.empty_like(t) for t in (pos, th, vel, om)]
    obs = torch.empty((num, OBS_DIM), dtype=torch.float32, device=pos.device)
    reward = torch.empty((num,), dtype=torch.float32, device=pos.device)
    terminated = torch.empty((num,), dtype=torch.bool, device=pos.device)
    fn, err = _kernel()
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream(pos.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in (*tensors, *outs, obs, reward,
                                         terminated)), num, stream)
    if rc != 0:
        raise RuntimeError(f"hopper2d kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    hopper2d_step.launches += 1
    return (*outs, obs, reward, terminated)


def hopper2d_step(pos, th, vel, om, action):
    """``(pos, th, vel, om, obs, reward, terminated)`` after one control
    step: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors, an error for anything else."""
    _check(pos, th, vel, om, action)
    if pos.device.type == "cpu":
        from repro_torch.envs.hopper2d import hopper2d_step_plain
        return hopper2d_step_plain(pos, th, vel, om, action)
    if pos.device.type != "cuda":
        raise ValueError(f"hopper2d_step: no kernel for device {pos.device}")
    return _launch(pos, th, vel, om, action)


hopper2d_step.launches = 0
