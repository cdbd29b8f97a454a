"""Population-batched linear layer: ``y[n] = act(x[n] @ w[n] + b[n])``.

The paper's core compute shape: N members' small matmuls as ONE launch.
Layout is the JAX package's (``repro.kernels.pop_matmul``): x (N,B,K),
w (N,K,M), optional bias (N,M) -> y (N,B,M), float32, act one of
none / relu / tanh.

:func:`pop_matmul` is the wrapper every caller uses. A tensor on the CPU
goes to :func:`pop_matmul_plain` (einsum + bias + act); a CUDA tensor goes
to the hand-written kernel in ``csrc/pop_matmul.cu`` or raises — there is
no fallback. The kernel masks ragged edges, so it takes every shape, and
fuses the bias and activation into its epilogue. ``pop_matmul.launches``
counts kernel launches (the plain version does not count).

x may be broadcast over members (``obs[None].expand(N, B, K)``, member
stride 0): the kernel is given the member stride and reads the one (B,K)
block for every member, so the broadcast costs no copy.

Forward only: inputs that require grad are refused until the backward
(an ``autograd.Function`` with batched-matmul gradients) is ported.
"""
from __future__ import annotations

import ctypes
import functools

import torch

ACTIVATIONS = ("none", "relu", "tanh")
_ACT_CODE = {"none": 0, "relu": 1, "tanh": 2}
_MAX_GRID = 65535   # CUDA's limit on grid.y (B tiles of 64) and grid.z (N)


def pop_matmul_plain(x, w, b=None, *, activation: str = "none"):
    """The plain PyTorch version: the reference the kernel is held to."""
    y = torch.einsum("nbk,nkm->nbm", x, w)
    if b is not None:
        y = y + b[:, None, :]
    if activation == "relu":
        return torch.relu(y)
    if activation == "tanh":
        return torch.tanh(y)
    return y


def _check(x, w, b, activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"pop_matmul: unsupported activation {activation!r} "
                         f"(one of {ACTIVATIONS})")
    tensors = (x, w) if b is None else (x, w, b)
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "pop_matmul is forward-only: an input requires grad, and the "
            "backward is not ported yet")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"pop_matmul takes float32 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"pop_matmul: tensors on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if x.ndim != 3 or w.ndim != 3:
        raise ValueError(f"pop_matmul: x must be (N,B,K) and w (N,K,M), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, _, k = x.shape
    if w.shape[0] != n or w.shape[1] != k:
        raise ValueError(f"pop_matmul: w {tuple(w.shape)} does not match "
                         f"x {tuple(x.shape)}")
    if b is not None and tuple(b.shape) != (n, w.shape[2]):
        raise ValueError(f"pop_matmul: b must be {(n, w.shape[2])}, got "
                         f"{tuple(b.shape)}")


def _member_stride(x) -> int:
    """The element stride between members of x, whose (B,K) blocks must be
    row-major and contiguous: B*K for a contiguous x, 0 for a broadcast."""
    n, bsz, k = x.shape
    if x.is_contiguous():
        return bsz * k
    if x.stride(0) == 0 and x[0].is_contiguous():
        return 0
    raise ValueError(f"pop_matmul: x of shape {tuple(x.shape)} and strides "
                     f"{x.stride()} is neither contiguous nor a contiguous "
                     f"(B,K) block broadcast over members")


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    lib = build.load("pop_matmul")
    fn = lib.pop_matmul_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.pop_matmul_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(x, w, b, activation):
    n, bsz, k = x.shape
    m = w.shape[2]
    if not (w.is_contiguous() and (b is None or b.is_contiguous())):
        raise ValueError("pop_matmul: w and b must be contiguous")
    if n > _MAX_GRID or -(-bsz // 64) > _MAX_GRID:
        raise ValueError(f"pop_matmul: N={n} or B={bsz} exceeds the grid")
    stride = _member_stride(x)
    y = torch.empty((n, bsz, m), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    fn, err = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), y.data_ptr(),
                n, bsz, k, m, stride, _ACT_CODE[activation], stream)
    if rc != 0:
        raise RuntimeError(f"pop_matmul kernel launch failed: CUDA error "
                           f"{rc} ({err(rc).decode()})")
    pop_matmul.launches += 1
    return y


def pop_matmul(x, w, b=None, *, activation: str = "none"):
    """``y[n] = act(x[n] @ w[n] + b[n])``: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, an error for anything else."""
    _check(x, w, b, activation)
    if x.device.type == "cpu":
        return pop_matmul_plain(x, w, b, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"pop_matmul: no kernel for device {x.device}")
    return _launch(x, w, b, activation)


pop_matmul.launches = 0
