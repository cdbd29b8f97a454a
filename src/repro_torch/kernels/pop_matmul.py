"""Population-batched linear layer: ``y[n] = act(x[n] @ w[n] + b[n])``.

The paper's core compute shape: N members' small matmuls as ONE launch.
Layout is the JAX package's (``repro.kernels.pop_matmul``): x (N,B,K),
w (N,K,M), optional bias (N,M) -> y (N,B,M), float32, act one of
none / relu / tanh.

:func:`pop_matmul` is the wrapper every caller uses. A tensor on the CPU
goes to :func:`pop_matmul_plain` (einsum + bias + act); a CUDA tensor goes
to the hand-written kernel in ``csrc/pop_matmul.cu`` or raises — there is
no fallback. The kernel masks ragged edges, so it takes every shape, and
fuses the bias and activation into its epilogue. It has two routes, which
:func:`_route` picks from M: ``tiled`` (M >= 16: 32x64 output tiles, K
double-buffered by ``cp.async``) and ``narrow`` (M < 16, the actor's and
critic's M=1 heads: one warp per batch row, K split over the lanes and
reduced by shuffles). ``pop_matmul.launches`` counts kernel launches and
``pop_matmul.launches_by_route`` splits them by route (the plain version
counts in neither).

x may be broadcast over members (``obs[None].expand(N, B, K)``, member
stride 0): the kernel is given the member stride and reads the one (B,K)
block for every member, so the broadcast costs no copy.

Gradients: when autograd records (grad mode on and an input requires
grad), the call goes through :class:`PopMatmul`, an
``autograd.Function`` whose forward is the same kernel (or plain version)
and whose backward is one code path on every device: the activation's
derivative from the saved output, then ``torch.bmm`` for dx and dw and a
sum for db. That is what the JAX package does too: its ``custom_vjp``
(``repro.rl.networks._pop_matmul_bwd``) takes the backward as batched
einsums outside any Pallas kernel. Only the gradients autograd asks for
are computed; a call that records nothing saves nothing (the target
networks' forwards run under ``torch.no_grad()``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import differentiated

ACTIVATIONS = ("none", "relu", "tanh")
_ACT_CODE = {"none": 0, "relu": 1, "tanh": 2}
_MAX_GRID = 65535   # CUDA's limit on grid.y (B tiles of 32) and grid.z (N)
ROUTES = ("tiled", "narrow")
NARROW_BELOW = 16   # M under this takes the narrow route


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


def _route(n: int, b: int, k: int, m: int) -> str:
    """The kernel route for an (N,B,K) x (N,K,M) call: ``narrow`` for
    M < 16, where a 64-column tile would leave most of its columns idle,
    ``tiled`` otherwise. N, B, K and a broadcast x do not change it."""
    return "narrow" if m < NARROW_BELOW else "tiled"


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    lib = build.load("pop_matmul")
    fn = lib.pop_matmul_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.pop_matmul_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(x, w, b, activation, route=None):
    """One kernel launch on ``route``, by default the one :func:`_route`
    picks (the tiled route takes every M; the narrow one M < 16)."""
    n, bsz, k = x.shape
    m = w.shape[2]
    if not (w.is_contiguous() and (b is None or b.is_contiguous())):
        raise ValueError("pop_matmul: w and b must be contiguous")
    if n > _MAX_GRID or -(-bsz // 32) > _MAX_GRID:
        raise ValueError(f"pop_matmul: N={n} or B={bsz} exceeds the grid")
    stride = _member_stride(x)
    y = torch.empty((n, bsz, m), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    route = route or _route(n, bsz, k, m)
    if route == "narrow" and m >= NARROW_BELOW:
        raise ValueError(f"pop_matmul: the narrow route takes M < "
                         f"{NARROW_BELOW}, got {m}")
    fn, err = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), y.data_ptr(),
                n, bsz, k, m, stride, _ACT_CODE[activation],
                ROUTES.index(route), stream)
    if rc != 0:
        raise RuntimeError(f"pop_matmul kernel launch failed: CUDA error "
                           f"{rc} ({err(rc).decode()})")
    pop_matmul.launches += 1
    pop_matmul.launches_by_route[route] += 1
    return y


def _forward(x, w, b, activation):
    if x.device.type == "cpu":
        return pop_matmul_plain(x, w, b, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"pop_matmul: no kernel for device {x.device}")
    return _launch(x, w, b, activation)


class PopMatmul(torch.autograd.Function):
    """``pop_matmul`` under autograd. The forward is the kernel (CUDA) or
    the plain version (CPU) with the bias and activation fused; it saves
    x, w and the activated output y. The backward, with dy_pre = dy *
    act'(y) (``y > 0`` for relu, ``1 - y^2`` for tanh):

        dx = dy_pre @ w^T,   dw = x^T @ dy_pre,   db = sum_B dy_pre
    """

    @staticmethod
    def forward(ctx, x, w, b, activation):
        y = _forward(x, w, b, activation)
        ctx.activation = activation
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        if ctx.activation == "relu":
            dy = dy * (y > 0)
        elif ctx.activation == "tanh":
            dy = dy * (1.0 - y * y)
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = torch.bmm(dy, w.transpose(1, 2)) if need_x else None
        dw = torch.bmm(x.transpose(1, 2), dy) if need_w else None
        db = dy.sum(1) if need_b and ctx.has_bias else None
        return dx, dw, db, None


def pop_matmul(x, w, b=None, *, activation: str = "none"):
    """``y[n] = act(x[n] @ w[n] + b[n])``: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors, an error for anything else.
    Differentiable: with grad mode on and an input that requires grad the
    call is recorded through :class:`PopMatmul`."""
    _check(x, w, b, activation)
    tensors = (x, w) if b is None else (x, w, b)
    if differentiated(*tensors):
        return PopMatmul.apply(x, w, b, activation)
    return _forward(x, w, b, activation)


pop_matmul.launches = 0
pop_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
