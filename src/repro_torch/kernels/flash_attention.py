"""Causal grouped-query attention forward (``repro.kernels.flash_attention``).

Layout is the TPU kernel's: q (B,H,S,D), k and v (B,Hkv,S,D) with H a
multiple of Hkv; query head h reads KV head ``h // (H // Hkv)``; the
result is (B,H,S,D) in q's type, scaled by ``D ** -0.5`` unless ``scale``
is given.

:func:`flash_attention` is the wrapper every caller uses. A tensor on the
CPU goes to :func:`flash_attention_plain`; a CUDA tensor goes to the
hand-written kernel in ``csrc/flash_attention.cu`` or raises: there is no
fallback. The kernel has two routes, by type: ``bf16_mma`` (the served
one: both products as bf16 ``mma.sync`` on the tensor cores, K and V
streamed through a two-stage ``cp.async`` ring in shared memory) and
``f32_fma`` (float32 FMAs on the CUDA cores, the reference-precision form
that only the float32 parity checks run). ``flash_attention.launches``
counts kernel launches and ``flash_attention.launches_by_route`` splits
them by route (the plain version counts in neither).

:func:`flash_attention_plain` is the JAX package's oracle
``ref.flash_attention_ref`` in PyTorch: float32 logits, masked to -1e30
above the diagonal, a float32 softmax, the probabilities cast to v's type
and multiplied with v in it. The kernel streams the same function over
key tiles (running max, sum and accumulator in float32, p rounded to v's
type before the product, as the TPU kernel does). In float32 the two
agree to rtol = atol = 2e-4 (sums over D and the keys in another order;
``tests/test_kernels.py``'s float32 tolerance), in bf16 to 2e-2 (the
kernel rounds unnormalised probabilities, the plain version normalised
ones); ``chip_smoke.py`` holds them to both on the card.

The kernel takes bf16 or float32 and head sizes :data:`DIMS`. q, k and v
may be strided views (the model hands over its (B,S,H,D) tensors
transposed) with unit stride along D, the other strides and the data
pointers on 16-byte boundaries, and k and v sharing one layout; it raises
on anything else. Its result is a (B,H,S,D) view of a (B,S,H,D) tensor,
so the model's transpose back is free.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import meta_call, refuse_grad

DIMS = (32, 64, 112, 128, 256)   # the head sizes the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)
ROUTES = {torch.bfloat16: "bf16_mma", torch.float32: "f32_fma"}
MASK = -1e30                     # the oracle's mask value


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None):
    """The plain PyTorch version: the reference the kernel is held to, and
    the CPU path."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hkv, h // hkv, s, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, MASK)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
    return out.reshape(b, h, s, d)


def _check(q, k, v):
    tensors = (q, k, v)
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"flash_attention takes float32 or bfloat16 tensors "
                        f"of one type, got {[str(t.dtype) for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention: tensors on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B,H,S,D) and k, v one "
                         f"(B,Hkv,S,D) shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    b, h, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or h % k.shape[1]:
        raise ValueError(f"flash_attention: k and v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (same B, S, D; H a "
                         f"multiple of Hkv)")
    if s == 0:
        raise ValueError("flash_attention: empty sequence")


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.POINTER(ctypes.c_longlong)] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = lib.flash_attention_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _strides(t):
    """(batch, head, sequence) element strides as a C array."""
    return (ctypes.c_longlong * 3)(t.stride(0), t.stride(1), t.stride(2))


def _launch(q, k, v, causal, scale):
    b, h, s, d = q.shape
    if d not in DIMS:
        raise ValueError(f"flash_attention: no kernel for head size D={d} "
                         f"(built for {DIMS})")
    if k.stride() != v.stride():
        raise ValueError(f"flash_attention: k and v must share one layout, "
                         f"got strides {k.stride()} and {v.stride()}")
    vec = 16 // q.element_size()
    if any(t.stride(3) != 1 or any(x % vec for x in t.stride()[:3])
           or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention: strides {q.stride()}, "
                         f"{k.stride()} are not the kernel's (unit stride "
                         f"along D, others multiples of {vec}, 16-byte "
                         f"aligned)")
    # (B,S,H,D) memory, handed back as its (B,H,S,D) view
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    fn, err = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, h, k.shape[1], s, d,
                d ** -0.5 if scale is None else scale, int(causal),
                _strides(q), _strides(k), _strides(out), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc} ({err(rc).decode()})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[ROUTES[q.dtype]] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Attention of q over k and v: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors, an error for anything else (a CUDA
    tensor that requires grad under grad mode included). Any S >= 1 (the
    kernel masks a ragged last tile)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type == "meta":
        b, h, s, d = q.shape
        pairs = s * (s + 1) // 2 if causal else s * s
        return meta_call("flash_attention", (q, k, v),
                         [(q.shape, q.dtype)], 4.0 * b * h * d * pairs)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    return _launch(q, k, v, causal, scale)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
