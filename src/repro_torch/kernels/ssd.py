"""Mamba2 SSD scan: ``y`` and the final state (``repro.kernels.ssd``).

Layout is the TPU kernel's: x (B,H,S,P), dt (B,H,S), a (H,), b and c
(B,S,N) shared by every head, initial state (B,H,P,N), all float32 ->
y (B,H,S,P), final state (B,H,P,N). Per head::

    h_t = exp(a dt_t) h_{t-1} + dt_t x_t b_t^T,   y_t = h_t c_t

:func:`ssd` is the wrapper every caller uses. A tensor on the CPU goes to
:func:`ssd_plain`; a CUDA tensor goes to the hand-written kernel in
``csrc/ssd.cu`` or raises: there is no fallback. The kernel has no
backward, so a CUDA tensor that requires grad under grad mode raises too
(``kernels.ops`` sends a differentiated forward to ``nn``'s chunked form).
``ssd.launches`` counts kernel launches (the plain version does not
count).

:func:`ssd_plain` is the chunked float32 form of the JAX package's
``repro.nn.mamba2.ssd_chunked`` in this layout: per chunk, the
intra-chunk term with the segment-sum decay masked on and below the
diagonal (the mask is applied to the exponent, before ``exp``: above the
diagonal the exponents are positive and overflow), the incoming state's
term, and the state carried to the next chunk. Its decay exponents are
segment sums of ``dt a`` summed directly (a masked cumsum for the
intra-chunk tile, a reversed one for the decay to the chunk's end),
where the JAX package takes differences of prefix sums: at chunk 256 and
``a`` down to -16 those differences cancel to errors of 1e-4 and more in
the exponent, which the literal recurrence does not have.

The kernel computes the same chunked form on the tensor cores, in tiles
of 32 tokens whatever ``chunk`` is, two heads a block sharing b, c and
C B^T, each product in three TF32 passes (3xTF32), which keeps float32
accuracy; its decay exponents are sums that never cancel either (see its
source). The two agree to rtol = atol = 2e-4 in float32
(``chip_smoke.py`` holds them to it on the card): sums over N and over
the chunk are taken in another order.

x, b and c may be strided views (the model hands over slices of one
projection); the kernel takes them as they are when their last axis is
contiguous and their other strides are multiples of 4 elements (16-byte
loads), and raises otherwise. dt may have any strides.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import meta_call, refuse_grad

HEAD_DIMS = (32, 64)        # P the kernel is built for
STATE_DIMS = (16, 32, 64)   # N the kernel is built for


def ssd_plain(x, dt, a, b, c, state, *, chunk: int = 128):
    """The plain PyTorch version: the reference the kernel is held to, and
    the CPU path. S must be a multiple of ``min(chunk, S)``."""
    bsz, h, s, p = x.shape
    chunk = min(chunk, s)
    # inclusive lower: position s <= t carries to t
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    strict = tril.tril(-1)
    a = a.float()[:, None]
    st = state.float()
    ys = []
    for i in range(s // chunk):
        part = slice(i * chunk, (i + 1) * chunk)
        xc = x[:, :, part].float()                     # (B,H,CL,P)
        dtc = dt[:, :, part].float()                   # (B,H,CL)
        bc, cc = b[:, part].float(), c[:, part].float()   # (B,CL,N)
        lda = dtc * a                                  # <= 0
        ca = lda.cumsum(-1)                            # sum over s <= t
        after = F.pad(lda.flip(-1).cumsum(-1).flip(-1)[..., 1:], (0, 1))
        # M[t,s] = exp(sum_{s<j<=t} lda[j]) (c_t . b_s) dt_s for s <= t; the
        # segment sums are summed directly, not as differences of prefix
        # sums, which cancel to a few ulp of the prefix
        seg = torch.where(strict, lda[..., :, None], 0.0).cumsum(-2)
        decay = torch.exp(torch.where(tril, seg, float("-inf")))
        cb = (cc @ bc.transpose(-1, -2))[:, None]      # (B,1,CLt,CLs)
        y = (cb * decay * dtc[..., None, :]) @ xc
        # the incoming state's term, then the state's advance
        y = y + torch.exp(ca)[..., None] * (cc[:, None] @ st.transpose(-1, -2))
        w_out = torch.exp(after) * dtc                 # (B,H,CL)
        st = (torch.exp(ca[..., -1:])[..., None] * st
              + (xc * w_out[..., None]).transpose(-1, -2) @ bc[:, None])
        ys.append(y)
    return torch.cat(ys, dim=2), st


def _check(x, dt, a, b, c, state, chunk):
    tensors = (x, dt, a, b, c, state)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd takes float32 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"ssd: tensors on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if x.ndim != 4:
        raise ValueError(f"ssd: x must be (B,H,S,P), got {tuple(x.shape)}")
    bsz, h, s, p = x.shape
    n = b.shape[-1] if b.ndim == 3 else -1
    want = {"dt": (bsz, h, s), "a": (h,), "b": (bsz, s, n), "c": (bsz, s, n),
            "state": (bsz, h, p, n)}
    got = {"dt": dt, "a": a, "b": b, "c": c, "state": state}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"ssd: {name} must be {shape} for x "
                             f"{tuple(x.shape)}, got "
                             f"{tuple(got[name].shape)}")
    if s == 0 or s % min(chunk, s):
        raise ValueError(f"ssd: S={s} is not a positive multiple of the "
                         f"chunk {chunk}")


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    lib = build.load("ssd")
    fn = lib.ssd_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.ssd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _vector_ok(t) -> bool:
    """Unit stride along the last axis, the others multiples of 4
    elements, 16-byte aligned: what the kernel's float4 loads take."""
    return (t.stride(-1) == 1 and all(x % 4 == 0 for x in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _launch(x, dt, a, b, c, state):
    bsz, h, s, p = x.shape
    n = b.shape[-1]
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"ssd: no kernel for P={p}, N={n} (built for P in "
                         f"{HEAD_DIMS}, N in {STATE_DIMS})")
    if b.stride() != c.stride():
        raise ValueError("ssd: b and c must share one layout")
    if not all(_vector_ok(t) for t in (x, b, c)):
        raise ValueError(f"ssd: strides x {x.stride()}, b {b.stride()} are "
                         f"not the kernel's (unit stride along the last "
                         f"axis, others multiples of 4, 16-byte aligned)")
    a, state = a.contiguous(), state.contiguous()
    if state.data_ptr() % 16:   # the kernel copies it in 16-byte pieces
        state = state.clone()
    y = torch.empty((bsz, h, s, p), dtype=torch.float32, device=x.device)
    sout = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 8)(*x.stride()[:3], *dt.stride(),
                                      *b.stride()[:2])
    fn, err = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                c.data_ptr(), state.data_ptr(), y.data_ptr(),
                sout.data_ptr(), bsz, h, s, p, n,
                ctypes.cast(strides, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    ssd.launches += 1
    return y, sout


def ssd(x, dt, a, b, c, state, *, chunk: int = 128):
    """(y, final state): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, an error for anything else. ``chunk`` is the
    TPU kernel's (and the plain version's) block length along S; S must
    be a multiple of it, on every device, as on the TPU."""
    _check(x, dt, a, b, c, state, chunk)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, b, c, state, chunk=chunk)
    if x.device.type == "meta":
        bsz, h, s, p = x.shape
        n, cl = state.shape[-1], min(chunk, s)
        return tuple(meta_call(
            "ssd", (x, dt, a, b, c, state),
            [(x.shape, x.dtype), (state.shape, state.dtype)],
            float(bsz * h * s * (4 * p * n + cl * (n + p)))))
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    refuse_grad("ssd", x, dt, a, b, c, state)
    return _launch(x, dt, a, b, c, state)


ssd.launches = 0
