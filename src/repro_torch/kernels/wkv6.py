"""RWKV6 WKV recurrence: ``y`` and the final state (``repro.kernels.wkv6``).

Layout is the TPU kernel's: r, k, v, lw (B,H,S,D), bonus u (H,D), initial
state (B,H,D,D), all float32 -> y (B,H,S,D), final state (B,H,D,D). Per
head, with w_t = exp(lw_t) and lw <= 0::

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

:func:`wkv6` is the wrapper every caller uses. A tensor on the CPU goes
to :func:`wkv6_plain`; a CUDA tensor goes to the hand-written kernel in
``csrc/wkv6.cu`` or raises: there is no fallback. ``wkv6.launches``
counts kernel launches (the plain version does not count).

:func:`wkv6_plain` is the chunked float32 form of the JAX package's
``repro.nn.rwkv6.wkv6_chunked`` in this layout: per chunk, the
intra-chunk term masked strictly below the diagonal (the mask is applied
to the exponent, before ``exp``: above the diagonal the exponents are
positive and overflow), the bonus ``u`` on the diagonal, and the state
carried to the next chunk. Its decay exponents are segment sums of lw
summed directly (a masked cumsum for the intra-chunk tile, a reversed
one for the decay to the chunk's end), where the JAX package takes
differences of prefix sums: at chunk 64 and decays down to -e^3 those
differences cancel to errors of 1e-4 and more in the exponent, which
the literal recurrence does not have.

The kernel computes the same chunked form in tiles of 32 tokens,
whatever ``chunk`` is, cut into sub-tiles of 8: its products on the
tensor cores in three TF32 passes, which keep float32 accuracy; every
decay an exponential of a one-signed sum of lw, or a product of such
factors, none above 1 (see its source). The two
agree to rtol = atol = 2e-4 in float32 (``chip_smoke.py`` holds them to
it on the card): sums over D and over the chunk are taken in another
order, and one form's ``exp(a) exp(b)`` is the other's ``exp(a + b)``.

r, k, v and lw may be strided views (the model hands over its (B,S,H,D)
tensors transposed); the kernel takes them as they are when their last
axis is contiguous and their other strides are multiples of 4 elements
(16-byte loads), and raises otherwise.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import meta_call, refuse_grad

DIMS = (32, 64)   # the head sizes the kernel is built for


def wkv6_plain(r, k, v, lw, u, state, *, chunk: int = 64):
    """The plain PyTorch version: the reference the kernel is held to, and
    the CPU path. S must be a multiple of ``min(chunk, S)``."""
    b, h, s, d = r.shape
    chunk = min(chunk, s)
    dev = r.device
    # strictly lower: position s < t carries to t; the diagonal is u's
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril(-1)
    tril2 = tril.tril(-2)[..., None]
    tril = tril[..., None]
    eye = torch.eye(chunk, dtype=torch.float32, device=dev)
    st = state.float()
    ys = []
    for i in range(s // chunk):
        part = slice(i * chunk, (i + 1) * chunk)
        rc, kc, vc, lwc = (t[:, :, part].float() for t in (r, k, v, lw))
        cl_cum = lwc.cumsum(-2)                        # sum over s <= t
        cl_prev = F.pad(cl_cum[..., :-1, :], (0, 0, 1, 0))    # s < t
        cl_after = F.pad(lwc.flip(-2).cumsum(-2).flip(-2)[..., 1:, :],
                         (0, 0, 0, 1))                 # sum over s > t
        r_in = rc * torch.exp(cl_prev)                 # attends to S_0
        k_out = kc * torch.exp(cl_after)               # carried to S_end
        # A[t,s] = sum_i r[t,i] k[s,i] exp(sum_{s<j<t} lw[j,i]), s < t; the
        # segment sums are summed directly, not as differences of prefix
        # sums, which cancel to a few ulp of the prefix (1e-4 at chunk 64)
        shifted = F.pad(lwc[..., :-1, :], (0, 0, 1, 0))       # lw[t-1]
        expo = torch.where(tril2, shifted[:, :, :, None, :], 0.0).cumsum(2)
        decay = torch.exp(torch.where(tril, expo, float("-inf")))
        a = torch.einsum("bhtsd,bhtd->bhts", decay * kc[:, :, None], rc)
        diag = (rc * u.float()[None, :, None, :] * kc).sum(-1)
        a = a + eye * diag[..., :, None]
        ys.append(r_in @ st + a @ vc)
        st = (torch.exp(cl_cum[..., -1, :])[..., :, None] * st
              + k_out.transpose(-1, -2) @ vc)
    return torch.cat(ys, dim=2), st


def _check(r, k, v, lw, u, state, chunk):
    tensors = (r, k, v, lw, u, state)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"wkv6 takes float32 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != r.device for t in tensors):
        raise ValueError(f"wkv6: tensors on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, lw)):
        raise ValueError(f"wkv6: r, k, v, lw must share one (B,H,S,D) "
                         f"shape, got {[tuple(t.shape) for t in tensors[:4]]}")
    b, h, s, d = r.shape
    if tuple(u.shape) != (h, d) or tuple(state.shape) != (b, h, d, d):
        raise ValueError(f"wkv6: u must be {(h, d)} and the state "
                         f"{(b, h, d, d)}, got {tuple(u.shape)} and "
                         f"{tuple(state.shape)}")
    if s == 0 or s % min(chunk, s):
        raise ValueError(f"wkv6: S={s} is not a positive multiple of the "
                         f"chunk {chunk}")


@functools.cache
def _kernel():
    from repro_torch.kernels import build
    lib = build.load("wkv6")
    fn = lib.wkv6_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.wkv6_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(r, k, v, lw, u, state):
    b, h, s, d = r.shape
    if d not in DIMS:
        raise ValueError(f"wkv6: no kernel for head size D={d} (built for "
                         f"{DIMS})")
    if any(t.stride() != r.stride() for t in (k, v, lw)):
        raise ValueError("wkv6: r, k, v and lw must share one layout")
    if (r.stride(3) != 1 or any(x % 4 for x in r.stride()[:3])
            or any(t.data_ptr() % 16 for t in (r, k, v, lw))):
        raise ValueError(f"wkv6: strides {r.stride()} are not the kernel's "
                         f"(unit stride along D, others multiples of 4, "
                         f"16-byte aligned)")
    u, state = u.contiguous(), state.contiguous()
    y = torch.empty((b, h, s, d), dtype=torch.float32, device=r.device)
    sout = torch.empty((b, h, d, d), dtype=torch.float32, device=r.device)
    fn, err = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                u.data_ptr(), state.data_ptr(), y.data_ptr(),
                sout.data_ptr(), b, h, s, d, r.stride(0), r.stride(1),
                r.stride(2), stream)
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    wkv6.launches += 1
    return y, sout


def wkv6(r, k, v, lw, u, state, *, chunk: int = 64):
    """(y, final state): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors, an error for anything else (a CUDA tensor
    that requires grad under grad mode included). ``chunk`` is the
    TPU kernel's (and the plain version's) block length along S; S must
    be a multiple of it, on every device, as on the TPU."""
    _check(r, k, v, lw, u, state, chunk)
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, lw, u, state, chunk=chunk)
    if r.device.type == "meta":
        b, h, s, d = r.shape
        c = min(chunk, s)
        return tuple(meta_call(
            "wkv6", (r, k, v, lw, u, state),
            [(r.shape, r.dtype), (state.shape, state.dtype)],
            float(b * h * s * (4 * d * d + 2 * c * d))))
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for device {r.device}")
    refuse_grad("wkv6", r, k, v, lw, u, state)
    return _launch(r, k, v, lw, u, state)


wkv6.launches = 0
