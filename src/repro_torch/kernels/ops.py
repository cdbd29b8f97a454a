"""Dispatch of the model layer's recurrent scans (``repro.kernels.ops``).

The JAX package routes a prefill (S > 1, S a multiple of the chunk) to
its Pallas kernel on a TPU and keeps the literal scan for a decode step.
The port does the same, with the device deciding: on that branch a CUDA
tensor launches the hand-written kernel and a CPU tensor runs the
kernel's plain version; every other call takes the literal scan of
``repro_torch.nn``. There is no switch to turn the kernels off, and no
fallback from a kernel to anything else.

Both take the model's (B,S,H,·) layout and hand the kernels transposed
views of it, which they read as they are.
"""
from __future__ import annotations

from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.wkv6 import wkv6


def wkv6_apply(r, k, v, lw, u, state, *, chunk: int = 64):
    """RWKV6 time-mix scan: r/k/v/lw (B,S,H,D), u (H,D), state (B,H,D,D)
    float32 -> (y (B,S,H,D), final state)."""
    s = r.shape[1]
    if s % chunk == 0 and s > 1:
        tr = lambda t: t.transpose(1, 2)
        y, new_state = wkv6(tr(r), tr(k), tr(v), tr(lw), u, state,
                            chunk=chunk)
        return tr(y), new_state
    from repro_torch.nn import rwkv6 as _nn  # lazy: nn imports this module
    return _nn.wkv6_scan(r, k, v, lw, u, state)


def ssd_apply(x, dt, a, b, c, state, *, chunk: int = 128):
    """Mamba2 SSD scan: x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,N),
    state (B,H,P,N) float32 -> (y (B,S,H,P), final state)."""
    s = x.shape[1]
    if s % chunk == 0 and s > 1:
        y, new_state = ssd(x.transpose(1, 2), dt.transpose(1, 2), a, b, c,
                           state, chunk=chunk)
        return y.transpose(1, 2), new_state
    from repro_torch.nn import mamba2 as _nn  # lazy: nn imports this module
    return _nn.ssd_scan(x, dt, a, b, c, state)
