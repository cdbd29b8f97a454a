"""Dispatch of the model layer's hot operations (``repro.kernels.ops``).

The JAX package routes a prefill of the recurrent scans (S > 1, S a
multiple of the chunk) to its Pallas kernel on a TPU and keeps the
literal scan for a decode step. The port does the same, with the device
deciding: on a kernel branch a CUDA tensor launches the hand-written
kernel and a CPU tensor runs the kernel's plain version; every other call
takes the plain code of ``repro_torch.nn``. Full-sequence causal
attention takes the flash kernel: the JAX package sends an S that
its 128-row blocks do not tile to ``sdpa_auto``, but the CUDA kernel
masks a ragged last tile and takes any S. The kernel's route follows the
model's type: a served (bf16) prefill runs both products on the tensor
cores (``bf16_mma``), a float32 model on the CUDA cores (``f32_fma``).
There is no fallback from a kernel to anything else.

The kernels have no backward. A differentiated forward (grad mode on and
any tensor argument requiring grad) never reaches them, on either
device: it takes the JAX package's ``use_kernels=False`` branch, as that
package's training forward does (``uk=False``): attention through
:func:`repro_torch.nn.attention.sdpa`, the scans through ``nn``'s chunked
form when S is a positive multiple of the chunk, else the literal scan.
The wrappers themselves refuse a CUDA tensor that requires grad.

All take the model's (B,S,H,·) layout and hand the kernels transposed
views of it, which they read as they are.
"""
from __future__ import annotations

from repro_torch.kernels import differentiated
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.nn.attention import sdpa


def attention(q, k, v, positions, kv_positions, *, causal=True, scale=None):
    """The ``attn_fn`` of :func:`repro_torch.nn.attention.gqa_apply`:
    attention over the sequence's own keys through the flash kernel (its
    tensor-core route for the served bf16 models), q (B,S,H,D) and k/v
    (B,S,Hkv,D) handed over as (B,H,S,D) views. The
    positions are those of ``sdpa``'s signature; the kernel's causal mask
    is by index, which is the same for a sequence at positions 0..S-1.
    Returns (B,S,H*D), as ``sdpa`` does (the JAX package's
    ``attention_fn`` returns (B,S,H,D) there, which its ``gqa_apply``
    cannot project; no CPU test of the JAX package reaches it)."""
    b, s, h, d = q.shape
    if differentiated(q, k, v):
        return sdpa(q, k, v, positions, kv_positions, causal=causal,
                    scale=d ** -0.5 if scale is None else scale)
    tr = lambda t: t.transpose(1, 2)
    y = flash_attention(tr(q), tr(k), tr(v), causal=causal, scale=scale)
    return tr(y).reshape(b, s, h * d)


def wkv6_apply(r, k, v, lw, u, state, *, chunk: int = 64):
    """RWKV6 time-mix scan: r/k/v/lw (B,S,H,D), u (H,D), state (B,H,D,D)
    float32 -> (y (B,S,H,D), final state)."""
    s = r.shape[1]
    chunked = s % chunk == 0 and s > 1
    if chunked and not differentiated(r, k, v, lw, u, state):
        tr = lambda t: t.transpose(1, 2)
        y, new_state = wkv6(tr(r), tr(k), tr(v), tr(lw), u, state,
                            chunk=chunk)
        return tr(y), new_state
    from repro_torch.nn import rwkv6 as _nn  # lazy: nn imports this module
    if chunked:
        return _nn.wkv6_chunked(r, k, v, lw, u, state, chunk=chunk)
    return _nn.wkv6_scan(r, k, v, lw, u, state)


def ssd_apply(x, dt, a, b, c, state, *, chunk: int = 128):
    """Mamba2 SSD scan: x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,N),
    state (B,H,P,N) float32 -> (y (B,S,H,P), final state)."""
    s = x.shape[1]
    chunked = s % chunk == 0 and s > 1
    if chunked and not differentiated(x, dt, a, b, c, state):
        y, new_state = ssd(x.transpose(1, 2), dt.transpose(1, 2), a, b, c,
                           state, chunk=chunk)
        return y.transpose(1, 2), new_state
    from repro_torch.nn import mamba2 as _nn  # lazy: nn imports this module
    if chunked:
        return _nn.ssd_chunked(x, dt, a, b, c, state, chunk=chunk)
    return _nn.ssd_scan(x, dt, a, b, c, state)
