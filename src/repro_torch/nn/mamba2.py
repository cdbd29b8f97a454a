"""Mamba-2 blocks (``repro.nn.mamba2``), the state-space duality (SSD)
layers of zamba2-7b.

Recurrence per head (head dim P, state dim N)::

    h_t = exp(a * dt_t) h_{t-1} + dt_t * x_t B_t^T        h: (P, N)
    y_t = h_t C_t + D x_t

Two implementations of the scan, on the model's (B,S,H,P) layout:

  * :func:`ssd_scan`: the literal recurrence, the decode step;
  * :func:`ssd_chunked`: the chunked float32 form, the kernel's plain
    version (:func:`repro_torch.kernels.ssd.ssd_plain`) transposed.

The block reaches them through :func:`repro_torch.kernels.ops.ssd_apply`,
which sends a prefill to the kernel (CUDA) or its plain version (CPU) and
a decode step to the scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import ssd_apply
from repro_torch.kernels.ssd import ssd_plain
from repro_torch.nn.basic import lecun_normal, normal_init, rmsnorm_init


def ssd_scan(x, dt, a, b, c, state):
    """x: (B,S,H,P); dt: (B,S,H); a: (H,); b/c: (B,S,N) (one group);
    state: (B,H,P,N). Returns (y (B,S,H,P), final state)."""
    ys = []
    for t in range(x.shape[1]):
        dt_t = dt[:, t]                                          # (B,H)
        da = torch.exp(dt_t * a)
        dx = (dt_t[..., None] * x[:, t])[..., None]              # (B,H,P,1)
        state = da[..., None, None] * state + dx * b[:, t, None, None, :]
        ys.append((state @ c[:, t, None, :, None]).squeeze(-1))
    return torch.stack(ys, dim=1), state


def ssd_chunked(x, dt, a, b, c, state, *, chunk: int = 128):
    """Chunked form in float32, equal to :func:`ssd_scan` up to rounding.
    S % chunk == 0."""
    y, final = ssd_plain(x.transpose(1, 2), dt.transpose(1, 2), a, b, c,
                         state, chunk=chunk)
    return y.transpose(1, 2), final


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def mamba2_block_init(generator, *, d_model: int, d_state: int = 64,
                      head_dim: int = 64, expand: int = 2,
                      conv_kernel: int = 4, dtype=torch.float32):
    """The JAX package's tree: drawn in float32 on the generator's device,
    each leaf cast to ``dtype`` as it is made."""
    dev = generator.device
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * d_state
    d_in_proj = 2 * d_inner + 2 * d_state + n_heads
    return {
        "in_proj": {"w": lecun_normal(generator, (d_model, d_in_proj),
                                      dtype=dtype)},
        "conv": {"w": normal_init(generator, (conv_kernel, conv_ch),
                                  std=0.1, dtype=dtype),
                 "b": torch.zeros((conv_ch,), dtype=dtype, device=dev)},
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=dev)).to(dtype),
        "d_skip": torch.ones((n_heads,), dtype=dtype, device=dev),
        # softplus^-1 of U(1e-3, 1e-1) midpoints
        "dt_bias": torch.log(torch.expm1(
            torch.linspace(1e-3, 1e-1, n_heads, device=dev))).to(dtype),
        "norm": rmsnorm_init(d_inner, device=dev, dtype=dtype),
        "out_proj": {"w": lecun_normal(generator, (d_inner, d_model),
                                       dtype=dtype)},
    }


def _causal_conv(w, bias, x, x_prev):
    """Depthwise causal convolution. x: (B,S,C); x_prev: (B,K-1,C), the
    left context; w: (K,C). The taps are summed in float32 (as XLA's
    convolution accumulates) and the result cast to x's type."""
    k = w.shape[0]
    s = x.shape[1]
    xp = torch.cat([x_prev.to(x.dtype), x], dim=1)
    wf = w.to(x.dtype).float()
    y = sum(xp[:, j:j + s].float() * wf[j] for j in range(k))
    return y.to(x.dtype) + bias.to(x.dtype), xp[:, -(k - 1):]


def mamba2_block_apply(p, x, state, *, d_state: int = 64, head_dim: int = 64,
                       expand: int = 2, chunk: int = 128):
    """x: (B,S,D); state {"ssm": (B,H,P,N) float32, "conv": (B,K-1,C)};
    parameters in x's type. Returns (y, new state)."""
    bsz, s, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim

    zxbcdt = x @ p["in_proj"]["w"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * d_state]
    dt_raw = zxbcdt[..., -n_heads:]

    xbc, conv_state = _causal_conv(p["conv"]["w"], p["conv"]["b"], xbc,
                                   state["conv"])
    xbc = F.silu(xbc)
    xh = xbc[..., :d_inner].reshape(bsz, s, n_heads, head_dim)
    b = xbc[..., d_inner:d_inner + d_state]
    c = xbc[..., d_inner + d_state:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    x32 = xh.float()
    y, ssm = ssd_apply(x32, dt, a.float(), b.float(), c.float(),
                       state["ssm"], chunk=chunk)
    y = y + p["d_skip"][:, None] * x32
    y = y.reshape(bsz, s, d_inner).to(x.dtype)

    # gated RMSNorm, then the out-projection
    y = y * F.silu(z)
    var = y.float().square().mean(-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6) * p["norm"]["scale"]).to(x.dtype)
    return y @ p["out_proj"]["w"], {"ssm": ssm, "conv": conv_state}
