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

Inside a model-parallel context (:func:`repro_torch.models.sharding.
model_parallel`) the block runs on this rank's parts of the leaves the
rules cut. ``in_proj`` is one concatenated projection ``[z | x | B | C |
dt]``, so a rank's columns are not its heads: its column-parallel product
is gathered, and every rank holds the whole ``zxbcdt``. The depthwise
convolution is per channel, so a rank convolves its channels of ``xBC``
(``conv`` cut on them), and the activated channels are gathered. When the
heads divide over the group the SSD runs on the rank's heads (their ``x``
and ``dt``, the whole ``B`` and ``C``), the gated RMSNorm's mean of
squares over all of ``d_inner`` is summed over the group in float32, and
``out_proj``, cut on its rows (whole heads), is row-parallel. Otherwise
every rank computes every head and takes its rows of ``out_proj``. The
whole leaves a rank reads only its heads of (``a_log``, ``dt_bias``,
``d_skip``, ``norm``) enter the region through ``copy_to_region``, so
their gradients are whole. A decode state over the axis holds the rank's
channels of the conv state and, where the heads divide, its heads of the
SSD state (``models.sharding.decode_state_dim``); a whole state (the
stateless forward's fresh one) is sliced to them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import (copy_to_region, gather_from_region,
                                          reduce_from_region)
from repro_torch.kernels.ops import ssd_apply
from repro_torch.models.sharding import active, constrain
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
    parameters in x's type. Returns (y, new state); on a model axis the
    new state holds this rank's heads and channels (where they are
    split)."""
    bsz, s, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * d_state
    shard = active()
    part = lambda leaf, whole: shard is not None and shard.is_part(leaf,
                                                                   whole)
    in_part = part(p["in_proj"]["w"].shape[-1],
                   2 * d_inner + 2 * d_state + n_heads)
    conv_part = part(p["conv"]["w"].shape[-1], conv_ch)
    out_part = part(p["out_proj"]["w"].shape[0], d_inner)
    aligned = out_part and n_heads % shard.size == 0

    if in_part:
        zxbcdt = gather_from_region(
            copy_to_region(x, shard) @ p["in_proj"]["w"], -1, shard)
    else:
        zxbcdt = x @ p["in_proj"]["w"]
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_ch]
    dt_raw = zxbcdt[..., -n_heads:]

    if conv_part:
        # this rank's channels, convolved and activated, then gathered
        lo, hi = shard.bounds(conv_ch)
        bias = p["conv"]["b"]
        if bias.shape[-1] == conv_ch:
            bias = constrain(bias, "M")       # a whole bias, sliced
        conv_prev = state["conv"]      # whole, or the rank's channels
        if conv_prev.shape[-1] == conv_ch:
            conv_prev = conv_prev[..., lo:hi]
        xbc, conv_state = _causal_conv(
            p["conv"]["w"], bias, copy_to_region(xbc, shard)[..., lo:hi],
            conv_prev)
        xbc = gather_from_region(F.silu(xbc), -1, shard)
    else:
        xbc, conv_state = _causal_conv(p["conv"]["w"], p["conv"]["b"], xbc,
                                       state["conv"])
        xbc = F.silu(xbc)

    heads, ssm = slice(0, n_heads), state["ssm"]
    a_log, dt_bias, d_skip, scale = (p["a_log"], p["dt_bias"], p["d_skip"],
                                     p["norm"]["scale"])
    if aligned:
        # this rank's heads; every whole value they read enters the region
        heads = slice(*shard.bounds(n_heads))
        z, dt_raw, xbc, a_log, dt_bias, d_skip, scale = (
            copy_to_region(t, shard) for t in (z, dt_raw, xbc, a_log,
                                                dt_bias, d_skip, scale))
        z = z[..., heads.start * head_dim:heads.stop * head_dim]
        scale = scale[heads.start * head_dim:heads.stop * head_dim]
        dt_raw, a_log, dt_bias, d_skip = (
            t[..., heads] for t in (dt_raw, a_log, dt_bias, d_skip))
        if ssm.shape[1] == n_heads:    # else the rank's heads already
            ssm = ssm[:, heads]
    nh = heads.stop - heads.start
    xh = xbc[..., :d_inner].reshape(bsz, s, n_heads, head_dim)[:, :, heads]
    b = xbc[..., d_inner:d_inner + d_state]
    c = xbc[..., d_inner + d_state:]

    dt = F.softplus(dt_raw.float() + dt_bias)
    a = -torch.exp(a_log)

    x32 = xh.float()
    y, ssm = ssd_apply(x32, dt, a.float(), b.float(), c.float(), ssm,
                       chunk=chunk)
    y = y + d_skip[:, None] * x32
    y = y.reshape(bsz, s, nh * head_dim).to(x.dtype)

    # gated RMSNorm over all of d_inner, then the out-projection
    y = y * F.silu(z)
    if aligned:
        # the ranks' square-sums, summed over the group; each rank's
        # gradient of the sum covers only its own heads, so it is summed
        # over the group as well
        var = copy_to_region(reduce_from_region(
            y.float().square().sum(-1, keepdim=True), shard), shard) / d_inner
    else:
        var = y.float().square().mean(-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)
    new_state = {"ssm": ssm, "conv": conv_state}
    if not out_part:
        return y @ p["out_proj"]["w"], new_state
    if not aligned:
        y = constrain(y, None, None, "M")     # this rank's rows of out_proj
    return reduce_from_region(y @ p["out_proj"]["w"], shard), new_state
