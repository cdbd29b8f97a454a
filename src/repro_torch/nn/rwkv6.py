"""RWKV-6 ("Finch") blocks (``repro.nn.rwkv6``): attention-free, with a
data-dependent decay per channel.

Two implementations of the WKV recurrence, on the model's (B,S,H,D)
layout:

  * :func:`wkv6_scan`: the literal recurrence, the decode step;
  * :func:`wkv6_chunked`: the chunked float32 form, the kernel's plain
    version (:func:`repro_torch.kernels.wkv6.wkv6_plain`) transposed.

The block reaches them through :func:`repro_torch.kernels.ops.wkv6_apply`,
which sends a prefill to the kernel (CUDA) or its plain version (CPU) and
a decode step to the scan.

Recurrence per head (k-dim = v-dim = head_dim)::

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          w_t = exp(-exp(ww_t)) in (0,1)

Inside a model-parallel context (:func:`repro_torch.models.sharding.
model_parallel`) the blocks run on this rank's parts of a member sharded
by the rules. The time mix: ``wr``/``wk``/``wv``/``wg`` column-parallel
by heads, ``wo`` row-parallel; the token shift and its LoRA mixes and the
decay's LoRA stay whole (the rules shard none of them), and what is used
per head (the decay, ``bonus``, ``ln_x``) is sliced at use by
:func:`~repro_torch.models.sharding.constrain`, whose backward gathers
the slices' gradients. Where a rank's columns are not whole heads, r, k,
v and g are gathered and every rank computes every head. The channel mix
follows the rules as placed: ``wk`` and ``wr`` column-parallel, and
``wv`` sharded on its output (the ``"wv"`` rule), so the ``d_ff``
activation is gathered before it and its output after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import (copy_to_region, gather_from_region,
                                          reduce_from_region)
from repro_torch.kernels.ops import wkv6_apply
from repro_torch.kernels.wkv6 import wkv6_plain
from repro_torch.models.sharding import active, constrain
from repro_torch.nn.basic import layernorm_init, lecun_normal, normal_init


def wkv6_scan(r, k, v, lw, u, state):
    """Literal recurrence. r/k/v/lw: (B,S,H,D); u: (H,D); state: (B,H,D,D).
    Returns (y (B,S,H,D), final state). lw = log(w_t) <= 0."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,Dk,Dv)
        ys.append((r[:, t, :, None, :]
                   @ (state + u[..., :, None] * kv)).squeeze(-2))
        state = torch.exp(lw[:, t])[..., :, None] * state + kv
    return torch.stack(ys, dim=1), state


def wkv6_chunked(r, k, v, lw, u, state, *, chunk: int = 64):
    """Chunked form in float32, equal to :func:`wkv6_scan` up to rounding.
    r/k/v/lw: (B,S,H,D) with S % chunk == 0; u: (H,D); state (B,H,D,D)."""
    tr = lambda t: t.transpose(1, 2)
    y, final = wkv6_plain(tr(r), tr(k), tr(v), tr(lw), u, state, chunk=chunk)
    return tr(y), final


# ---------------------------------------------------------------------------
# RWKV6 block (time-mix + channel-mix)
# ---------------------------------------------------------------------------


def rwkv6_block_init(generator, *, d_model: int, d_ff: int,
                     head_dim: int = 64, mix_lora: int = 32,
                     decay_lora: int = 64, dtype=torch.float32):
    """The JAX package's tree: drawn in float32 on the generator's device,
    each leaf cast to ``dtype`` as it is made."""
    dev = generator.device
    h = d_model // head_dim
    full = lambda value, shape: torch.full(shape, value, dtype=dtype,
                                           device=dev)
    lecun = lambda shape: {"w": lecun_normal(generator, shape, dtype=dtype)}
    normal = lambda shape, std: normal_init(generator, shape, std=std,
                                            dtype=dtype)
    tm = {
        "mix_base": full(0.5, (5, d_model)),                  # r,k,v,w,g
        "mix_w1": normal((d_model, 5 * mix_lora), 0.01),
        "mix_w2": normal((5, mix_lora, d_model), 0.01),
        "decay_base": full(-4.0, (d_model,)),
        "decay_w1": normal((d_model, decay_lora), 0.01),
        "decay_w2": normal((decay_lora, d_model), 0.01),
        "bonus": normal((h, head_dim), 0.3),
        "wr": lecun((d_model, d_model)),
        "wk": lecun((d_model, d_model)),
        "wv": lecun((d_model, d_model)),
        "wg": lecun((d_model, d_model)),
        "wo": lecun((d_model, d_model)),
        "ln_x": layernorm_init(d_model, device=dev, dtype=dtype),
    }
    cm = {
        "mix_k": full(0.5, (d_model,)),
        "mix_r": full(0.5, (d_model,)),
        "wk": lecun((d_model, d_ff)),
        "wv": lecun((d_ff, d_model)),
        "wr": lecun((d_model, d_model)),
    }
    return {"time_mix": tm, "channel_mix": cm}


def _group_norm(p, x, n_heads: int, eps: float = 64e-5):
    """Layer norm over each head's channels, in float32. x: (B,S,D)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(b, s, d)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def time_mix_apply(p, x, x_prev, wkv_state, *, head_dim: int = 64,
                   chunk: int = 64):
    """x: (B,S,D); x_prev: (B,1,D), the token before x[:,0]. Parameters
    in x's type. Returns (y, new wkv state, the last token)."""
    b, s, d = x.shape
    h = d // head_dim
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)
    dx = xs - x
    xxx = x + dx * p["mix_base"].mean(0)
    lora = torch.tanh(xxx @ p["mix_w1"]).reshape(b, s, 5, -1)
    deltas = torch.einsum("bsli,lid->bsld", lora, p["mix_w2"])
    mixed = x[:, :, None] + dx[:, :, None] * (p["mix_base"] + deltas)
    shard = active()
    if shard is not None and shard.is_part(p["wr"]["w"].shape[-1], d):
        return _time_mix_sharded(p, x, mixed, wkv_state, shard,
                                 head_dim=head_dim, chunk=chunk)
    xr, xk, xv, xw, xg = mixed.unbind(2)

    r = (xr @ p["wr"]["w"]).reshape(b, s, h, head_dim)
    k = (xk @ p["wk"]["w"]).reshape(b, s, h, head_dim)
    v = (xv @ p["wv"]["w"]).reshape(b, s, h, head_dim)
    g = F.silu(xg @ p["wg"]["w"])

    ww = p["decay_base"].float() + (
        torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]).float()
    lw = -torch.exp(ww).reshape(b, s, h, head_dim)           # log decay <= 0
    y, new_state = wkv6_apply(r.float(), k.float(), v.float(), lw,
                              p["bonus"].float(), wkv_state, chunk=chunk)
    y = y.reshape(b, s, d).to(x.dtype)
    y = _group_norm(p["ln_x"], y, h) * g
    return y @ p["wo"]["w"], new_state, x[:, -1:]


def _time_mix_sharded(p, x, mixed, wkv_state, shard, *, head_dim,
                      chunk):
    """:func:`time_mix_apply` from the token-shift mixes on, on this rank's
    columns of ``wr``/``wk``/``wv``/``wg`` and rows of ``wo``."""
    b, s, d = x.shape
    # the projections' inputs enter the region (their gradients are
    # partial); the decay's input stays whole
    xr, xk, xv, xg = copy_to_region(mixed[:, :, [0, 1, 2, 4]],
                                    shard).unbind(2)
    xw = mixed[:, :, 3]
    r, k, v = (xr @ p["wr"]["w"], xk @ p["wk"]["w"], xv @ p["wv"]["w"])
    g = F.silu(xg @ p["wg"]["w"])
    ww = p["decay_base"].float() + (
        torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]).float()
    lw = -torch.exp(ww)                                 # (B,S,D), whole
    cols = r.shape[-1]
    if cols % head_dim == 0:
        # this rank's whole heads: the per-head leaves sliced at use
        h = cols // head_dim
        lo = shard.bounds(d // head_dim)[0]
        lw = constrain(lw, None, None, "M")
        u = constrain(p["bonus"], "M", None)
        ln_x = {n: constrain(t, "M") for n, t in p["ln_x"].items()}
        # a decode state over the axis holds these heads already
        state = (wkv_state if wkv_state.shape[1] == h
                 else wkv_state[:, lo:lo + h])
    else:
        # a rank's columns cut a head: every rank computes every head
        r, k, v, g = (gather_from_region(t, -1, shard) for t in (r, k, v, g))
        h, u, ln_x, state = d // head_dim, p["bonus"], p["ln_x"], wkv_state
    heads = lambda t: t.reshape(b, s, h, head_dim)
    y, new_state = wkv6_apply(heads(r.float()), heads(k.float()),
                              heads(v.float()), heads(lw), u.float(), state,
                              chunk=chunk)
    y = _group_norm(ln_x, y.reshape(b, s, h * head_dim).to(x.dtype), h) * g
    if h * head_dim == d:
        y = constrain(y, None, None, "M")        # this rank's rows of wo
    return (reduce_from_region(y @ p["wo"]["w"], shard), new_state,
            x[:, -1:])


def channel_mix_apply(p, x, x_prev):
    xs = torch.cat([x_prev, x[:, :-1]], dim=1)
    dx = xs - x
    xk = x + dx * p["mix_k"]
    xr = x + dx * p["mix_r"]
    shard = active()
    if shard is not None:
        return _channel_mix_sharded(p, x, xk, xr, shard)
    k = F.relu(xk @ p["wk"]["w"]).square()
    r = torch.sigmoid(xr @ p["wr"]["w"])
    return r * (k @ p["wv"]["w"]), x[:, -1:]


def _channel_mix_sharded(p, x, xk, xr, shard):
    """The channel mix on the parts the rules give this rank: ``wk``'s
    columns (``d_ff``), then the whole ``d_ff`` activation into ``wv``'s
    columns (``d_model``, the ``"wv"`` rule), beside ``wr``'s columns."""
    d = x.shape[-1]
    d_ff = p["wv"]["w"].shape[0]
    k_part = shard.is_part(p["wk"]["w"].shape[-1], d_ff)
    out_part = shard.is_part(p["wv"]["w"].shape[-1], d)
    if k_part:
        xk = copy_to_region(xk, shard)
    k = F.relu(xk @ p["wk"]["w"]).square()
    if k_part:
        k = gather_from_region(k, -1, shard)
    if not out_part:
        return torch.sigmoid(xr @ p["wr"]["w"]) * (k @ p["wv"]["w"]), \
            x[:, -1:]
    k = copy_to_region(k, shard)
    r = torch.sigmoid(copy_to_region(xr, shard) @ p["wr"]["w"])
    return gather_from_region(r * (k @ p["wv"]["w"]), -1, shard), x[:, -1:]
