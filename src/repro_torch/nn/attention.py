"""Attention blocks (``repro.nn.attention``): GQA and DeepSeek's
multi-head latent attention (MLA), each in both modes.

Without a KV cache (the stateless full-sequence forward) the queries
attend over the sequence's own keys through ``attn_fn`` (the model passes
:func:`repro_torch.kernels.ops.attention`, the flash kernel) or, when
none is given, through the plain :func:`sdpa`. The JAX package's
``sdpa_chunked``/``sdpa_auto`` have no counterpart: the model never
reaches them, since its attention always takes the kernel. With a
cache the S new tokens' k and v are written into it at ``cache_index``;
a prefill into an empty cache (``cache_index`` 0, S > 1) attends over
those new keys through ``attn_fn``, which is the same function as
attending over the whole cache (the unwritten slots lie past every
query's position and weigh exactly 0), and every other step (a decode)
attends over the whole cache through the plain :func:`sdpa`, as the JAX
package's cache form does.

MLA computes, as the JAX package does, outside any kernel. Its
full-sequence form folds the latent attention into standard attention
(q and k of head size nope + rope, the rope key shared by the heads, v of
its own head size) through the plain :func:`sdpa`; the flash kernel's
wrapper returns its output in q's head size and is not used. With a
cache, every step (the prefill too, as in the JAX package) writes the
compressed latent and the rope key and attends over the whole cache in
the absorbed form, ``w_ukv`` folded into the query and the output.

Caches are plain dicts of tensors: GQA's k and v of shape (B, max_len,
H_kv, D), MLA's compressed ``c_kv`` (B, max_len, kv_lora) and ``k_rope``
(B, max_len, rope).

Inside a model-parallel context (:func:`repro_torch.models.sharding.
model_parallel`) GQA's stateless form runs on this rank's parts of a
member sharded by the rules: ``wq``/``wk``/``wv`` column-parallel,
``wo`` row-parallel, its partial sums reduced over the group. The rules
shard columns, not heads, so where a rank's columns are not whole heads,
or its kv heads are not those its q heads read, the projections are
gathered and every rank computes every head (the output then takes this
rank's rows of ``wo``).

MLA's full-sequence form shards the same way: ``wq`` and ``w_ukv`` on
their columns, which are whole heads when the heads divide over the
group, ``w_dkv`` on the latent (a rank's partial latent is gathered
before ``kv_norm``, since ``w_ukv``'s rows need the whole latent) and
``wo`` row-parallel. The rope key comes from the whole ``w_kr`` and is
broadcast over the rank's heads. The latent and the rope key enter the
region through ``copy_to_region``, so ``kv_norm`` and ``w_kr``, whole
leaves, get their whole gradients. Where the heads do not divide, the
query and the up-projection are gathered and every rank computes every
head.

With a cache over a model axis the cache holds this rank's part, as
:func:`repro_torch.models.sharding.decode_state_dim` lays it out. GQA's
cache holds the rank's kv heads where the forward computes its own heads,
and is written and read as on one rank. Otherwise (every rank computes
every head), and for MLA's latent and rope key, which have no head
dimension, rank r holds cache positions ``[r L, (r + 1) L)``: a write
lands on the rank that owns its position, and attention over the cache
takes each rank's partial softmax (row maximum, sum and weighted values
over its positions), combined over the group by log-sum-exp in one
collective (:func:`repro_torch.core.distributed.combine_softmax_parts`,
the flash-decoding layout). A GQA prefill into an empty cache still
attends over the new keys through ``attn_fn``, which every rank holds
whole. MLA's absorbed form reads ``w_ukv`` whole there, gathered from the
ranks' columns.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import (combine_softmax_parts,
                                          copy_to_region, gather_from_region,
                                          reduce_from_region)
from repro_torch.models.sharding import active, constrain
from repro_torch.nn.basic import lecun_normal, rmsnorm_apply, rmsnorm_init
from repro_torch.nn.rotary import apply_rope

BIG_NEG = -2.0e38  # mask value in the float32 softmax


def sdpa(q, k, v, q_positions, kv_positions, *, causal: bool = True,
         scale: float):
    """q: (B,Sq,H,D), k/v: (B,Skv,Hkv,D) with H % Hkv == 0. The logits and
    the softmax in float32, the weighted sum in v's type. Returns
    (B,Sq,H*D)."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, sq, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    if causal:
        mask = (q_positions[:, None, None, :, None]
                >= kv_positions[:, None, None, None, :])
        logits = torch.where(mask, logits, BIG_NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h * v.shape[-1])


def _softmax_part(q, k, v, q_positions, kv_positions, *, scale: float):
    """:func:`sdpa`'s causal attention over some of the keys, unnormalised:
    per (B, Hkv, G, Sq) the row maximum, the sum of ``exp(logit - max)``,
    and the exp-weighted values (B, Hkv, G, Sq, D), all float32."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, sq, hkv, h // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    mask = (q_positions[:, None, None, :, None]
            >= kv_positions[:, None, None, None, :])
    logits = torch.where(mask, logits, BIG_NEG)
    top = logits.amax(-1)
    w = torch.exp(logits - top[..., None])
    return top, w.sum(-1), torch.einsum("bhgqk,bkhd->bhgqd", w, v.float())


def _write_cache(cache, new: dict, cache_index, length_lo: int = 0):
    """Write the S new tokens' entries (``new[name]`` (B, S, ...)) into the
    cache at positions ``[cache_index, cache_index + S)``; a cache holding
    positions from ``length_lo`` on (a rank's part of the sequence) takes
    only the positions it holds."""
    ci = int(cache_index)
    for name, t in new.items():
        held = cache[name].shape[1]
        lo, hi = max(ci, length_lo), min(ci + t.shape[1], length_lo + held)
        if lo < hi:
            cache[name][:, lo - length_lo:hi - length_lo] = (
                t[:, lo - ci:hi - ci].to(cache[name].dtype))


def _cache_attention(q, k, v, positions, cache, cache_index, attn_fn,
                     scale, seq_shard=None):
    """GQA with a cache: the new k and v written, then attention. A
    prefill into an empty cache attends over the new keys through
    ``attn_fn``; any other step over the cache, this rank's positions of
    it with ``seq_shard`` (combined over its group). Returns (B,S,H*D)."""
    b, s = q.shape[:2]
    held = cache["k"].shape[1]
    lo = 0 if seq_shard is None else seq_shard.coord * held
    _write_cache(cache, {"k": k, "v": v}, cache_index, lo)
    if attn_fn is not None and s > 1 and int(cache_index) == 0:
        # the prefill: the cache holds these keys and nothing else yet
        return attn_fn(q, k, v, positions, positions, causal=True,
                       scale=scale)
    kv_positions = (lo + torch.arange(held, device=q.device)).expand(b, held)
    ck, cv = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    if seq_shard is None:
        return sdpa(q, ck, cv, positions, kv_positions, causal=True,
                    scale=scale)
    out = combine_softmax_parts(*_softmax_part(
        q, ck, cv, positions, kv_positions, scale=scale), seq_shard)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, -1).to(v.dtype)


def gqa_init(generator, *, d_model: int, num_heads: int, num_kv_heads: int,
             head_dim: int, qkv_bias: bool = False, qk_norm: bool = False,
             dtype=torch.float32):
    """The JAX package's tree: q/k/v/o projections, zero q/k/v biases with
    ``qkv_bias``, unit RMS-norm scales over the head with ``qk_norm``."""
    dev = generator.device
    w = lambda shape: {"w": lecun_normal(generator, shape, dtype=dtype)}
    p = {"wq": w((d_model, num_heads * head_dim)),
         "wk": w((d_model, num_kv_heads * head_dim)),
         "wv": w((d_model, num_kv_heads * head_dim)),
         "wo": w((num_heads * head_dim, d_model))}
    if qkv_bias:
        for name, heads in (("wq", num_heads), ("wk", num_kv_heads),
                            ("wv", num_kv_heads)):
            p[name]["b"] = torch.zeros((heads * head_dim,), dtype=dtype,
                                       device=dev)
    if qk_norm:
        p["q_norm"] = rmsnorm_init(head_dim, device=dev, dtype=dtype)
        p["k_norm"] = rmsnorm_init(head_dim, device=dev, dtype=dtype)
    return p


def gqa_apply(p, x, positions, *, num_heads: int, num_kv_heads: int,
              head_dim: int, rope_theta: float = 10000.0, cache=None,
              cache_index=None, attn_fn=None):
    """x: (B,S,Dm); positions (B,S). The projections, then (as in the JAX
    package) the bias, the q/k norms and RoPE. Without ``cache`` returns
    (out, None). With one, the new k and v are written into it in place
    (the cache is the decode state the caller threads through) and
    (out, cache) is returned."""
    b, s, _ = x.shape
    shard = active()
    if shard is not None:
        return _gqa_sharded(p, x, positions, shard, num_heads=num_heads,
                            num_kv_heads=num_kv_heads, head_dim=head_dim,
                            rope_theta=rope_theta, attn_fn=attn_fn,
                            cache=cache, cache_index=cache_index), cache

    def proj(name, heads):
        y = x @ p[name]["w"]
        if "b" in p[name]:
            y = y + p[name]["b"].to(y.dtype)
        return y.reshape(b, s, heads, head_dim)

    q = proj("wq", num_heads)
    k = proj("wk", num_kv_heads)
    v = proj("wv", num_kv_heads)
    if "q_norm" in p:
        q = rmsnorm_apply(p["q_norm"], q)
        k = rmsnorm_apply(p["k_norm"], k)
    q = apply_rope(q, positions, theta=rope_theta)
    k = apply_rope(k, positions, theta=rope_theta)
    scale = head_dim ** -0.5

    if cache is None:
        out = (attn_fn or sdpa)(q, k, v, positions, positions, causal=True,
                                scale=scale)
        return out @ p["wo"]["w"], None

    out = _cache_attention(q, k, v, positions, cache, cache_index, attn_fn,
                           scale)
    return out @ p["wo"]["w"], cache


def _gqa_sharded(p, x, positions, shard, *, num_heads, num_kv_heads,
                 head_dim, rope_theta, attn_fn, cache=None,
                 cache_index=None):
    """The GQA forward on this rank's parts, with or without this rank's
    part of a cache (see the module's docstring). x (B,S,Dm) is the same
    on every rank of the group, and so is the (B,S,Dm) result."""
    b, s, _ = x.shape
    hd = head_dim
    width = {"wq": num_heads * hd, "wk": num_kv_heads * hd,
             "wv": num_kv_heads * hd}
    part = {n: shard.is_part(p[n]["w"].shape[-1], w)
            for n, w in width.items()}
    o_part = shard.is_part(p["wo"]["w"].shape[0], width["wq"])
    # one copy into the region for every column-parallel projection
    x_in = copy_to_region(x, shard) if any(part.values()) else x

    def proj(name):
        y = (x_in if part[name] else x) @ p[name]["w"]
        if "b" in p[name]:
            bias = p[name]["b"]
            if part[name] and bias.shape[-1] == width[name]:
                bias = constrain(bias, "M")   # a whole bias, sliced
            y = y + bias.to(y.dtype)
        return y

    q, k, v = proj("wq"), proj("wk"), proj("wv")
    m = shard.size
    aligned = (all(part.values()) and o_part and num_heads % m == 0
               and num_kv_heads % m == 0)
    if aligned:
        # each rank's whole q heads and the kv heads they read
        hq, hk = num_heads // m, num_kv_heads // m
        norm = lambda name: {"scale": copy_to_region(p[name]["scale"],
                                                     shard)}
    else:
        # every rank computes every head
        q, k, v = (gather_from_region(t, -1, shard) if part[n] else t
                   for t, n in ((q, "wq"), (k, "wk"), (v, "wv")))
        hq, hk = num_heads, num_kv_heads
        norm = lambda name: p[name]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hk, hd)
    v = v.reshape(b, s, hk, hd)
    if "q_norm" in p:
        q = rmsnorm_apply(norm("q_norm"), q)
        k = rmsnorm_apply(norm("k_norm"), k)
    q = apply_rope(q, positions, theta=rope_theta)
    k = apply_rope(k, positions, theta=rope_theta)
    if cache is None:
        out = (attn_fn or sdpa)(q, k, v, positions, positions, causal=True,
                                scale=hd ** -0.5)
    else:
        # the rank's heads in its cache, or every head over its positions
        out = _cache_attention(q, k, v, positions, cache, cache_index,
                               attn_fn, hd ** -0.5,
                               None if aligned else shard)
    if not o_part:
        return out @ p["wo"]["w"]
    if not aligned:
        out = constrain(out, None, None, "M")   # this rank's rows of wo
    return reduce_from_region(out @ p["wo"]["w"], shard)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(generator, *, d_model: int, num_heads: int, kv_lora_rank: int,
             qk_nope_dim: int = 128, qk_rope_dim: int = 64,
             v_dim: int = 128, dtype=torch.float32):
    """The JAX package's tree: the query projection, the latent's down
    projection and its RMS norm, the shared rope key's projection, the
    latent's up projection to every head's nope key and value, and the
    output projection."""
    w = lambda shape: {"w": lecun_normal(generator, shape, dtype=dtype)}
    return {
        "wq": w((d_model, num_heads * (qk_nope_dim + qk_rope_dim))),
        "w_dkv": w((d_model, kv_lora_rank)),
        "w_kr": w((d_model, qk_rope_dim)),
        "kv_norm": rmsnorm_init(kv_lora_rank, device=generator.device,
                                dtype=dtype),
        "w_ukv": w((kv_lora_rank, num_heads * (qk_nope_dim + v_dim))),
        "wo": w((num_heads * v_dim, d_model)),
    }


def mla_init_cache(batch: int, max_len: int, kv_lora_rank: int,
                   qk_rope_dim: int = 64, *, dtype=torch.bfloat16,
                   device="cpu"):
    return {"c_kv": torch.zeros((batch, max_len, kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_apply(p, x, positions, *, num_heads: int, kv_lora_rank: int,
              qk_nope_dim: int = 128, qk_rope_dim: int = 64,
              v_dim: int = 128, rope_theta: float = 10000.0, cache=None,
              cache_index=None):
    """x: (B,S,Dm); positions (B,S). Without ``cache`` returns (out, None)
    (on a model axis, from this rank's parts: see the module's
    docstring); with one, the new latent and rope key are written into it
    in place and (out, cache) is returned."""
    b, s, _ = x.shape
    qk, kv = qk_nope_dim + qk_rope_dim, qk_nope_dim + v_dim
    shard = active()
    part = lambda leaf, whole: shard is not None and shard.is_part(leaf,
                                                                   whole)
    q_part = part(p["wq"]["w"].shape[-1], num_heads * qk)
    dkv_part = part(p["w_dkv"]["w"].shape[-1], kv_lora_rank)
    ukv_part = part(p["w_ukv"]["w"].shape[-1], num_heads * kv)
    o_part = part(p["wo"]["w"].shape[0], num_heads * v_dim)
    aligned = (q_part and ukv_part and o_part
               and num_heads % shard.size == 0)
    x_in = copy_to_region(x, shard) if q_part or dkv_part else x
    q = (x_in if q_part else x) @ p["wq"]["w"]
    latent = (x_in if dkv_part else x) @ p["w_dkv"]["w"]
    if dkv_part:
        latent = gather_from_region(latent, -1, shard)
    c_kv = rmsnorm_apply(p["kv_norm"], latent)
    k_rope = apply_rope(x @ p["w_kr"]["w"], positions, theta=rope_theta)
    scale = qk ** -0.5

    if cache is None:
        if ukv_part:
            c_kv = copy_to_region(c_kv, shard)  # each rank's columns read it
        ukv = c_kv @ p["w_ukv"]["w"].to(x.dtype)
        h = num_heads
        if aligned:
            # each rank's whole heads, the rope key broadcast over them
            h //= shard.size
            k_rope = copy_to_region(k_rope, shard)
        else:
            # every rank computes every head
            if q_part:
                q = gather_from_region(q, -1, shard)
            if ukv_part:
                ukv = gather_from_region(ukv, -1, shard)
        q = q.reshape(b, s, h, qk)
        q_eff = torch.cat([q[..., :qk_nope_dim], apply_rope(
            q[..., qk_nope_dim:], positions, theta=rope_theta)], dim=-1)
        ukv = ukv.reshape(b, s, h, kv)
        k_eff = torch.cat([ukv[..., :qk_nope_dim], k_rope[:, :, None].expand(
            b, s, h, qk_rope_dim)], dim=-1)
        out = sdpa(q_eff, k_eff, ukv[..., qk_nope_dim:], positions,
                   positions, causal=True, scale=scale)
        if not o_part:
            return out @ p["wo"]["w"], None
        if not aligned:
            out = constrain(out, None, None, "M")   # this rank's rows of wo
        return reduce_from_region(out @ p["wo"]["w"], shard), None

    # every head on every rank: the cache's positions are split, not heads
    if q_part:
        q = gather_from_region(q, -1, shard)
    w_ukv = p["w_ukv"]["w"]
    if ukv_part:
        w_ukv = gather_from_region(w_ukv, -1, shard)
    q = q.reshape(b, s, num_heads, qk)
    q_nope = q[..., :qk_nope_dim]
    q_rope = apply_rope(q[..., qk_nope_dim:], positions, theta=rope_theta)
    held = cache["c_kv"].shape[1]
    seq_shard = shard
    lo = 0 if seq_shard is None else seq_shard.coord * held
    _write_cache(cache, {"c_kv": c_kv, "k_rope": k_rope}, cache_index, lo)
    kv_positions = (lo + torch.arange(held, device=x.device)).expand(b, held)
    # the absorbed form: w_ukv folded into the query and the output, so
    # that attention runs over the compressed latent
    w_ukv = w_ukv.to(x.dtype).reshape(-1, num_heads, qk_nope_dim + v_dim)
    w_k, w_v = w_ukv[..., :qk_nope_dim], w_ukv[..., qk_nope_dim:]
    ckv = cache["c_kv"].to(x.dtype)
    kr = cache["k_rope"].to(x.dtype)
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, w_k)
    logits = (torch.einsum("bqhl,bkl->bhqk", q_abs.float(), ckv.float())
              + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), kr.float())
              ) * scale
    mask = positions[:, None, :, None] >= kv_positions[:, None, None, :]
    logits = torch.where(mask, logits, BIG_NEG)
    if seq_shard is None:
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkl->bqhl", probs, ckv)
    else:
        top = logits.amax(-1)
        w = torch.exp(logits - top[..., None])
        ctx = combine_softmax_parts(
            top, w.sum(-1), torch.einsum("bhqk,bkl->bhql", w, ckv.float()),
            seq_shard).transpose(1, 2).to(x.dtype)
    out = torch.einsum("bqhl,lhd->bqhd", ctx, w_v).reshape(
        b, s, num_heads * v_dim)
    if not o_part:
        return out @ p["wo"]["w"], cache
    out = constrain(out, None, None, "M")           # this rank's rows of wo
    return reduce_from_region(out @ p["wo"]["w"], shard), cache
