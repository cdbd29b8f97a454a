"""Grouped-query attention (``repro.nn.attention``), in its cache form.

The JAX package's GQA runs in two modes. With a KV cache (decode, and a
prefill that fills the cache) it attends through the plain :func:`sdpa`;
this module ports that form. Without one (the stateless full-sequence
forward) the JAX package sends it to the flash-attention kernel on a
TPU; that form waits for the port of ``flash_attention`` and
:func:`gqa_apply` refuses it. MLA, q/k/v biases and q/k norms are not
ported (no ported config has them).

Caches are plain dicts of tensors: k and v of shape (B, max_len, H_kv, D).
"""
from __future__ import annotations

import torch

from repro_torch.nn.basic import lecun_normal
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


def gqa_init(generator, *, d_model: int, num_heads: int, num_kv_heads: int,
             head_dim: int, dtype=torch.float32):
    """The JAX package's tree without q/k/v biases or q/k norms (zamba2's
    shared block has neither; those options come with the attention
    configs)."""
    w = lambda shape: {"w": lecun_normal(generator, shape, dtype=dtype)}
    return {"wq": w((d_model, num_heads * head_dim)),
            "wk": w((d_model, num_kv_heads * head_dim)),
            "wv": w((d_model, num_kv_heads * head_dim)),
            "wo": w((num_heads * head_dim, d_model))}


def gqa_apply(p, x, positions, *, num_heads: int, num_kv_heads: int,
              head_dim: int, rope_theta: float = 10000.0, cache=None,
              cache_index=None):
    """x: (B,S,Dm); positions (B,S). The S new tokens' k and v are written
    into ``cache`` at ``cache_index`` (in place: the cache is the decode
    state the caller threads through) and the queries attend over the
    whole cache, unwritten slots masked by causality. Returns (out,
    cache)."""
    if cache is None:
        raise NotImplementedError(
            "gqa_apply without a KV cache is the stateless full-sequence "
            "form, which the JAX package runs through flash_attention on "
            "a TPU: not ported yet (flash_attention)")
    b, s, _ = x.shape
    q = (x @ p["wq"]["w"]).reshape(b, s, num_heads, head_dim)
    k = (x @ p["wk"]["w"]).reshape(b, s, num_kv_heads, head_dim)
    v = (x @ p["wv"]["w"]).reshape(b, s, num_kv_heads, head_dim)
    q = apply_rope(q, positions, theta=rope_theta)
    k = apply_rope(k, positions, theta=rope_theta)

    cache["k"][:, cache_index:cache_index + s] = k.to(cache["k"].dtype)
    cache["v"][:, cache_index:cache_index + s] = v.to(cache["v"].dtype)
    max_len = cache["k"].shape[1]
    kv_positions = torch.arange(max_len, device=x.device).expand(b, max_len)
    out = sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), positions,
               kv_positions, causal=True, scale=head_dim ** -0.5)
    return out @ p["wo"]["w"], cache
