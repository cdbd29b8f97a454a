"""Grouped-query attention (``repro.nn.attention``): GQA in both modes.

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
package's cache form does. MLA is not ported (no ported config has it).

Caches are plain dicts of tensors: k and v of shape (B, max_len, H_kv, D).
"""
from __future__ import annotations

import torch

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

    cache["k"][:, cache_index:cache_index + s] = k.to(cache["k"].dtype)
    cache["v"][:, cache_index:cache_index + s] = v.to(cache["v"].dtype)
    if attn_fn is not None and s > 1 and cache_index == 0:
        # the prefill: the cache holds these keys and nothing else yet
        out = attn_fn(q, k, v, positions, positions, causal=True,
                      scale=scale)
        return out @ p["wo"]["w"], cache
    max_len = cache["k"].shape[1]
    kv_positions = torch.arange(max_len, device=x.device).expand(b, max_len)
    out = sdpa(q, cache["k"].to(q.dtype), cache["v"].to(q.dtype), positions,
               kv_positions, causal=True, scale=scale)
    return out @ p["wo"]["w"], cache
