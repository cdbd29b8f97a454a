"""The port's multi-head latent attention (``repro_torch.nn.attention``'s
``mla_*``) against the JAX package's, on the CPU.

Parameters are drawn by the JAX package and carried across with
``repro_torch.convert``; inputs come from numpy with a seed. Held at
rtol = atol = 1e-5 (float32 sums in other orders): the full-sequence form
(MLA folded into standard attention, the rope key shared by the heads,
qk and v head sizes unequal), and the cache form, a prefill into an empty
cache and decode tokens after it, in the absorbed form over the
compressed cache, outputs and both cache leaves. Decoding token by token
equals the full pass, as the JAX package's ``tests/test_nn.py`` holds its
own (atol 1e-4 there; 1e-5 here). The cache form in bf16, as served, at
rtol = atol = 2e-2 (bf16 keeps 8 bits).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jax_attention
from repro_torch.convert import from_jax_params
from repro_torch.nn import attention
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
DIMS = dict(num_heads=4, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4,
            v_dim=6)
DM, B, MAX_LEN = 32, 2, 12


def _params(seed=0):
    """JAX's MLA tree, its unit latent-norm scale replaced by random
    values so that it is exercised."""
    jp = jax.tree.map(np.asarray, jax_attention.mla_init(
        jax.random.PRNGKey(seed), d_model=DM, **DIMS))
    jp["kv_norm"]["scale"] = (1 + 0.5 * np.random.default_rng(seed)
                              .standard_normal(DIMS["kv_lora_rank"])
                              ).astype(np.float32)
    return jp, from_jax_params(jp)


def _inputs(s, start=0, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, s, DM)).astype(
        np.float32)
    pos = np.broadcast_to(start + np.arange(s), (B, s)).astype(np.int32)
    return x, pos


def _jax_mla(theta):
    return jax.jit(functools.partial(jax_attention.mla_apply,
                                     rope_theta=theta, **DIMS))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_init_tree_matches_jax():
    jp = jax_attention.mla_init(jax.random.PRNGKey(0), d_model=DM, **DIMS)
    tp = attention.mla_init(torch.Generator().manual_seed(0), d_model=DM,
                            **DIMS)
    assert sorted(tp) == sorted(jp)
    for name, sub in jp.items():
        assert sorted(tp[name]) == sorted(sub)
        for leaf, w in sub.items():
            assert tuple(tp[name][leaf].shape) == w.shape, (name, leaf)
            assert tp[name][leaf].dtype == torch.float32
    assert torch.equal(tp["kv_norm"]["scale"],
                       torch.ones(DIMS["kv_lora_rank"]))
    jc = jax_attention.mla_init_cache(B, MAX_LEN, 16, 4)
    tc = attention.mla_init_cache(B, MAX_LEN, 16, 4)
    for key in ("c_kv", "k_rope"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].dtype == torch.bfloat16 and not tc[key].any()


@pytest.mark.parametrize("s", [1, 7, 16])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_mla_full_sequence_matches_jax(s, theta):
    jp, tp = _params()
    x, pos = _inputs(s)
    jy, jnone = _jax_mla(theta)(jp, jnp.asarray(x), jnp.asarray(pos))
    ty, tnone = attention.mla_apply(tp, torch.from_numpy(x),
                                    torch.from_numpy(pos).long(),
                                    rope_theta=theta, **DIMS)
    assert jnone is None and tnone is None
    assert ty.shape == (B, s, DM)
    _close(ty, jy)


@pytest.mark.parametrize("prompt", [1, 6])
def test_mla_cache_form_matches_jax(prompt):
    """A prefill of ``prompt`` tokens into an empty cache, then two decode
    tokens, in the absorbed form on both sides: the outputs, the latent
    and the rope key of the cache; the slots past the fill level stay
    zero."""
    jp, tp = _params(seed=2)
    jcache = jax_attention.mla_init_cache(B, MAX_LEN, 16, 4,
                                          dtype=jnp.float32)
    tcache = attention.mla_init_cache(B, MAX_LEN, 16, 4,
                                      dtype=torch.float32)
    jmla = _jax_mla(1e4)
    start = 0
    for k, s in enumerate((prompt, 1, 1)):
        x, pos = _inputs(s, start, seed=3 + k)
        jy, jcache = jmla(jp, jnp.asarray(x), jnp.asarray(pos),
                          cache=jcache, cache_index=start)
        ty, tcache = attention.mla_apply(
            tp, torch.from_numpy(x), torch.from_numpy(pos).long(),
            cache=tcache, cache_index=start, **DIMS)
        _close(ty, jy)
        for key in ("c_kv", "k_rope"):
            _close(tcache[key], jcache[key])
        start += s
    assert not tcache["c_kv"][:, start:].any()


def test_mla_decode_token_by_token_equals_full_pass():
    """Six tokens decoded one by one through the compressed cache give the
    full pass's outputs (the absorbed form is the folded one)."""
    _, tp = _params(seed=4)
    x, pos = _inputs(6, seed=5)
    x, pos = torch.from_numpy(x), torch.from_numpy(pos).long()
    full, _ = attention.mla_apply(tp, x, pos, **DIMS)
    cache = attention.mla_init_cache(B, 8, 16, 4, dtype=torch.float32)
    outs = []
    for t in range(6):
        o, cache = attention.mla_apply(tp, x[:, t:t + 1], pos[:, t:t + 1],
                                       cache=cache, cache_index=t, **DIMS)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), full, **TOL)


def test_mla_bf16_cache_form_matches_jax():
    """As served: bf16 weights, activations and cache; the logits of the
    absorbed form in float32 on both sides (JAX's
    ``preferred_element_type``), the probabilities rounded to bf16. A
    6-token prefill and one decode token at 2e-2."""
    jp, _ = _params(seed=6)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(torch.bfloat16), jp)
    jcache = jax_attention.mla_init_cache(B, MAX_LEN, 16, 4)
    tcache = attention.mla_init_cache(B, MAX_LEN, 16, 4)
    jmla = _jax_mla(1e4)
    start = 0
    for k, s in enumerate((6, 1)):
        x, pos = _inputs(s, start, seed=7 + k)
        jy, jcache = jmla(jp, jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.asarray(pos), cache=jcache, cache_index=start)
        ty, tcache = attention.mla_apply(
            tp, torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(pos).long(), cache=tcache, cache_index=start,
            **DIMS)
        assert ty.dtype == torch.bfloat16
        np.testing.assert_allclose(ty.float().numpy(),
                                   np.asarray(jy.astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2)
        start += s
