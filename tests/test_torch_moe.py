"""The port's mixture-of-experts layer (``repro_torch.nn.moe``) against the
JAX package's (``repro.nn.moe``), on the CPU.

Parameters are drawn by the JAX package and carried across with
``repro_torch.convert``; inputs come from numpy with a seed. Tolerances:

  * ``moe_apply``'s output and aux loss at float32: rtol = atol = 1e-5
    (sums in other orders), with capacity drops (``capacity_factor`` 0.5)
    and without (8.0), with and without a shared expert, at an S that
    ``group_size`` divides and one it does not;
  * in bf16: rtol = atol = 2e-2 (bf16 keeps 8 bits), with the routing
    equal to JAX's, index for index;
  * the top-k choice among exactly tied router logits: JAX's indices,
    index for index (``jax.lax.top_k`` puts the lower index first);
  * the dispatch and combine tensors from the same gates and indices:
    equal to JAX's, element for element.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as jax_moe
from repro_torch.convert import from_jax_params
from repro_torch.nn import moe
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
D, F, E, K = 16, 24, 8, 2


def _params(num_shared, seed=0):
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), d_model=D, d_expert=F,
                          num_experts=E, num_shared=num_shared)
    return jp, from_jax_params(jp)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_apply(**kw):
    return jax.jit(functools.partial(jax_moe.moe_apply, num_experts=E,
                                     top_k=K, **kw))


def test_moe_init_tree_matches_jax():
    jp = jax_moe.moe_init(jax.random.PRNGKey(0), d_model=D, d_expert=F,
                          num_experts=E, num_shared=2)
    tp = moe.moe_init(torch.Generator().manual_seed(0), d_model=D,
                      d_expert=F, num_experts=E, num_shared=2)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jflat}
    got = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}['{k}']")
            else:
                got[f"{prefix}['{k}']"] = v
    walk(tp)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert got[path].dtype == torch.float32, path
        # lecun_normal over the (E, D, F) leaves' input axis, D or F
        fan_in = w.shape[-2]
        assert abs(float(got[path].std()) * np.sqrt(fan_in) - 0.88) < 0.15


@pytest.mark.parametrize("s,group", [(32, 16), (24, 16)],
                         ids=["groups-divide", "groups-shrink"])
@pytest.mark.parametrize("num_shared", [0, 1])
@pytest.mark.parametrize("cf", [0.5, 8.0], ids=["drops", "no-drops"])
def test_moe_apply_matches_jax(cf, num_shared, s, group):
    """Output and aux loss at float32; with ``cf`` 0.5 some tokens pass an
    expert's capacity and are dropped, with 8.0 none is (checked on the
    port's own dispatch). At S = 24 groups of 16 shrink to 12."""
    jp, tp = _params(num_shared)
    x = _x((2, s, D))
    jout, jaux = _jax_apply(capacity_factor=cf, group_size=group)(
        jp, jnp.asarray(x))
    tout, taux = moe.moe_apply(tp, torch.from_numpy(x), num_experts=E,
                               top_k=K, capacity_factor=cf,
                               group_size=group)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **TOL)
    assert taux.dtype == torch.float32

    gs = 16 if s % 16 == 0 else 12
    xg = torch.from_numpy(x).reshape(2, s // gs, gs, D)
    _, gates, idx = moe._top_k_gating(xg @ tp["router"]["w"], K)
    capacity = max(K, int(np.ceil(gs * K * cf / E)))
    combine, _ = moe._dispatch_combine(gates, idx, E, capacity)
    routed = int((combine > 0).sum())
    assert (routed < idx.numel()) == (cf < 1.0)


def test_moe_bf16_matches_jax():
    """bf16 activations and weights, as served: the router's logits in
    bf16 (ties among them are common), the combine weights rounded to
    bf16 before the combine einsum. The routing equals JAX's index for
    index, the output agrees to 2e-2."""
    jp, _ = _params(1, seed=3)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(torch.bfloat16), jp)
    x = _x((2, 32, D), seed=4)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jout, jaux = _jax_apply(capacity_factor=1.25, group_size=16)(jp, jx)
    tout, taux = moe.moe_apply(tp, tx, num_experts=E, top_k=K,
                               capacity_factor=1.25, group_size=16)
    assert tout.dtype == torch.bfloat16
    jlogits = jnp.asarray(jx).reshape(2, 2, 16, D) @ jp["router"]["w"]
    tlogits = tx.reshape(2, 2, 16, D) @ tp["router"]["w"]
    np.testing.assert_array_equal(tlogits.float().numpy(),
                                  np.asarray(jlogits.astype(jnp.float32)))
    _, _, jidx = jax_moe._top_k_gating(jlogits, K)
    _, _, tidx = moe._top_k_gating(tlogits, K)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **BF16_TOL)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_top_k_gating_breaks_ties_as_jax(k):
    """Router logits with exact ties, at and across the k-th place (a row
    of all equal logits, pairs and runs of equal values, ties in bf16):
    the chosen experts equal JAX's index for index (the lower index
    first), and the probabilities and gates agree."""
    rng = np.random.default_rng(k)
    levels = rng.standard_normal(3).astype(np.float32)
    logits = levels[rng.integers(0, 3, (4, 6, E))]
    logits[0, 0] = 0.5                                 # all tied
    logits[0, 1] = np.arange(E) // 2                   # pairs
    logits[0, 2] = -(np.arange(E) // 3)                # runs, descending
    for dtype in (jnp.float32, jnp.bfloat16):
        jl = jnp.asarray(logits).astype(dtype)
        tl = torch.from_numpy(logits).to(
            torch.float32 if dtype == jnp.float32 else torch.bfloat16)
        jprobs, jgates, jidx = jax_moe._top_k_gating(jl, k)
        tprobs, tgates, tidx = moe._top_k_gating(tl, k)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
        np.testing.assert_allclose(tgates.numpy(), np.asarray(jgates), **TOL)
    # the ties are really there: most rows tie the k-th and (k+1)-th
    # largest logits
    ranked = -np.sort(-logits, axis=-1)
    assert (ranked[..., k - 1] == ranked[..., k]).mean() > 0.5


@pytest.mark.parametrize("capacity", [1, 3, 8])
def test_dispatch_combine_equals_jax(capacity):
    """From the same gates and expert indices: combine (B,G,T,E,C) and the
    bf16 dispatch equal JAX's element for element, at a capacity that
    drops most choices, some, and none."""
    rng = np.random.default_rng(capacity)
    idx = np.stack([rng.permutation(E)[:3] for _ in range(2 * 2 * 10)]
                   ).reshape(2, 2, 10, 3).astype(np.int32)
    gates = rng.random((2, 2, 10, 3)).astype(np.float32)
    jc, jd = jax_moe._dispatch_combine(jnp.asarray(gates), jnp.asarray(idx),
                                       E, capacity)
    tc, td = moe._dispatch_combine(torch.from_numpy(gates),
                                   torch.from_numpy(idx).long(), E, capacity)
    assert tc.dtype == torch.float32 and td.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))
    assert tc.shape == (2, 2, 10, E, capacity)


def test_load_balancing_loss_matches_jax():
    rng = np.random.default_rng(7)
    probs = rng.random((2, 3, 10, E)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    idx = rng.integers(0, E, (2, 3, 10, K)).astype(np.int32)
    want = jax_moe.load_balancing_loss(jnp.asarray(probs), jnp.asarray(idx),
                                       E)
    got = moe.load_balancing_loss(torch.from_numpy(probs),
                                  torch.from_numpy(idx).long(), E)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
