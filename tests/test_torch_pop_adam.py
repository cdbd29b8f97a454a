"""The port's pop_adam and population_adam against the JAX package's.

On the CPU the wrapper runs its plain version; it is held against the
Pallas kernel in interpret mode and the oracle ``ref.pop_adam_ref`` over
ragged P (the port masks where the TPU kernel needs a block multiple, so
JAX runs each ragged case with ``block=P``), per-member step and lr = 0,
at rtol = 1e-5, atol = 1e-6: pow, sqrt and division round differently in
the two frameworks. ``population_adam`` over member-stacked trees is held
against the JAX package's ``population_adam(fused=False)`` over 3 steps
at the same tolerance, and the port's single-member ``adam`` with
``apply_updates`` against the JAX package's over 3 steps, scalar and
traced lr. The Triton kernel itself is held against the plain version on
the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.pop_adam import pop_adam as jax_pop_adam
from repro.optim import adam as jax_adam
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import population_adam as jax_population_adam
from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain
from repro_torch.optim import (AdamState, adam, apply_updates,
                               population_adam)
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(n, p, seed=0):
    rng = np.random.default_rng(seed + 100 * n + p)
    params, grads, mu = (rng.standard_normal((n, p)).astype(np.float32)
                         for _ in range(3))
    nu = rng.random((n, p)).astype(np.float32)
    lr = np.linspace(1e-4, 3e-3, n).astype(np.float32)
    step = np.array([(1, 2, 1000)[i % 3] for i in range(n)], np.int32)
    return params, grads, mu, nu, lr, step


@pytest.mark.parametrize("p", [1, 7, 129, 4095, 4096])
@pytest.mark.parametrize("n", [1, 3])
def test_pop_adam_matches_jax(n, p):
    args = _inputs(n, p)
    before = pop_adam.launches
    got = pop_adam(*(torch.from_numpy(a) for a in args))
    assert pop_adam.launches == before          # the CPU runs no kernel
    pallas = jax_pop_adam(*(jnp.asarray(a) for a in args), block=p,
                          interpret=True)
    oracle = ref.pop_adam_ref(*(jnp.asarray(a) for a in args))
    for g, pa, o in zip(got, pallas, oracle):
        assert g.shape == (n, p) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(pa), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(o), **TOL)


def test_pop_adam_zero_lr_keeps_params_and_moves_moments():
    params, grads, mu, nu, _, step = _inputs(2, 33)
    lr = np.zeros(2, np.float32)
    p2, m2, v2 = pop_adam(*(torch.from_numpy(a) for a in
                            (params, grads, mu, nu, lr, step)))
    np.testing.assert_array_equal(p2.numpy(), params)
    want = ref.pop_adam_ref(*(jnp.asarray(a) for a in
                              (params, grads, mu, nu, lr, step)))
    np.testing.assert_allclose(m2.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(v2.numpy(), np.asarray(want[2]), **TOL)


def test_plain_in_place_steps_by_chunks_bit_for_bit(monkeypatch):
    """In place, the plain version steps ``PLAIN_CHUNK`` columns at a time
    (its temporaries a few chunks, not copies of the population): with a
    chunk of 37 columns, a ragged last one among them, every result
    equals the whole-row form's bit for bit, written into the inputs."""
    from repro_torch.kernels import pop_adam as module

    rng = np.random.default_rng(5)
    rows = [torch.from_numpy(rng.standard_normal((3, 1000)).astype(
        np.float32)) for _ in range(3)]
    rows.append(torch.from_numpy(rng.random((3, 1000)).astype(np.float32)))
    vec = lambda: torch.from_numpy(rng.random(3).astype(np.float32))
    lr, wd, scale = vec() * 1e-3, vec(), vec()
    step = torch.tensor([1, 5, 100], dtype=torch.int32)
    want = pop_adam_plain(*rows, lr, step, wd=wd, scale=scale)
    monkeypatch.setattr(module, "PLAIN_CHUNK", 37)
    copies = [r.clone() for r in rows]
    got = pop_adam(*copies, lr, step, wd=wd, scale=scale, inplace=True)
    assert all(g is c for g, c in zip(got, (copies[0], copies[2],
                                            copies[3])))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pop_adam_refuses_bad_inputs():
    t = [torch.from_numpy(a) for a in _inputs(2, 8)]
    with pytest.raises(TypeError, match="int32 step"):
        pop_adam(*t[:5], t[5].long())
    with pytest.raises(TypeError, match="float32"):
        pop_adam(t[0].double(), *t[1:])
    with pytest.raises(ValueError, match="one \\(N, P\\) shape"):
        pop_adam(t[0][:, :4], *t[1:])
    with pytest.raises(ValueError, match="lr and step"):
        pop_adam(*t[:4], t[4][:1], t[5])
    with pytest.raises(ValueError, match="no kernel for device"):
        pop_adam(*(x.to("meta") for x in t))
    assert pop_adam_plain is not pop_adam


def _stacked_trees(seed, n):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((n, 5, 7)).astype(np.float32),
            "b": rng.standard_normal((n, 7)).astype(np.float32)}


@pytest.mark.parametrize("fused", [None, False])
def test_population_adam_matches_jax_over_three_steps(fused):
    """The port's population optimizer (flatten -> pop_adam -> contiguous
    leaves) against JAX's ``population_adam(fused=False)`` (stock Adam per
    member under vmap), per-member lr, 3 steps."""
    n = 3
    params, grads = _stacked_trees(0, n), _stacked_trees(1, n)
    lr = np.asarray([1e-3, 3e-4, 1e-4], np.float32)

    ji, ja = jax_population_adam(3e-4, fused=False)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    js = ji(jp)
    for _ in range(3):
        jp, js = ja(jp, jg, js, lr_override=jnp.asarray(lr))

    ti, ta = population_adam(3e-4, fused=fused)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    ts = ti(tp)
    assert isinstance(ts, AdamState) and ts.step.dtype == torch.int32
    for _ in range(3):
        tp, ts = ta(tp, tg, ts, lr_override=torch.from_numpy(lr))

    for name in ("w", "b"):
        assert tp[name].is_contiguous() and tp[name].shape == params[
            name].shape
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   **TOL)
        np.testing.assert_allclose(ts.mu[name].numpy(),
                                   np.asarray(js.mu[name]), **TOL)
        np.testing.assert_allclose(ts.nu[name].numpy(),
                                   np.asarray(js.nu[name]), **TOL)
    np.testing.assert_array_equal(ts.step.numpy(), np.asarray(js.step))
    assert [x.shape for x in leaves(ts.mu)] == [x.shape for x in leaves(tp)]


@pytest.mark.parametrize("lr_override", [None, 1e-3])
def test_adam_and_apply_updates_match_jax_over_three_steps(lr_override):
    """One member's stock Adam: ``update_fn`` with ``lr_override`` (None
    keeps the built-in lr) then ``apply_updates``, against the JAX
    package's, 3 steps with a fresh gradient each."""
    params = {k: v[0] for k, v in _stacked_trees(0, 1).items()}
    grads = [{k: v[0] for k, v in _stacked_trees(s, 1).items()}
             for s in (1, 2, 3)]

    ji, ju = jax_adam(3e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = ji(jp)
    ti, tu = adam(3e-4)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = ti(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for g in grads:
        upd, js = ju({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                     lr_override=lr_override)
        jp = jax_apply_updates(jp, upd)
        tupd, ts = tu({k: torch.from_numpy(v) for k, v in g.items()}, ts,
                      tp, lr_override=lr_override)
        tp = apply_updates(tp, tupd)

    assert int(ts.step) == int(js.step) == 3
    for name in ("w", "b"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   **TOL)
        np.testing.assert_allclose(ts.mu[name].numpy(),
                                   np.asarray(js.mu[name]), **TOL)
        np.testing.assert_allclose(ts.nu[name].numpy(),
                                   np.asarray(js.nu[name]), **TOL)
