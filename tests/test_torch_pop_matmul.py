"""The port's pop_matmul against the JAX package's.

On the CPU the port's wrapper runs its plain version (einsum + bias +
act); it is held against the JAX Pallas kernel in interpret mode and
against the JAX package's oracle ``ref.pop_matmul_ref`` on the serving
path's shape set cut to small B, all three activations. Tolerance:
rtol = atol = 1e-5, for fp32 sums taken in another order by the two
frameworks. The gradients of the port's ``PopMatmul`` (dx, dw, db) are
held against ``jax.grad`` through the JAX package's ``custom_vjp``
(``pop_linear_apply(..., fused=True)``, interpret mode) at 2e-4: fp32 sums
over the batch in another order, times the activation's derivative. The
CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.rl import networks as jax_nets
from repro_torch.kernels import build
from repro_torch.kernels.pop_matmul import (PopMatmul, _launch,
                                            _member_stride, _route,
                                            pop_matmul, pop_matmul_plain)
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ("none", "relu", "tanh")


def _inputs(n, b, k, m, seed=0):
    rng = np.random.default_rng(seed + 1000 * n + 100 * b + k + m)
    x = rng.standard_normal((n, b, k), dtype=np.float32)
    w = (rng.standard_normal((n, k, m)) / np.sqrt(k)).astype(np.float32)
    bias = rng.standard_normal((n, m), dtype=np.float32)
    return x, w, bias


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("k,m", [(3, 256), (256, 256), (256, 1)])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_pop_matmul_matches_jax(n, b, k, m, act):
    x, w, bias = _inputs(n, b, k, m)
    before = pop_matmul.launches
    routes = dict(pop_matmul.launches_by_route)
    got = pop_matmul(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(bias), activation=act).numpy()
    assert pop_matmul.launches == before      # the CPU runs no kernel
    assert pop_matmul.launches_by_route == routes
    pallas = np.asarray(ops.pop_matmul(x, w, bias, activation=act,
                                       interpret=True))
    oracle = np.asarray(ref.pop_matmul_ref(x, w, bias, activation=act))
    assert got.shape == (n, b, m) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("act", ACTS)
def test_broadcast_x_matches_materialized(act):
    """Requests broadcast over members (stride 0, as the ensemble forward
    passes them) give the same answer as a materialized copy."""
    x, w, bias = _inputs(4, 5, 3, 256)
    one = torch.from_numpy(x[0])
    bx = one.unsqueeze(0).expand(4, 5, 3)
    w, bias = torch.from_numpy(w), torch.from_numpy(bias)
    np.testing.assert_allclose(
        pop_matmul(bx, w, bias, activation=act).numpy(),
        pop_matmul(bx.contiguous(), w, bias, activation=act).numpy(),
        rtol=0, atol=0)
    oracle = np.asarray(ref.pop_matmul_ref(
        np.broadcast_to(x[:1], (4, 5, 3)), w.numpy(), bias.numpy(),
        activation=act))
    np.testing.assert_allclose(pop_matmul(bx, w, bias, activation=act),
                               oracle, **TOL)


def test_no_bias():
    x, w, _ = _inputs(2, 4, 8, 8)
    got = pop_matmul(torch.from_numpy(x), torch.from_numpy(w), None,
                     activation="relu").numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref.pop_matmul_ref(x, w, None, activation="relu")),
        **TOL)


# (N, B, K, M, route): the served batch's three layers (E=4, B=256), the
# update step's (N=8, the critic's K=4), the rule's edge (M of 15 and 16)
# with B across the tiled route's 32-row tile, ragged K and M, and M=0
ROUTE_CASES = [(4, 256, 3, 256, "tiled"), (4, 256, 256, 256, "tiled"),
               (4, 256, 256, 1, "narrow"), (8, 256, 3, 256, "tiled"),
               (8, 256, 4, 256, "tiled"), (8, 256, 256, 256, "tiled"),
               (8, 256, 256, 1, "narrow"), (4, 33, 256, 15, "narrow"),
               (4, 31, 256, 16, "tiled"), (1, 1, 33, 17, "tiled"),
               (4, 256, 255, 1, "narrow"), (4, 256, 256, 0, "narrow")]


@pytest.mark.parametrize("n,b,k,m,want", ROUTE_CASES)
def test_route_rule(n, b, k, m, want):
    """The kernel's route at each shape, for a contiguous x and for
    requests broadcast over members alike, M=0 included; at each, the
    wrapper on the CPU gives the JAX package's oracle answer and counts no
    launch on either route."""
    x, w, bias = _inputs(n, b, k, m)
    oracle = np.asarray(ref.pop_matmul_ref(x, w, bias, activation="relu"))
    x, w, bias = (torch.from_numpy(a) for a in (x, w, bias))
    broadcast = x[0].unsqueeze(0).expand(n, b, k)
    assert _route(n, b, k, m) == want
    assert _route(*broadcast.shape, m) == want
    routes = dict(pop_matmul.launches_by_route)
    y = pop_matmul(x, w, bias, activation="relu")
    assert y.shape == (n, b, m)
    np.testing.assert_allclose(y.numpy(), oracle, **TOL)
    pop_matmul(broadcast, w, bias, activation="relu")
    assert pop_matmul.launches_by_route == routes
    assert all(c == 0 for c in routes.values())


def test_member_stride_for_the_kernel():
    """The stride the wrapper hands the kernel: B*K for a contiguous x, 0
    for requests broadcast over members; other layouts are refused."""
    x = torch.zeros((4, 5, 3))
    assert _member_stride(x) == 15
    assert _member_stride(torch.zeros((5, 3)).unsqueeze(0).expand(4, 5, 3)) \
        == 0
    with pytest.raises(ValueError, match="neither contiguous"):
        _member_stride(torch.zeros((4, 3, 5)).transpose(1, 2))


def test_wrapper_refuses_bad_inputs():
    x, w, bias = (torch.from_numpy(a) for a in _inputs(2, 4, 3, 8))
    # an input that requires grad is no longer refused: it is recorded
    wg = w.clone().requires_grad_(True)
    y = pop_matmul(x, wg, bias)
    assert y.grad_fn is not None and y.grad_fn.name().startswith("PopMatmul")
    with pytest.raises(TypeError, match="float32"):
        pop_matmul(x.double(), w.double(), bias.double())
    with pytest.raises(ValueError, match="does not match"):
        pop_matmul(x, w[:, :2], bias)
    with pytest.raises(ValueError, match=r"\(N,B,K\)"):
        pop_matmul(x[0], w, bias)
    with pytest.raises(ValueError, match="b must be"):
        pop_matmul(x, w, bias[:, :4])
    with pytest.raises(ValueError, match="unsupported activation"):
        pop_matmul(x, w, bias, activation="gelu")
    meta = [t.to("meta") for t in (x, w, bias)]
    with pytest.raises(ValueError, match="no kernel for device"):
        pop_matmul(*meta)


def test_plain_version_is_the_reference_formula():
    x, w, bias = (torch.from_numpy(a) for a in _inputs(3, 4, 5, 6))
    want = torch.tanh(torch.bmm(x, w) + bias[:, None, :])
    torch.testing.assert_close(pop_matmul_plain(x, w, bias,
                                                activation="tanh"),
                               want, **TOL)


def test_build_names_libraries_by_content():
    """The built library's name carries a digest of the sources and flags,
    so an edited source is never served by a stale library; importing the
    module builds nothing."""
    path = build.library_path("pop_matmul")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libpop_matmul-") and path.suffix == ".so"
    assert path == build.library_path("pop_matmul")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("k,m", [(4, 32), (32, 32), (32, 1)])
def test_pop_matmul_gradients_match_jax(k, m, act):
    """dx, dw and db of the port's autograd Function against jax.grad
    through the JAX package's custom_vjp (Pallas kernel forward in
    interpret mode, einsum backward), for one cotangent."""
    n, b = 3, 8
    x, w, bias = _inputs(n, b, k, m, seed=7)
    cot = np.random.default_rng(k + m).standard_normal(
        (n, b, m)).astype(np.float32)

    def jloss(p, xx):
        y = jax_nets.pop_linear_apply(p, xx, activation=act, fused=True)
        return jnp.sum(y * cot)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        {"w": jnp.asarray(w), "b": jnp.asarray(bias)}, jnp.asarray(x))

    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, w, bias))
    y = pop_matmul(tx, tw, tb, activation=act)
    assert y.grad_fn.name().startswith("PopMatmul")
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg_p["w"]),
                               **GRAD_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg_p["b"]),
                               **GRAD_TOL)


def test_pop_matmul_backward_computes_only_what_is_asked():
    """Only the gradients autograd asks for are computed, a broadcast x
    differentiates like its materialized copy, and a call with nothing to
    record (no_grad, or no input requiring grad) builds no graph."""
    x, w, bias = (torch.from_numpy(a) for a in _inputs(2, 5, 3, 8))
    wg, bg = w.clone().requires_grad_(True), bias.clone().requires_grad_(
        True)
    y = pop_matmul(x, wg, bg, activation="relu")
    dw, db = torch.autograd.grad(y.sum(), (wg, bg))
    want = pop_matmul_plain(x, w.clone().requires_grad_(True), bias,
                            activation="relu")
    assert dw.shape == w.shape and db.shape == bias.shape
    ctx_needs = []
    orig = PopMatmul.backward

    def spy(ctx, dy):
        ctx_needs.append(tuple(ctx.needs_input_grad[:3]))
        return orig(ctx, dy)

    PopMatmul.backward = staticmethod(spy)
    try:
        xg = x.clone().requires_grad_(True)
        torch.autograd.grad(pop_matmul(xg, w, bias).sum(), xg)
    finally:
        PopMatmul.backward = staticmethod(orig)
    assert ctx_needs == [(True, False, False)]

    one = torch.from_numpy(_inputs(1, 5, 3, 8)[0][0])
    bx = one.unsqueeze(0).expand(2, 5, 3)
    g_b = torch.autograd.grad(
        pop_matmul(bx, wg, bg, activation="tanh").sum(), wg)[0]
    g_m = torch.autograd.grad(
        pop_matmul(bx.contiguous(), wg, bg, activation="tanh").sum(), wg)[0]
    torch.testing.assert_close(g_b, g_m, rtol=0, atol=0)

    with torch.no_grad():
        assert pop_matmul(x, wg, bg).grad_fn is None
    assert pop_matmul(x, w, bias).grad_fn is None
    assert want.grad_fn is not None


def test_narrow_route_refuses_wide_m():
    """A launch asked for the narrow route at M >= 16 is refused before
    any kernel is built or launched."""
    x, w, bias = (torch.from_numpy(a) for a in _inputs(2, 4, 8, 16))
    before = pop_matmul.launches
    with pytest.raises(ValueError, match="narrow route takes M < 16"):
        _launch(x, w, bias, "relu", route="narrow")
    assert pop_matmul.launches == before
