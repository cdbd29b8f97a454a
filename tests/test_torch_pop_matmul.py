"""The port's pop_matmul against the JAX package's.

On the CPU the port's wrapper runs its plain version (einsum + bias +
act); it is held against the JAX Pallas kernel in interpret mode and
against the JAX package's oracle ``ref.pop_matmul_ref`` on the serving
path's shape set cut to small B, all three activations. Tolerance:
rtol = atol = 1e-5, for fp32 sums taken in another order by the two
frameworks. The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import build
from repro_torch.kernels.pop_matmul import (_member_stride, pop_matmul,
                                            pop_matmul_plain)

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
    got = pop_matmul(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(bias), activation=act).numpy()
    assert pop_matmul.launches == before      # the CPU runs no kernel
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
    with pytest.raises(NotImplementedError, match="forward-only"):
        pop_matmul(x, w.clone().requires_grad_(True), bias)
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
