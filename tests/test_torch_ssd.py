"""The port's ssd and Mamba2 block against the JAX package's.

On the CPU the ``ssd`` wrapper runs its plain version (the chunked
float32 form); it is held against the Pallas kernel in interpret mode
and the oracle ``ref.ssd_ref`` (the literal scan) at rtol = atol = 2e-4
(``tests/test_kernels.py``'s float32 tolerance: sums over N and the chunk
in another order), with nonzero initial states and decays as strong as
the model gives (a down to -16, dt from a softplus). The scans, the
chunked form, the causal convolution and the block (prefill and decode)
are held against the JAX package's at rtol = atol = 1e-5. The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro.nn import mamba2 as jax_mamba2
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.kernels.ssd import ssd, ssd_plain
from repro_torch.nn import mamba2
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-5, atol=1e-5)
# the plain version against the literal recurrence in float64, at the
# served chunk: a quarter of the kernel tolerance, which the JAX package's
# form (differences of prefix sums) exceeds on these inputs
FLOAT64_TOL = dict(rtol=5e-5, atol=5e-5)


def _inputs(b, h, s, p, n, seed=0, layout="bhsp"):
    """x, dt, a, b, c, state; a = -linspace(1, 16, H) as the model's
    ``-exp(a_log)``, dt = softplus(N(0, 1))."""
    rng = np.random.default_rng(seed)
    xshape = (b, h, s, p) if layout == "bhsp" else (b, s, h, p)
    dshape = (b, h, s) if layout == "bhsp" else (b, s, h)
    x = rng.standard_normal(xshape).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(dshape))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, state


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (1, 2, 8, 8, 8, 8),         # S = chunk
    (2, 3, 32, 16, 8, 8),       # S = 4 chunks
    (1, 2, 64, 32, 16, 16),     # the port's smallest kernel shape
])
def test_ssd_plain_matches_pallas_and_oracle(b, h, s, p, n, chunk):
    args = _inputs(b, h, s, p, n)
    before = ssd.launches
    y, state = ssd(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert ssd.launches == before                # the CPU runs no kernel
    assert y.shape == (b, h, s, p) and state.shape == (b, h, p, n)
    jargs = [jnp.asarray(a) for a in args]
    py, ps = jax_ops.ssd(*jargs, chunk=chunk, interpret=True)
    oy, os_ = ref.ssd_ref(*jargs)
    for got, pallas, oracle in ((y, py, oy), (state, ps, os_)):
        _close(got, pallas, KERNEL_TOL)
        _close(got, oracle, KERNEL_TOL)


def test_ssd_plain_holds_to_float64_at_long_chunks():
    """At the served chunk of 256 with a down to -16 the plain version
    stays within a quarter of the kernel tolerance of the literal
    recurrence in float64: its decay exponents are segment sums summed
    directly (differences of prefix sums, as the JAX package takes them,
    cancel to errors beyond it here)."""
    x, dt, a, b, c, state = (torch.from_numpy(t) for t in
                             _inputs(1, 3, 512, 32, 64, seed=6))
    dt = dt + 1.0            # decays as strong as exp(-16 * 3) per step
    y, st = ssd_plain(x, dt, a, b, c, state, chunk=256)
    y64, st64 = mamba2.ssd_scan(x.transpose(1, 2).double(),
                                dt.transpose(1, 2).double(), a.double(),
                                b.double(), c.double(), state.double())
    torch.testing.assert_close(y.double(), y64.transpose(1, 2),
                               **FLOAT64_TOL)
    torch.testing.assert_close(st.double(), st64, **FLOAT64_TOL)


def test_ssd_scan_and_chunked_match_jax():
    args = _inputs(2, 2, 16, 8, 8, seed=1, layout="bshp")
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    for got, want in zip(mamba2.ssd_scan(*targs), jax_mamba2.ssd_scan(*jargs)):
        _close(got, want, TOL)
    for got, want in zip(mamba2.ssd_chunked(*targs, chunk=4),
                         jax_mamba2.ssd_chunked(*jargs, chunk=4)):
        _close(got, want, TOL)


def test_ssd_apply_dispatch():
    """The kernel's branch (S > 1, S % chunk == 0) runs the plain version
    on the CPU; every other call the literal scan, as on a TPU."""
    x, dt, a, b, c, state = (torch.from_numpy(t) for t in
                             _inputs(1, 2, 8, 8, 8, seed=2, layout="bshp"))
    before = ssd.launches
    y, st = ops.ssd_apply(x, dt, a, b, c, state, chunk=4)
    want_y, want_st = ssd_plain(x.transpose(1, 2), dt.transpose(1, 2), a, b,
                                c, state, chunk=4)
    torch.testing.assert_close(y, want_y.transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(st, want_st, rtol=0, atol=0)
    for s in (1, 6):             # decode, and S not a multiple of the chunk
        y, st = ops.ssd_apply(x[:, :s], dt[:, :s], a, b[:, :s], c[:, :s],
                              state, chunk=4)
        want = mamba2.ssd_scan(x[:, :s], dt[:, :s], a, b[:, :s], c[:, :s],
                               state)
        torch.testing.assert_close(y, want[0], rtol=0, atol=0)
        torch.testing.assert_close(st, want[1], rtol=0, atol=0)
    assert ssd.launches == before


def test_ssd_refuses_what_the_kernel_does_not_take():
    x, dt, a, b, c, state = (torch.from_numpy(t) for t in
                             _inputs(1, 2, 8, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        ssd(x, dt, a.double(), b, c, state)
    with pytest.raises(ValueError, match="b must be"):
        ssd(x, dt, a, b[:, :4], c, state)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd(x[:, :, :6], dt[:, :, :6], a, b[:, :6], c[:, :6], state, chunk=4)
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd(*(t.to("meta") for t in (x, dt, a, b, c, state)))


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(3)
    w, x, prev = (rng.standard_normal(s).astype(np.float32)
                  for s in ((4, 12), (2, 7, 12), (2, 3, 12)))
    bias = rng.standard_normal(12).astype(np.float32)
    got = mamba2._causal_conv(*(torch.from_numpy(t) for t in
                                (w, bias, x, prev)))
    want = jax_mamba2._causal_conv(*(jnp.asarray(t) for t in
                                     (w, bias, x, prev)))
    for g, r in zip(got, want):
        _close(g, r, TOL)


@pytest.mark.parametrize("s", [8, 1])
def test_mamba2_block_matches_jax(s):
    """The block on the same parameters, input and carried state: the
    chunked prefill, or one decode step."""
    d_model, d_state, hd = 32, 8, 16
    jp = jax_mamba2.mamba2_block_init(jax.random.PRNGKey(4), d_model=d_model,
                                      d_state=d_state, head_dim=hd)
    tp = from_jax_params(jp)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s, d_model)).astype(np.float32)
    state = {"ssm": rng.standard_normal(
                 (2, 2 * d_model // hd, hd, d_state)).astype(np.float32),
             "conv": rng.standard_normal(
                 (2, 3, 2 * d_model + 2 * d_state)).astype(np.float32)}
    block = jax.jit(functools.partial(jax_mamba2.mamba2_block_apply,
                                      d_state=d_state, head_dim=hd, chunk=4,
                                      use_kernels=False))
    jy, jst = block(jp, jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in state.items()})
    ty, tst = mamba2.mamba2_block_apply(
        tp, torch.from_numpy(x), {k: torch.from_numpy(v)
                                  for k, v in state.items()},
        d_state=d_state, head_dim=hd, chunk=4)
    _close(ty, jy, TOL)
    for key in ("ssm", "conv"):
        _close(tst[key], jst[key], TOL)
