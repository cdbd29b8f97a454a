"""The port's wkv6 and RWKV6 block against the JAX package's.

On the CPU the ``wkv6`` wrapper runs its plain version (the chunked
float32 form); it is held against the Pallas kernel in interpret mode
and the oracle ``ref.wkv6_ref`` (the literal scan) at rtol = atol = 2e-4
(``tests/test_kernels.py``'s float32 tolerance: sums over D and the chunk
in another order, ``exp(a) exp(b)`` for ``exp(a + b)``), with nonzero
initial states and decays as strong as the model gives (lw down to
-e^3). The scans, the chunked form and the blocks (time-mix and
channel-mix, prefill and decode) are held against the JAX package's at
rtol = atol = 1e-5. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``; its tile algebra (32-token
tiles, running-product decays, the per-channel column scale of the state)
is modelled in torch here and held against the literal scan and the plain
version at the kernel tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro.nn import rwkv6 as jax_rwkv6
from repro.nn.basic import layernorm_apply as jax_layernorm
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.nn import rwkv6
from repro_torch.nn.basic import layernorm_apply
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
# csrc/wkv6.cu's tile, 32 tokens whatever the caller's chunk, in
# sub-tiles of 8
KERNEL_TILE, KERNEL_SUB = 32, 8


def _inputs(b, h, s, d, seed=0, layout="bhsd", log_decay=(-3.0, 3.0)):
    """r, k, v, lw, u, state; lw = -exp(U(-3, 3)), so decays reach
    exp(-e^3) per step (``log_decay`` sets the range)."""
    rng = np.random.default_rng(seed)
    shape = (b, h, s, d) if layout == "bhsd" else (b, s, h, d)
    r, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.uniform(*log_decay, shape)).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, d))).astype(np.float32)
    state = rng.standard_normal((b, h, d, d)).astype(np.float32)
    return r, k, v, lw, u, state


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("b,h,s,d,chunk", [
    (1, 2, 8, 8, 8),        # S = chunk
    (2, 2, 32, 16, 8),      # S = 4 chunks
    (1, 1, 64, 32, 16),     # the port's smallest kernel head size
])
def test_wkv6_plain_matches_pallas_and_oracle(b, h, s, d, chunk):
    args = _inputs(b, h, s, d)
    before = wkv6.launches
    y, state = wkv6(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert wkv6.launches == before               # the CPU runs no kernel
    assert y.shape == (b, h, s, d) and state.shape == (b, h, d, d)
    jargs = [jnp.asarray(a) for a in args]
    py, ps = jax_ops.wkv6(*jargs, chunk=chunk, interpret=True)
    oy, os_ = ref.wkv6_ref(*jargs)
    for got, pallas, oracle in ((y, py, oy), (state, ps, os_)):
        _close(got, pallas, KERNEL_TOL)
        _close(got, oracle, KERNEL_TOL)


def test_wkv6_plain_holds_to_float64_at_long_chunks():
    """At the served chunk of 64 with decays down to -e^3 the plain
    version stays within a quarter of the kernel tolerance of the literal
    recurrence in float64: its decay exponents are segment sums summed
    directly (differences of prefix sums, as the JAX package takes them,
    cancel to errors beyond it here)."""
    r, k, v, lw, u, state = (torch.from_numpy(a) for a in
                             _inputs(1, 2, 128, 32, seed=5))
    y, st = wkv6_plain(r, k, v, lw, u, state, chunk=64)
    tr = lambda t: t.transpose(1, 2).double()
    y64, st64 = rwkv6.wkv6_scan(tr(r), tr(k), tr(v), tr(lw), u.double(),
                                state.double())
    torch.testing.assert_close(y.double(), tr(y64), **FLOAT64_TOL)
    torch.testing.assert_close(st.double(), st64, **FLOAT64_TOL)


def _kernel_tile_model(r, k, v, lw, u, state):
    """``csrc/wkv6.cu``'s algebra in torch, (B,H,S,D) -> (y, final state):
    tiles of 32 tokens whatever the chunk, rows past S zero-filled, cut in
    sub-tiles of 8. Every exponent is a one-signed sum, in the kernel's
    order: from a sub-tile's edge to t (r~, k~), or of the sub-tiles'
    totals, before or after a sub-tile (r_in = r~ exp(before), k_out =
    k~ exp(after)) or between two (W_b). A below the diagonal's sub-tiles is
    (r~[t] prod_{S<b<T} W_b) . k~[s]; on them a running product of w, the
    bonus on the diagonal. y is computed transposed, from the state held
    transposed (S^T, v by k) and decayed by a column scale, one factor per
    k channel."""
    b, h, s, d = r.shape
    n, m = KERNEL_TILE, KERNEL_SUB
    tiles = -(-s // n)
    pad = (0, 0, 0, tiles * n - s)
    r, k, v, lw = (F.pad(t, pad) for t in (r, k, v, lw))
    st_t = state.transpose(-1, -2)
    ys = []
    for i in range(tiles):
        rc, kc, vc, lc = (t[:, :, i * n:(i + 1) * n] for t in (r, k, v, lw))
        rt, kt, r_in, k_out = (torch.empty_like(rc) for _ in range(4))
        totals = []
        for sub in range(n // m):            # walks from the edges
            t0 = m * sub
            p = torch.zeros_like(lc[:, :, 0])    # from the start to t
            for t in range(t0, t0 + m):
                rt[:, :, t] = rc[:, :, t] * torch.exp(p)
                p = p + lc[:, :, t]
            a = torch.zeros_like(p)              # after s to the end
            for t in reversed(range(t0, t0 + m)):
                kt[:, :, t] = kc[:, :, t] * torch.exp(a)
                a = a + lc[:, :, t]
            totals.append(p)
        for sub in range(n // m):            # sums of whole sub-tiles
            before = after = torch.zeros_like(p)
            for q in range(sub):
                before = before + totals[q]
            for q in reversed(range(sub + 1, n // m)):
                after = after + totals[q]
            blk = slice(m * sub, m * sub + m)
            r_in[:, :, blk] = rt[:, :, blk] * torch.exp(before)[:, :, None]
            k_out[:, :, blk] = kt[:, :, blk] * torch.exp(after)[:, :, None]
            if sub == 0:
                etot = torch.exp(totals[0] + after)
        mid = {(0, 2): torch.exp(totals[1]),
               (0, 3): torch.exp(totals[1] + totals[2]),
               (1, 3): torch.exp(totals[2])}
        w = torch.exp(lc)
        a = torch.zeros((b, h, n, n))
        for sub in range(n // m):           # the diagonal sub-tiles
            blk = slice(m * sub, m * sub + m)
            kd = torch.zeros_like(kc[:, :, blk])   # 0 until t reaches s
            for t in range(m * sub, m * sub + m):
                a[:, :, t, blk] = torch.einsum("bhi,bhsi->bhs", rc[:, :, t],
                                               kd)
                kd = kd * w[:, :, t, None]
                kd[:, :, t - m * sub] = kc[:, :, t]
            for big in range(sub + 1, n // m):     # below them
                rows = rt[:, :, m * big:m * big + m]
                if (sub, big) in mid:
                    rows = rows * mid[sub, big][:, :, None]
                a[:, :, m * big:m * big + m, blk] = (
                    rows @ kt[:, :, blk].transpose(-1, -2))
        a = a + torch.diag_embed((rc * u[None, :, None] * kc).sum(-1))
        vt = vc.transpose(-1, -2)
        ys.append(st_t @ r_in.transpose(-1, -2) + vt @ a.transpose(-1, -2))
        st_t = st_t * etot[:, :, None, :] + vt @ k_out
    return (torch.cat(ys, dim=-1).transpose(-1, -2)[:, :, :s],
            st_t.transpose(-1, -2))


@pytest.mark.parametrize("log_decay", [(-3.0, 3.0), (-6.0, -3.0)],
                         ids=["strong", "mild"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [8, 24, 200, 512])
def test_wkv6_kernel_tile_algebra(s, d, log_decay):
    """The kernel's tile algebra against the JAX package's literal scan and
    the plain version, at the kernel tolerance: one tile or several, the
    last one ragged (S = 8, 24, 200) or whole (512), a nonzero state, and
    decays down to -e^3 a token, or mild ones (-e^-6 to -e^-3), under
    which the state carried between tiles does not fade."""
    args = _inputs(1, 2, s, d, seed=s + d, layout="bshd",
                   log_decay=log_decay)
    r, k, v, lw = (torch.from_numpy(a).transpose(1, 2) for a in args[:4])
    u, state = (torch.from_numpy(a) for a in args[4:])
    y, st = _kernel_tile_model(r, k, v, lw, u, state)
    assert y.shape == (1, 2, s, d) and st.shape == (1, 2, d, d)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    jy, jst = jax_rwkv6.wkv6_scan(*(jnp.asarray(a) for a in args))
    _close(y.transpose(1, 2), jy, KERNEL_TOL)
    _close(st, jst, KERNEL_TOL)
    py, pst = wkv6_plain(r, k, v, lw, u, state, chunk=64 if s % 64 == 0
                         else 8)
    torch.testing.assert_close(y, py, **KERNEL_TOL)
    torch.testing.assert_close(st, pst, **KERNEL_TOL)


def test_wkv6_scan_and_chunked_match_jax():
    args = _inputs(2, 2, 16, 8, seed=1, layout="bshd")
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    for got, want in zip(rwkv6.wkv6_scan(*targs),
                         jax_rwkv6.wkv6_scan(*jargs)):
        _close(got, want, TOL)
    for got, want in zip(rwkv6.wkv6_chunked(*targs, chunk=4),
                         jax_rwkv6.wkv6_chunked(*jargs, chunk=4)):
        _close(got, want, TOL)


def test_wkv6_apply_dispatch():
    """The kernel's branch (S > 1, S % chunk == 0) runs the plain version
    on the CPU; every other call the literal scan, as on a TPU."""
    r, k, v, lw, u, state = (torch.from_numpy(a) for a in
                             _inputs(1, 2, 8, 8, seed=2, layout="bshd"))
    before = wkv6.launches
    y, st = ops.wkv6_apply(r, k, v, lw, u, state, chunk=4)
    want_y, want_st = wkv6_plain(*(t.transpose(1, 2) for t in (r, k, v, lw)),
                                 u, state, chunk=4)
    torch.testing.assert_close(y, want_y.transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(st, want_st, rtol=0, atol=0)
    for s in (1, 6):             # decode, and S not a multiple of the chunk
        y, st = ops.wkv6_apply(r[:, :s], k[:, :s], v[:, :s], lw[:, :s], u,
                               state, chunk=4)
        want = rwkv6.wkv6_scan(r[:, :s], k[:, :s], v[:, :s], lw[:, :s], u,
                               state)
        torch.testing.assert_close(y, want[0], rtol=0, atol=0)
        torch.testing.assert_close(st, want[1], rtol=0, atol=0)
    assert wkv6.launches == before


def test_wkv6_refuses_what_the_kernel_does_not_take():
    r, k, v, lw, u, state = (torch.from_numpy(a) for a in
                             _inputs(1, 2, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        wkv6(r.double(), k, v, lw, u, state)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r, k, v, lw, u[:1], state)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        wkv6(r[:, :, :6], k[:, :, :6], v[:, :, :6], lw[:, :, :6], u, state,
             chunk=4)
    with pytest.raises(ValueError, match="no kernel for device"):
        wkv6(*(t.to("meta") for t in (r, k, v, lw, u, state)))


@pytest.mark.parametrize("s", [8, 1])
def test_rwkv6_block_matches_jax(s):
    """time_mix (chunked prefill, or one decode step) and channel_mix on
    the same parameters, input and carried state."""
    d_model, d_ff, hd = 32, 64, 8
    jp = jax_rwkv6.rwkv6_block_init(jax.random.PRNGKey(3), d_model=d_model,
                                    d_ff=d_ff, head_dim=hd)
    tp = from_jax_params(jp)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, s, d_model)).astype(np.float32)
    x_prev = rng.standard_normal((2, 1, d_model)).astype(np.float32)
    wkv = rng.standard_normal((2, d_model // hd, hd, hd)).astype(np.float32)
    time_mix = jax.jit(functools.partial(jax_rwkv6.time_mix_apply,
                                         head_dim=hd, chunk=4,
                                         use_kernels=False))
    jy, jst, jlast = time_mix(jp["time_mix"], jnp.asarray(x),
                              jnp.asarray(x_prev), jnp.asarray(wkv))
    ty, tst, tlast = rwkv6.time_mix_apply(
        tp["time_mix"], torch.from_numpy(x), torch.from_numpy(x_prev),
        torch.from_numpy(wkv), head_dim=hd, chunk=4)
    for got, want in ((ty, jy), (tst, jst), (tlast, jlast)):
        _close(got, want, TOL)
    jy, jlast = jax_rwkv6.channel_mix_apply(jp["channel_mix"],
                                            jnp.asarray(x),
                                            jnp.asarray(x_prev))
    ty, tlast = rwkv6.channel_mix_apply(tp["channel_mix"],
                                        torch.from_numpy(x),
                                        torch.from_numpy(x_prev))
    _close(ty, jy, TOL)
    _close(tlast, jlast, TOL)
    ln = {"scale": jnp.asarray(rng.standard_normal(d_model), jnp.float32),
          "bias": jnp.asarray(rng.standard_normal(d_model), jnp.float32)}
    _close(rwkv6._group_norm(from_jax_params(ln), torch.from_numpy(x), 4),
           jax_rwkv6._group_norm(ln, jnp.asarray(x), 4), TOL)
    _close(layernorm_apply(from_jax_params(ln), torch.from_numpy(x)),
           jax_layernorm(ln, jnp.asarray(x)), TOL)
