"""The port's flash attention and its dispatch against the JAX package's.

On the CPU the ``flash_attention`` wrapper runs its plain version. It is
held against the Pallas kernel in interpret mode and the oracle
``ref.flash_attention_ref``, causal and not, over the JAX suite's shapes
(``tests/test_kernels.py``), GQA group 7 (qwen2) and the head sizes 112
(zamba2-7b's shared block) and 256 (gemma-7b): float32 at rtol = atol =
2e-4, bf16 at the JAX suite's atol 0.15, rtol 0.1 (the Pallas kernel
rounds unnormalised probabilities to bf16, the oracle normalised ones).
Inputs come from numpy and are rounded to bf16 the same way on both
sides. The CUDA kernel's bf16 route tiles 64 query rows and 64 keys (32
at D=256), so S of 63, 65 and 129 at D 112 and 256 with group 7 are held
too: against the oracle, and against the Pallas kernel where its blocks
tile S (63 and 65; it asserts that min(128, S) divides S, which 129
fails). ``ops.attention`` takes the kernel's branch at every S (the plain
version here, bitwise), a ragged S that the JAX package's dispatch sends
to ``sdpa_auto`` included (1e-5 against it). The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (_launch, flash_attention,
                                                 flash_attention_plain)
from repro_torch.nn.attention import sdpa
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=0.1, atol=0.15)}

# (B, H, Hkv, S, D): tests/test_kernels.py's fixed shapes, then group 7 at
# qwen2-0.5b's head size, D=112 with a ragged S, D=256
SHAPES = [(1, 4, 4, 128, 32), (2, 8, 2, 256, 64), (1, 6, 1, 512, 64),
          (1, 1, 1, 128, 16), (1, 14, 2, 128, 64), (2, 4, 4, 64, 112),
          (1, 2, 1, 128, 256)]
# the edges of the bf16 CUDA route's tiles, at zamba2-7b's and gemma-7b's
# head sizes and GQA group 7
EDGE_SHAPES = [(1, 7, 1, s, d) for d in (112, 256) for s in (63, 65, 129)]


def _inputs(b, h, hkv, s, d, seed=0, layout="bhsd"):
    rng = np.random.default_rng(seed)
    shapes = ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))
    if layout == "bshd":
        shapes = tuple((x[0], x[2], x[1], x[3]) for x in shapes)
    return [rng.standard_normal(x).astype(np.float32) for x in shapes]


def _to(arrays, dtype):
    """The same values on both sides, rounded to ``dtype`` (bf16 by
    round-to-nearest-even in both frameworks)."""
    torch_dtype = getattr(torch, dtype)
    return ([torch.from_numpy(a).to(torch_dtype) for a in arrays],
            [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,h,hkv,s,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas_and_oracle(b, h, hkv, s, d,
                                                         dtype):
    (q, k, v), jargs = _to(_inputs(b, h, hkv, s, d, seed=s + d), dtype)
    before = flash_attention.launches
    routes = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before    # the CPU runs no kernel
    assert flash_attention.launches_by_route == routes
    assert out.shape == (b, h, s, d) and out.dtype == q.dtype
    _close(out, jax_ops.flash_attention(*jargs, interpret=True), TOL[dtype])
    _close(out, ref.flash_attention_ref(*jargs), TOL[dtype])


@pytest.mark.parametrize("b,h,hkv,s,d", EDGE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_at_tile_edges(b, h, hkv, s, d, dtype):
    """S one short of, one past and one past two of the bf16 route's
    64-row tiles, causal, at D 112 and 256 with group 7: the oracle, and
    the Pallas kernel where its blocks tile S. No launch is counted on
    either route."""
    (q, k, v), jargs = _to(_inputs(b, h, hkv, s, d, seed=s * d), dtype)
    routes = dict(flash_attention.launches_by_route)
    out = flash_attention(q, k, v)
    assert flash_attention.launches_by_route == routes
    assert all(n == 0 for n in routes.values())
    assert out.shape == (b, h, s, d) and out.dtype == q.dtype
    _close(out, ref.flash_attention_ref(*jargs), TOL[dtype])
    if s % min(128, s) == 0:
        _close(out, jax_ops.flash_attention(*jargs, interpret=True),
               TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 2, 2, 128, 32),
                                         (1, 4, 2, 64, 112)])
def test_flash_attention_non_causal(b, h, hkv, s, d, dtype):
    (q, k, v), jargs = _to(_inputs(b, h, hkv, s, d, seed=3), dtype)
    out = flash_attention(q, k, v, causal=False)
    _close(out, jax_ops.flash_attention(*jargs, causal=False, interpret=True),
           TOL[dtype])
    _close(out, ref.flash_attention_ref(*jargs, causal=False), TOL[dtype])


@pytest.mark.parametrize("s", [1, 16, 128, 200, 256, 1024])
def test_attention_takes_the_kernel_at_every_s(s):
    """Every S, a ragged 200 included (the CUDA kernel masks a ragged last
    tile): the flash kernel's branch, the plain version on the CPU, on the
    model's (B,S,H,D) tensors; (B,S,H*D) back, as ``sdpa`` returns."""
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(2, 6, 2, s, 32, seed=4, layout="bshd"))
    pos = torch.arange(s).expand(2, s)
    before = flash_attention.launches
    got = ops.attention(q, k, v, pos, pos, causal=True, scale=32 ** -0.5)
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got, want.reshape(2, s, 6 * 32), rtol=0,
                               atol=0)
    assert flash_attention.launches == before
    # the same function as the model's plain attention
    torch.testing.assert_close(
        got, sdpa(q, k, v, pos, pos, causal=True, scale=32 ** -0.5),
        rtol=1e-5, atol=1e-5)


def test_attention_at_a_ragged_s_matches_jax_dispatch():
    """S = 200, which the JAX package's ``attention_fn`` sends to
    ``sdpa_auto`` (its kernel's blocks do not tile it) and the port to the
    flash kernel: the same function, at rtol = atol = 1e-5."""
    s = 200
    arrays = _inputs(1, 4, 2, s, 32, seed=5, layout="bshd")
    q, k, v = (torch.from_numpy(a) for a in arrays)
    pos = torch.arange(s).expand(1, s)
    got = ops.attention(q, k, v, pos, pos, causal=True, scale=32 ** -0.5)
    jpos = jnp.asarray(pos.numpy())
    want = jax_ops.attention_fn(use_kernels=True)(
        *(jnp.asarray(a) for a in arrays), jpos, jpos, causal=True,
        scale=32 ** -0.5)
    _close(got, want, dict(rtol=1e-5, atol=1e-5))


def test_flash_attention_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 8, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="of one type"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q[:, :3], k, v)            # 3 heads over 2
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[:, :, :4], v[:, :, :4])
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    if not torch.cuda.is_available():
        # the kernel's route asked for without a card: it raises, it does
        # not run the plain version instead
        with pytest.raises(RuntimeError):
            _launch(q, k, v, True, None)
