"""A differentiated forward never reaches a kernel (``kernels/ops.py``).

The kernels have no backward, so ``ops.attention``, ``ops.wkv6_apply``
and ``ops.ssd_apply`` send a call that autograd records (grad mode on,
some tensor argument requiring grad) to the JAX package's
``use_kernels=False`` branch: ``nn.attention.sdpa``, and the scans' chunked
form (S a positive multiple of the chunk) or literal scan. Without grad
they call the kernel wrappers as before.

The gradient parity tests hold every parameter leaf's gradient of a
fixed scalar of ``lm.forward``'s logits against ``jax.grad`` through the
JAX package's ``forward(..., train=True)`` on the same float32 weights,
at ``.smoke()`` width with ``ssm_chunk=16`` and 32 tokens, so that the
port's scans take their chunked branch. The scalar is the mean of
logits * w (w fixed from numpy). The JAX side runs with
``use_chunked=False``, its literal scans: its chunked scans take
differences of prefix sums, whose cancellation shows in the gradients of
zamba2's ``dt_bias`` and ``a_log`` well beyond this tolerance (against
the port's forward in float64), where its literal scans and the port's
chunked forms stay well inside it. Tolerance per leaf: rtol 1e-4 and an
atol of 5e-5 times the leaf's largest gradient (float32 sums in other
orders through up to 8 layers and back). The wrappers' refusal of a CUDA
tensor that requires grad is checked on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import lm
from repro_torch.nn import attention, mamba2, rwkv6
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 5e-5
SEQ = 32


def _inputs(name, s, seed=0):
    """The op's tensor arguments (model layout) and its call."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    if name == "attention":
        q, k, v = t(2, s, 4, 8), t(2, s, 2, 8), t(2, s, 2, 8)
        pos = torch.arange(s).expand(2, s)
        return (q, k, v), lambda q, k, v: ops.attention(q, k, v, pos, pos)
    if name == "wkv6":
        r, k, v = t(2, s, 2, 8), t(2, s, 2, 8), t(2, s, 2, 8)
        lw = -torch.exp(t(2, s, 2, 8))
        u, st = t(2, 8), t(2, 2, 8, 8)
        return (r, k, v, lw, u, st), lambda *a: ops.wkv6_apply(*a, chunk=8)
    x, dt = t(2, s, 3, 8), torch.nn.functional.softplus(t(2, s, 3))
    a, b, c, st = -torch.linspace(1.0, 4.0, 3), t(2, s, 4), t(2, s, 4), \
        t(2, 3, 8, 4)
    return (x, dt, a, b, c, st), lambda *a: ops.ssd_apply(*a, chunk=8)


WRAPPERS = {"attention": "flash_attention", "wkv6": "wkv6", "ssd": "ssd"}
PLAIN = {"attention": lambda q, k, v: attention.sdpa(
             q, k, v, torch.arange(q.shape[1]).expand(2, q.shape[1]),
             torch.arange(q.shape[1]).expand(2, q.shape[1]),
             scale=q.shape[-1] ** -0.5),
         "wkv6": lambda *a: rwkv6.wkv6_chunked(*a, chunk=8),
         "ssd": lambda *a: mamba2.ssd_chunked(*a, chunk=8)}


@pytest.mark.parametrize("name", ["attention", "wkv6", "ssd"])
@pytest.mark.parametrize("mode", ["grad", "no_grad_mode", "no_grad_input"])
def test_ops_route_a_differentiated_call_away_from_the_kernel(
        name, mode, monkeypatch):
    """Recording: the wrapper is never called, and the result is nn's plain
    form with a grad_fn. Not recording (grad mode off, or no argument
    requiring grad): the wrapper is called, as before."""
    calls = []
    wrapper = getattr(ops, WRAPPERS[name])

    def spy(*args, **kw):
        calls.append(1)
        if mode == "grad":
            raise AssertionError(f"{name}: kernel reached under autograd")
        return wrapper(*args, **kw)

    monkeypatch.setattr(ops, WRAPPERS[name], spy)
    args, call = _inputs(name, 16)
    if mode != "no_grad_input":
        args[0].requires_grad_(True)
    with torch.set_grad_enabled(mode != "no_grad_mode"):
        got = call(*args)
    first = got[0] if isinstance(got, tuple) else got
    assert len(calls) == (mode != "grad")
    assert (first.grad_fn is not None) == (mode == "grad")
    with torch.no_grad():
        want = PLAIN[name](*args)
    if name == "attention":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        for g, w in zip(got, want):
            torch.testing.assert_close(g.detach(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["wkv6", "ssd"])
def test_a_differentiated_decode_step_takes_the_literal_scan(name,
                                                             monkeypatch):
    """S = 1 (no chunk): the literal scan, with and without grad."""
    monkeypatch.setattr(ops, WRAPPERS[name], None)   # never called
    args, call = _inputs(name, 1)
    args[0].requires_grad_(True)
    y, st = call(*args)
    scan = rwkv6.wkv6_scan if name == "wkv6" else mamba2.ssd_scan
    want_y, want_st = scan(*args)
    torch.testing.assert_close(y, want_y)
    torch.testing.assert_close(st, want_st)
    y.sum().backward()
    assert args[0].grad is not None


@pytest.mark.parametrize("mode", ["grad", "no_grad_mode", "no_grad_input"])
def test_refuse_grad_raises_only_where_autograd_records(mode):
    """The one rule the wrappers and ops share (``repro_torch.kernels``):
    a call is refused exactly when grad mode is on and some argument
    requires grad, and the message names the kernel."""
    x = torch.zeros(3)
    y = torch.zeros(3, requires_grad=mode != "no_grad_input")
    with torch.set_grad_enabled(mode != "no_grad_mode"):
        assert kernels.differentiated(x, y) == (mode == "grad")
        if mode == "grad":
            with pytest.raises(ValueError, match="ssd: the kernel has no "
                                                 "backward"):
                kernels.refuse_grad("ssd", x, y)
        else:
            kernels.refuse_grad("ssd", x, y)


def _sorted_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_sorted_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-0.5b", "rwkv6-test"])
def test_forward_gradients_match_jax_grad(arch):
    """Every parameter leaf's gradient of mean(logits * w), w fixed from
    numpy, through ``lm.forward`` against ``jax.grad`` of the JAX
    package's training forward on the same weights; no kernel wrapper
    counts a launch."""
    jc, tc = jax_get_config(arch), get_config(arch)
    if arch != "rwkv6-test":
        jc, tc = jc.smoke(), tc.smoke()
    jc = jc.replace(ssm_chunk=16, use_chunked=False)
    tc = tc.replace(ssm_chunk=16)
    tp = lm.init_params(torch.Generator().manual_seed(11), tc)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, tc.vocab_size, (2, SEQ))
    w = (rng.standard_normal((2, SEQ, tc.vocab_size))
         / (2 * SEQ * tc.vocab_size)).astype(np.float32)

    def jax_loss(params):
        logits, _, _ = jax_lm.forward(params, jc,
                                      {"tokens": jnp.asarray(tokens)},
                                      train=True)
        return jnp.sum(logits * w)

    want = _sorted_paths(jax.tree.map(np.asarray, jax.grad(jax_loss)(jp)))

    flat = _sorted_paths(tp)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    counts = (flash_attention.launches, wkv6.launches, ssd.launches)
    logits, _ = lm.forward(tp, tc, {"tokens": torch.from_numpy(tokens)})
    (logits * torch.from_numpy(w)).sum().backward()
    assert (flash_attention.launches, wkv6.launches, ssd.launches) == counts
    assert list(flat) == list(want)
    for path, leaf in flat.items():
        got = (leaf.grad if leaf.grad is not None
               else torch.zeros_like(leaf)).numpy()
        np.testing.assert_allclose(
            got, want[path], rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * np.abs(want[path]).max(), err_msg=path)
