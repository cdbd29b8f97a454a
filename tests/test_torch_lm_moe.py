"""The port's mixture-of-experts LMs against the JAX package's, on the CPU:
``qwen3-moe-30b-a3b`` (GQA, 128 experts top-8) and
``deepseek-v2-lite-16b`` (MLA, shared experts, a dense first layer), each
at ``.smoke()`` width (4 experts top-2, ``group_size`` 64; deepseek's one
dense and one MoE layer, one shared expert, MLA ranks 32/16/8/16).

Parameters are drawn by the port's ``init_params`` and JAX is given the
same values (``test_init_params_tree_matches_jax`` holds the two inits to
one tree); tokens come from numpy. Tolerances, as
``tests/test_torch_lm.py`` and ``tests/test_torch_lm_train.py`` state
them:

  * the serve step (a 32-token prefill, then 4 decode steps; JAX takes
    its cache form for the prefill, the port its flash kernel's plain
    version for GQA and the absorbed form for MLA, as JAX does): the
    logits and every decode-state leaf at rtol = atol = 1e-4;
  * decode token by token against the full forward, and that forward
    against JAX's: 1e-4, with ``capacity_factor`` 8 so that no token is
    dropped (a prefill's groups drop where a decode step's group of one
    cannot), as the JAX package's ``tests/test_decode_consistency.py``
    raises it;
  * ``lm_loss``, its ce and the summed aux at rtol 1e-5; gradients (remat
    on and off) at rtol 1e-4 and an atol of 5e-5 times the leaf's largest
    gradient.
"""
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch.configs import TrainConfig, get_config, list_configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import lm
from repro_torch.tree import flatten
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 5e-5
PROMPT, DECODE, BATCH, MAX_LEN, SEQ = 32, 4, 2, 40, 32


def _configs(arch, capacity_factor=None, **kw):
    jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
    if capacity_factor is not None:
        jc = jc.replace(moe=dataclasses.replace(
            jc.moe, capacity_factor=capacity_factor))
        tc = tc.replace(moe=dataclasses.replace(
            tc.moe, capacity_factor=capacity_factor))
    return jc.replace(**kw), tc.replace(**kw)


def _params(tc, seed=0):
    tp = lm.init_params(torch.Generator().manual_seed(seed), tc)
    return tp, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


def _tokens(tc, shape, seed=1):
    return np.random.default_rng(seed).integers(0, tc.vocab_size, shape,
                                                dtype=np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), **tol)


def _sorted_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_sorted_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


# ------------------------------------------------------------------ params
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """Same paths, shapes and dtypes: the ``dense`` and ``moe`` segments
    (deepseek) or the ``moe`` one alone (qwen3-moe), MLA's or GQA's
    attention, the router, the stacked experts and the shared expert."""
    jc, tc = _configs(arch)
    assert [(s.name, s.count, s.moe) for s in lm.layout(tc)] == [
        (s.name, s.count, s.moe) for s in jax_lm.layout(jc)]
    jp = _sorted_paths(jax.tree.map(np.asarray, jax.jit(
        jax_lm.init_params, static_argnums=1)(jax.random.PRNGKey(0), jc)))
    tp = _sorted_paths(lm.init_params(torch.Generator().manual_seed(0), tc))
    assert list(tp) == list(jp)
    for path, want in jp.items():
        assert tuple(tp[path].shape) == want.shape, path
        assert str(tp[path].dtype) == f"torch.{want.dtype}", path
        if path.rsplit("/", 1)[-1] == "scale":
            np.testing.assert_array_equal(tp[path].numpy(), want)
    assert ("/segments/moe/mlp/shared/w_up/w" in tp) == (
        arch == "deepseek-v2-lite-16b")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_shapes_match_jax_at_full_size(arch):
    """The served decode state at the full published size (nothing is
    allocated): GQA's k/v, or MLA's compressed ``c_kv`` and ``k_rope``."""
    want = _sorted_paths(jax_lm.decode_state_shapes(
        jax_get_config(arch), 4, 545))
    got = _sorted_paths(lm.decode_state_shapes(get_config(arch), 4, 545))
    assert list(got) == list(want)
    for path, (shape, dtype) in got.items():
        assert shape == want[path][0], path
        assert str(dtype) == f"torch.{np.dtype(want[path][1])}", path


# ------------------------------------------------------------------ serve
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_prefill_and_decode_match_jax(arch):
    """A 32-token prefill in one call of the serve step, then 4 decode
    steps, at the config's own capacity factor (the prefill's group of 32
    tokens may drop, each decode step's group of one never does): logits
    and every decode-state leaf. No kernel launches on the CPU."""
    jc, tc = _configs(arch)
    tp, jp = _params(tc)
    tokens = _tokens(tc, (BATCH, PROMPT))
    jstep = jax.jit(jax_lm.make_serve_step(jc))
    tstep = lm.make_serve_step(tc)
    jstate = jax_lm.init_decode_state(jc, BATCH, MAX_LEN)
    tstate = lm.init_decode_state(tc, BATCH, MAX_LEN)
    before = flash_attention.launches
    for i in range(1 + DECODE):
        index = 0 if i == 0 else PROMPT + i - 1
        jl, jstate = jstep(jp, {"tokens": jnp.asarray(tokens)}, jstate,
                           jnp.asarray(index, jnp.int32))
        tl, tstate = tstep(tp, {"tokens": torch.from_numpy(tokens).long()},
                           tstate, index)
        _close(tl, jl)
        jleaves, _ = jax.tree_util.tree_flatten(jstate)
        tleaves, _ = flatten(tstate)
        assert len(tleaves) == len(jleaves)
        for got, want in zip(tleaves, jleaves):
            assert tuple(got.shape) == want.shape
            _close(got, want)
        tokens = np.asarray(jl[:, -1]).argmax(-1)[:, None].astype(np.int32)
    assert flash_attention.launches == before


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_full_forward(arch):
    """With ``capacity_factor`` 8 (no drops): the stateless forward equals
    JAX's, and 8 tokens decoded one by one through the port's serve step
    give its logits at every position."""
    jc, tc = _configs(arch, capacity_factor=8.0)
    tp, jp = _params(tc, seed=2)
    tokens = _tokens(tc, (BATCH, 8), seed=3)
    want, _, _ = jax_lm.forward(jp, jc, {"tokens": jnp.asarray(tokens)})
    full, none = lm.forward(tp, tc, {"tokens": torch.from_numpy(tokens)})
    assert none is None
    _close(full, want)
    step = lm.make_serve_step(tc)
    state = lm.init_decode_state(tc, BATCH, 16)
    for t in range(8):
        logits, state = step(tp, {"tokens": torch.from_numpy(
            tokens[:, t:t + 1]).long()}, state, t)
        torch.testing.assert_close(logits[:, 0], full[:, t], **TOL)


# ------------------------------------------------------------------ train
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    """The loss with the aux term (``aux_loss_weight`` times the summed aux
    over the MoE layers), its ce and aux, at rtol 1e-5; the aux term is
    really in it."""
    jc, tc = _configs(arch)
    tp, jp = _params(tc, seed=4)
    tokens = _tokens(tc, (2, SEQ), seed=5)
    jloss, jm = jax_lm.lm_loss(jp, jc, {"tokens": jnp.asarray(tokens)})
    tloss, tm = lm.lm_loss(tp, tc, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(tm["ce"].item(), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(tm["aux"].item(), float(jm["aux"]),
                               rtol=1e-5)
    moe_layers = tc.num_layers - tc.moe.first_dense_layers
    assert tm["aux"].item() > 0.5 * moe_layers
    np.testing.assert_allclose(
        tloss.item() - tm["ce"].item(),
        tc.moe.aux_loss_weight * tm["aux"].item() / moe_layers, rtol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_grads_match_jax(arch, remat):
    """Every parameter's gradient of ``lm_loss`` (the aux term's through
    the router included) against ``jax.grad``, remat per layer (the aux
    loss returned beside h from the checkpointed layer) or none."""
    jc, tc = _configs(arch, remat=remat)
    tp, jp = _params(tc, seed=6)
    tokens = _tokens(tc, (2, SEQ), seed=7)
    want = jax.grad(lambda p: jax_lm.lm_loss(
        p, jc, {"tokens": jnp.asarray(tokens)})[0])(jp)
    got, loss, _ = lm._make_grads_fn(tc, TrainConfig())(
        tp, {"tokens": torch.from_numpy(tokens)})
    assert not loss.requires_grad
    got, want = _sorted_paths(got), _sorted_paths(want)
    assert list(got) == list(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * np.abs(w).max(), err_msg=path)
    assert np.abs(np.asarray(want["/segments/moe/mlp/router/w"])).max() > 0


# ------------------------------------------------------------ registry, CLI
def test_registry_admits_moe_and_refuses_frontends():
    """Both MoE configs come with the JAX package's values; the frontend
    configs, once refused by name, are admitted with the JAX package's
    frontend fields, and an unknown arch is still refused."""
    assert list_configs()[-4:-2] == ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch).moe) == \
            dataclasses.asdict(jax_get_config(arch).moe)
        assert (get_config(arch).mla is None) == (
            jax_get_config(arch).mla is None)
    assert dataclasses.asdict(get_config(ARCHS[1]).mla) == \
        dataclasses.asdict(jax_get_config(ARCHS[1]).mla)
    for arch in ARCHS:
        jc, tc = jax_get_config(arch), get_config(arch)
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "head_dim", "qk_norm",
                      "rope_theta", "tie_embeddings", "dtype", "remat"):
            assert getattr(tc, field) == getattr(jc, field), (arch, field)
        assert dataclasses.asdict(tc.smoke().moe) == \
            dataclasses.asdict(jc.smoke().moe)
    assert list_configs()[-2:] == ["musicgen-medium", "pixtral-12b"]
    for arch in ("musicgen-medium", "pixtral-12b"):
        jc, tc = jax_get_config(arch), get_config(arch)
        assert (tc.frontend, tc.num_frontend_positions) == (
            jc.frontend, jc.num_frontend_positions)
        assert tc.moe is None and tc.mla is None
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("musicgen-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_and_serves_moe_on_cpu(arch, tmp_path, capsys):
    """``launch.train --arch ... --smoke --device cpu``: 2 members, 4
    steps, PBT every 2, the vectorized update; then ``launch.serve``
    generates 4 tokens from 2 prompts."""
    report = train_main(["--arch", arch, "--smoke", "--population", "2",
                         "--steps", "4", "--pbt-interval", "2", "--batch",
                         "2", "--seq-len", "32", "--ckpt-dir",
                         str(tmp_path / "ck"), "--device", "cpu"])
    assert [s for s, _ in report.evolutions] == [2, 4]
    assert np.isfinite(report.final_loss)
    served = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "32",
                         "--tokens", "4"])
    vocab = get_config(arch).smoke().vocab_size
    assert served.tokens.shape == (2, 5)
    assert 0 <= int(served.tokens.min()) and int(served.tokens.max()) < vocab
    out = capsys.readouterr().out
    assert f"[train] arch={arch} pop=2" in out
    assert "ms per decode step" in out


def test_served_weights_are_freed_on_return(monkeypatch):
    """A serve run's weights die when it returns, with Python's cycle
    collector off: qwen3-moe's 61 GB on the card leave room for the next
    run only if nothing holds them in a reference cycle (``tree.flatten``
    once did, through a nested function that called itself)."""
    alive = []
    init = lm.init_params

    def recording(*args, **kwargs):
        params = init(*args, **kwargs)
        alive.append(weakref.ref(
            params["segments"]["moe"]["mlp"]["experts"]["w_gate"]))
        return params

    monkeypatch.setattr(lm, "init_params", recording)
    gc.disable()
    try:
        serve_main(["--arch", ARCHS[0], "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "16", "--tokens", "2"])
        assert len(alive) == 1 and alive[0]() is None
    finally:
        gc.enable()
