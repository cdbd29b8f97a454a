"""The port's frontend LMs against the JAX package's, on the CPU:
``musicgen-medium`` (``frontend="audio_frames"``: no embedding table, the
hidden state is ``batch["embeds"]``) and ``pixtral-12b``
(``frontend="vision_patches"``: ``batch["patch_embeds"]`` spliced over the
first positions in the stateless form only, their labels masked), each
at ``.smoke()`` width (2 layers, d_model 128, 8 patch positions).

Parameters are drawn by the port's ``init_params`` and JAX is given the
same values; tokens, frame and patch embeddings come from numpy.
Tolerances (float32; attention takes the flash kernel's plain version in
the port and ``sdpa`` in JAX, which sum in other orders):

  * the stateless forward against JAX's ``forward`` (``cache_index``
    None): rtol 1e-5, atol 1e-5;
  * the serve step (a 16-token prefill at cache index 0, then 3 decode
    steps): the logits and every decode-state leaf at rtol = atol = 1e-4,
    as ``tests/test_torch_lm.py`` holds the other archs; pixtral's
    patches, passed to either side, change nothing there (bit for bit on
    the port's side);
  * ``lm_loss`` and its gradient against ``jax.grad``: rtol 1e-4, atol
    1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import lm
from repro_torch.tree import flatten
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

ARCHS = ["musicgen-medium", "pixtral-12b"]
FORWARD_TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
SEQ, DECODE, BATCH = 16, 3, 2
# the JAX package's fields that the port leaves out: the family name (the
# port reads ``scale_embeddings``), and switches the port's device decides
JAX_ONLY = {"family", "use_chunked", "ssm_compute_dtype", "use_flash",
            "use_kernels"}


def _configs(arch):
    return jax_get_config(arch).smoke(), get_config(arch).smoke()


def _params(tc, seed=0):
    tp = lm.init_params(torch.Generator().manual_seed(seed), tc)
    return tp, jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


def _batch(cfg, b, s, seed=1):
    """numpy inputs: tokens, and the frontend's embeddings (random, of a
    hidden state's scale)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    if cfg.frontend == "audio_frames":
        batch["embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision_patches":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_frontend_positions, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _sorted_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_sorted_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol,
                               err_msg=msg)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax_field_by_field(arch):
    """Every field of the port's config equals the JAX package's, at full
    size and ``.smoke()`` (8 patch positions); the port's
    ``scale_embeddings`` stands for JAX's gemma rule, off here."""
    for jc, tc in ((jax_get_config(arch), get_config(arch)), _configs(arch)):
        names = {f.name for f in dataclasses.fields(tc)}
        assert names - {f.name for f in dataclasses.fields(jc)} == {
            "scale_embeddings"}
        assert {f.name for f in dataclasses.fields(jc)} - names == JAX_ONLY
        for name in names - {"scale_embeddings"}:
            assert getattr(tc, name) == getattr(jc, name), (arch, name)
        assert not tc.scale_embeddings
    assert get_config(arch).frontend == {"musicgen-medium": "audio_frames",
                                         "pixtral-12b": "vision_patches"}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The same tree, shapes and dtypes as JAX's ``init_params``:
    musicgen's has no embedding table."""
    jc, tc = _configs(arch)
    jp = _sorted_paths(jax.tree.map(np.asarray, jax.jit(
        jax_lm.init_params, static_argnums=1)(jax.random.PRNGKey(0), jc)))
    tree = lm.init_params(torch.Generator().manual_seed(0), tc)
    tp = _sorted_paths(tree)
    assert list(tp) == list(jp)
    for path, want in jp.items():
        assert tuple(tp[path].shape) == want.shape, path
        assert str(tp[path].dtype) == f"torch.{want.dtype}", path
    assert ("embed" in tree) == (arch == "pixtral-12b")


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", ARCHS)
def test_stateless_forward_matches_jax(arch):
    """Random frame or patch embeddings through the stateless forward
    (JAX's ``cache_index`` None, where pixtral's patches are spliced)."""
    jc, tc = _configs(arch)
    tp, jp = _params(tc)
    jb, tb = _both(_batch(tc, BATCH, SEQ))
    want, _, _ = jax_lm.forward(jp, jc, jb)
    got, state = lm.forward(tp, tc, tb)
    assert state is None
    _close(got, want, FORWARD_TOL)
    if arch == "pixtral-12b":
        # the splice is there: without the patches the logits move
        plain, _ = lm.forward(tp, tc, {"tokens": tb["tokens"]})
        assert not torch.allclose(plain, got, **FORWARD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_prefill_and_decode_match_jax(arch):
    """Prefill at cache index 0, then decode at t, against JAX's serve
    step; musicgen takes (B, S, D) then (B, 1, D) frame embeddings.
    pixtral's patches change nothing in either's serve step."""
    jc, tc = _configs(arch)
    tp, jp = _params(tc)
    inputs = _batch(tc, BATCH, SEQ)
    steps = [inputs] + [_batch(tc, BATCH, 1, seed=10 + i)
                        for i in range(DECODE)]
    jstep = jax.jit(jax_lm.make_serve_step(jc))
    tstep = lm.make_serve_step(tc)
    max_len = SEQ + DECODE
    jstate = jax_lm.init_decode_state(jc, BATCH, max_len)
    tstate = lm.init_decode_state(tc, BATCH, max_len)
    bare = lm.init_decode_state(tc, BATCH, max_len)
    for i, batch in enumerate(steps):
        index = 0 if i == 0 else SEQ + i - 1
        if arch == "pixtral-12b" and i == 0:
            batch = dict(batch, patch_embeds=inputs["patch_embeds"])
        jb, tb = _both(batch)
        jl, jstate = jstep(jp, jb, jstate, jnp.asarray(index, jnp.int32))
        tl, tstate = tstep(tp, tb, tstate, index)
        _close(tl, jl, SERVE_TOL)
        jleaves, _ = jax.tree_util.tree_flatten(jstate)
        tleaves, _ = flatten(tstate)
        assert len(tleaves) == len(jleaves)
        for got, want in zip(tleaves, jleaves):
            _close(got, want, SERVE_TOL)
        if arch == "pixtral-12b":
            bl, bare = tstep(tp, {"tokens": tb["tokens"]}, bare, index)
            assert torch.equal(bl, tl)
            if i == 0:
                jbare, _ = jstep(jp, {"tokens": jb["tokens"]},
                                 jax_lm.init_decode_state(jc, BATCH, max_len),
                                 jnp.asarray(0, jnp.int32))
                np.testing.assert_array_equal(np.asarray(jbare),
                                              np.asarray(jl))


# ----------------------------------------------------------------- loss
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch):
    """``lm_loss``, its ce and every parameter's gradient against JAX's
    ``lm_loss`` and ``jax.grad``; pixtral's first 8 labels are masked, so
    changing the tokens' labels there changes nothing."""
    jc, tc = _configs(arch)
    tp, jp = _params(tc)
    batch = _batch(tc, BATCH, SEQ)
    jb, tb = _both(batch)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jax_lm.lm_loss(p, jc, jb), has_aux=True)(jp)
    grads_of = lm._make_grads_fn(tc, TrainConfig())
    tgrads, tloss, tm = grads_of(tp, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(tm["ce"].item(), float(jm["ce"]), **LOSS_TOL)
    got, want = _sorted_paths(tgrads), _sorted_paths(jgrads)
    assert list(got) == list(want)
    for path, g in got.items():
        _close(g, want[path], LOSS_TOL, msg=path)
    if arch == "pixtral-12b":
        npos = tc.num_frontend_positions
        moved = dict(batch, tokens=batch["tokens"].copy())
        # the labels of positions 0..npos-2 (tokens 1..npos-1), under the
        # patches themselves
        moved["tokens"][:, 1:npos] = (moved["tokens"][:, 1:npos] + 1) % \
            tc.vocab_size
        again, _ = lm.lm_loss(tp, tc, _both(moved)[1])
        assert again.item() == lm.lm_loss(tp, tc, tb)[0].item()


def test_short_pixtral_sequence_raises():
    """A sequence shorter than the patch prefix: JAX fails on the shapes,
    the port raises ``ValueError`` naming both lengths."""
    _, tc = _configs("pixtral-12b")
    tp, _ = _params(tc)
    tb = _both(_batch(tc, 1, tc.num_frontend_positions - 1))[1]
    with pytest.raises(ValueError, match="8 patch positions .* 7 tokens"):
        lm.forward(tp, tc, tb)


# ------------------------------------------------------------------ CLIs
@pytest.mark.parametrize("arch", ARCHS)
def test_clis_serve_and_train_on_cpu(arch, tmp_path, capsys):
    """``launch.serve`` and ``launch.train`` with ``--smoke --device
    cpu``, fed zero frame or patch embeddings as the JAX CLIs feed them:
    musicgen's zero frames make every logit 0, so its loss is ln(vocab)
    exactly."""
    served = serve_main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "16",
                         "--tokens", "3"])
    vocab = get_config(arch).smoke().vocab_size
    assert served.tokens.shape == (2, 4)
    assert int(served.tokens.max()) < vocab
    report = train_main(["--arch", arch, "--smoke", "--population", "2",
                         "--steps", "2", "--pbt-interval", "1", "--batch",
                         "2", "--seq-len", "16", "--ckpt-dir",
                         str(tmp_path), "--device", "cpu"])
    assert [s for s, _ in report.evolutions] == [1, 2]
    assert np.isfinite(report.final_loss)
    assert CheckpointManager(tmp_path).latest() == 1
    # the depth cut at full width, and no checkpoint with --ckpt-every 0
    cut = train_main(["--arch", arch, "--smoke", "--num-layers", "1",
                      "--population", "2", "--steps", "2", "--batch", "1",
                      "--seq-len", "16", "--ckpt-every", "0", "--ckpt-dir",
                      str(tmp_path / "cut"), "--device", "cpu"])
    assert cut.trainer.agent.cfg.num_layers == 1
    assert np.isfinite(cut.final_loss)
    assert CheckpointManager(tmp_path / "cut").latest() is None
    if arch == "musicgen-medium":
        np.testing.assert_allclose(report.final_loss, np.log(vocab),
                                   rtol=1e-6)
    if arch == "pixtral-12b":
        with pytest.raises(ValueError, match="patch positions"):
            train_main(["--arch", arch, "--smoke", "--population", "2",
                        "--steps", "1", "--batch", "1", "--seq-len", "4",
                        "--ckpt-dir", str(tmp_path / "short"), "--device",
                        "cpu"])
    assert "ms per decode step" in capsys.readouterr().out
