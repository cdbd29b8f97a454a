"""Model-sharded LM members over an island's model axis, on gloo ranks.

Each case spawns gloo ranks with ``run_ranks`` (``test_torch_islands``):
the ranks share the CPU, and a member's leaves are cut over the model
ranks by the rules of ``repro_torch.models.sharding`` (the tensor
parallelism the JAX package gets from GSPMD). Sharding decides where,
never what, so:

  * ``rwkv6-test`` and a small dense config (2 layers, d_model 64, 4
    heads, 2 kv heads, vocab 256, a qkv bias, tied embeddings) at model 2
    are held against the JAX package's ``islands`` update on
    ``plan_layout(8, 4, preferred_model=2)`` (the layout of
    ``tests/test_lm_population.py``'s model-sharded test, 8 host devices
    in a subprocess): 2 steps, the loss at rtol 2e-5 and every state leaf
    (parameters and Adam moments) at atol 2e-5;
  * a shard that cuts a head (kv 1 at model 2; 4 heads and 2 kv heads at
    model 4 on 4 ranks) and a clip that binds are held against the
    one-rank port update by ``chip_smoke.py``'s LM update rule: the
    parameters at rtol 1e-4, atol 1e-6 where both steps' gradients reach
    1e-6 (a zero-initialised k bias has gradients within rounding of
    zero, whose Adam steps rounding decides), the Adam moments, gradients
    in effect, at rtol 1e-4 and an atol of 5e-5 of the leaf's largest
    value;
  * PBT's exchange across 2 islands of model 2 moves each part bit for
    bit, the rank-0 checkpoint holds whole leaves (the one-rank format),
    and ``restore_elastic`` crosses model 2 -> 1 and 1 -> 2 bit for bit;
  * the train CLI runs ``--model-axis 2`` under ``torch.distributed.run``
    on 2 gloo ranks and a one-rank run resumes its checkpoint.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import HyperSpace, PopulationConfig
from repro_torch.elastic import plan_layout, restore_elastic
from repro_torch.models.sharding import ModelShard
from repro_torch.pop import LMAgent, PopTrainer
from repro_torch.pop.backend import make_update
from repro_torch.tree import copy_into, leaves
from test_torch_islands import run_ranks
from test_torch_islands_cli import _run
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, B, S = 4, 2, 32
TCFG = dict(total_steps=50, warmup_steps=5, lr=1e-3, weight_decay=0.1)
JAX_TOL = dict(rtol=2e-5, atol=2e-5)
# the LM update parity's: rtol 1e-4, atol 1e-6 on the parameters; the
# moments at the gradients' atol of 5e-5 of the leaf's largest value
PORT_TOL = dict(rtol=1e-4, atol=1e-6)
MOMENTS_ATOL_OF_MAX = 5e-5
LM_STEP_GRAD_FLOOR = 1e-6
STEP_GRAD_FLOOR_OF_MAX = 1e-3
DENSE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256, qkv_bias=True,
             tie_embeddings=True)
SPACE = HyperSpace(log_uniform=(("lr_scale", 0.1, 10.0),
                                ("weight_decay", 1e-3, 0.3)),
                   uniform=(("warmup_frac", 0.01, 0.25),))


def _config(name, **kw):
    if name == "rwkv6-test":
        return get_config("rwkv6-test").replace(ssm_chunk=16, **kw)
    return get_config("qwen2-0.5b").smoke().replace(**{**DENSE, **kw})


def _hypers():
    return {"lr_scale": np.linspace(0.5, 2.0, N).astype(np.float32),
            "weight_decay": np.linspace(0.01, 0.2, N).astype(np.float32),
            "warmup_frac": np.linspace(0.05, 0.2, N).astype(np.float32)}


def _tokens(vocab, step):
    return np.random.default_rng(10 + step).integers(
        0, vocab, (N, B, S), dtype=np.int32)


# -------------------------------------------------- the JAX reference
JAX_ISLANDS = """
import pickle, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import TrainConfig, get_config
from repro.elastic import plan_layout
from repro.pop import LMAgent, make_update

out = {}
tcfg = TrainConfig(**%(tcfg)r)
hypers = {k: jnp.asarray(v) for k, v in %(hypers)r.items()}
for name in ("rwkv6-test", "dense"):
    if name == "rwkv6-test":
        cfg = get_config("rwkv6-test").replace(ssm_chunk=16,
                                               use_chunked=False)
    else:
        cfg = get_config("qwen2-0.5b").smoke().replace(**%(dense)r)
    agent = LMAgent(cfg, tcfg)
    layout = plan_layout(len(jax.devices()), %(n)d, preferred_model=2)
    keys = jax.random.split(jax.random.PRNGKey(0), %(n)d)
    state = jax.vmap(agent.init)(keys)
    init = jax.device_get(state)
    state = layout.place(state, model_rules=True)
    update = make_update(agent, "islands", donate=False, mesh=layout.mesh)
    losses = []
    for step in range(2):
        tokens = np.random.default_rng(10 + step).integers(
            0, cfg.vocab_size, (%(n)d, %(b)d, %(s)d), dtype=np.int32)
        state, metrics = update(state, {"tokens": jnp.asarray(tokens)},
                                hypers)
        losses.append(np.asarray(metrics["loss"]))
    out[name] = {"init": init, "final": jax.device_get(state),
                 "losses": losses, "model": layout.model,
                 "islands": layout.islands}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "islands.pkl"
    script = JAX_ISLANDS % dict(tcfg=TCFG, dense=DENSE, n=N, b=B, s=S,
                                hypers={k: v.tolist()
                                        for k, v in _hypers().items()})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _numpy_tree(js):
    """A JAX LMState of numpy arrays as a tree the port's copy_into
    takes (NamedTuples are walked in field order on both sides)."""
    import jax
    return [np.asarray(x) for x in jax.tree.leaves(js)]


def _setup(name, kw):
    """The config and train config of a case: ``kw`` overrides the
    config's fields, its ``"tcfg"`` entry TCFG's."""
    kw = dict(kw)
    tcfg = TrainConfig(**{**TCFG, **kw.pop("tcfg", {})})
    return _config(name, **kw), tcfg


def _ranks_update(rank, world, name, init, hypers, kw):
    """``world`` gloo ranks, one island of model ``world``: this rank's
    parts of the given whole initial state, 2 islands-backend updates.
    Returns the losses, this rank's state leaves, their shard dims and
    the rank's model coordinate."""
    cfg, tcfg = _setup(name, kw)
    agent = LMAgent(cfg, tcfg, device="cpu")
    layout = plan_layout(world, N, preferred_model=world)
    state = agent.population_init(torch.Generator().manual_seed(0), N,
                                  shard=layout.model_shard())
    whole = agent.population_init(torch.Generator().manual_seed(0), N)
    copy_into(whole, init)
    copy_into(state, layout.place(whole, model_rules=True))
    update = make_update(agent, "islands", mesh=layout.mesh)
    h = {k: torch.from_numpy(v) for k, v in hypers.items()}
    losses = []
    for step in range(2):
        batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, step))}
        state, metrics = update(state, batch, h)
        losses.append(metrics["loss"].numpy())
    return {"losses": losses, "state": [x.numpy() for x in leaves(state)],
            "dims": agent.shard_dims(state, layout.model_shard()),
            "coord": layout.model_coord()}


def _part(whole, dim, coord, size):
    if dim is None:
        return whole
    per = whole.shape[dim] // size
    return np.take(whole, range(coord * per, (coord + 1) * per), axis=dim)


def _check_parts(outs, losses, final, world, tol, ref_mu1=None):
    """Each rank's losses and state parts against the whole reference.
    With ``ref_mu1`` (the reference's Adam mu after the first step) the
    LM update rule of ``chip_smoke.py`` holds the parameters: only where
    both steps' reference gradients (from mu: g1 = mu1 / 0.1, g2 = (mu2 -
    0.9 mu1) / 0.1) reach LM_STEP_GRAD_FLOOR, since Adam's step at a
    gradient within rounding of zero is decided by that rounding (ROADMAP
    §3); and the moments, gradients in effect, at ``tol``'s rtol and an
    atol of MOMENTS_ATOL_OF_MAX of the leaf's largest value."""
    for out in outs:
        for got, want in zip(out["losses"], losses):
            np.testing.assert_allclose(got, want, rtol=tol["rtol"])
        assert len(out["state"]) == len(final)
        p = len(final) // 3                 # params, step, mu, nu, step
        part = lambda i: _part(final[i], out["dims"][i], out["coord"],
                               world)
        for i, got in enumerate(out["state"]):
            want, leaf_tol = part(i), dict(tol)
            if ref_mu1 is not None and i < p:
                mu1 = _part(ref_mu1[i], out["dims"][i], out["coord"], world)
                g1, g2 = mu1 / 0.1, (part(p + 1 + i) - 0.9 * mu1) / 0.1
                held = ((np.abs(g1) > LM_STEP_GRAD_FLOOR)
                        & (np.abs(g2) > LM_STEP_GRAD_FLOOR))
                got, want = got[held], want[held]
            elif ref_mu1 is not None and p < i < len(final) - 1:
                leaf_tol["atol"] = max(tol["atol"], MOMENTS_ATOL_OF_MAX
                                       * float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, **leaf_tol)


@pytest.mark.parametrize("name", ["rwkv6-test", "dense"])
def test_model_two_update_matches_jax_islands(tmp_path, jax_reference,
                                               name):
    """2 ranks at model 2 (one island of 4 members) against JAX's islands
    update on 8 devices (4 islands x model 2), from JAX's initial
    state, 2 steps with per-member hypers."""
    ref = jax_reference[name]
    assert (ref["model"], ref["islands"]) == (2, 4)
    init = _numpy_tree(ref["init"])
    outs = run_ranks(_ranks_update, 2, tmp_path, name, init, _hypers(), {})
    assert any(d is not None for d in outs[0]["dims"])
    _check_parts(outs, ref["losses"], _numpy_tree(ref["final"]), 2,
                 JAX_TOL)


def _one_rank(name, kw):
    cfg, tcfg = _setup(name, kw)
    agent = LMAgent(cfg, tcfg, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(0), N)
    init = [x.numpy().copy() for x in leaves(state)]
    update = make_update(agent, "vectorized")
    h = {k: torch.from_numpy(v) for k, v in _hypers().items()}
    losses = []
    for step in range(2):
        state, m = update(state, {"tokens": torch.from_numpy(
            _tokens(cfg.vocab_size, step))}, h)
        losses.append(m["loss"].numpy())
        if step == 0:
            mu1 = [x.numpy().copy() for x in leaves(state.opt_state.mu)]
    return init, losses, [x.numpy() for x in leaves(state)], mu1


@pytest.mark.parametrize("world, kw", [
    (2, {"num_kv_heads": 1, "tcfg": {"max_grad_norm": 0.05}}),
    (4, {}),
], ids=["kv1_model2_clipped", "model4"])
def test_cut_heads_and_clip_match_one_rank(tmp_path, world, kw):
    """Shards that cut heads: kv 1 at model 2 (a rank holds half the kv
    head; the q, k and v projections are gathered and every rank computes
    every head) with a clip norm that binds on every member, and model 4
    on 4 ranks (each rank one q head and half a kv head), against the
    one-rank update of the same members. The clip's square-sums are
    summed over the model ranks, each whole leaf once."""
    init, losses, final, mu1 = _one_rank("dense", kw)
    outs = run_ranks(_ranks_update, world, tmp_path, "dense", init,
                     _hypers(), dict(kw))
    _check_parts(outs, losses, final, world, PORT_TOL, mu1)


def test_clip_norm_counts_whole_leaves_once(tmp_path):
    """``population_adam``'s clip with ``model_square_sums`` over 2 ranks
    (a leaf sharded on its last dimension, and a whole one, the same on
    both) steps as one rank does with whole leaves, the clip binding on
    both members: each whole leaf's square-sum is counted once."""
    want = _clip_rank(0, 1)
    assert (want["scale"] < 0.5).all()
    for r, out in enumerate(run_ranks(_clip_rank, 2, tmp_path)):
        np.testing.assert_allclose(out["scale"], want["scale"], rtol=1e-6)
        np.testing.assert_allclose(out["wide"],
                                   want["wide"][:, :, 3 * r:3 * r + 3],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["norm"], want["norm"], rtol=1e-6,
                                   atol=1e-7)


def _clip_rank(rank, world):
    """One clipped step of 2 members: this rank's columns of ``wide``
    (all of them on one rank) and the whole ``norm``."""
    from repro_torch.models.sharding import ModelShard
    from repro_torch.optim import population_adam
    from repro_torch.optim.pop_adam import model_square_sums
    from repro_torch.tree import flat_copy
    g = torch.Generator().manual_seed(3)
    params = {"norm": torch.randn(2, 5, generator=g),
              "wide": torch.randn(2, 4, 6, generator=g)}
    grads = {k: 10 * torch.randn(v.shape, generator=g)
             for k, v in params.items()}
    reduce, seen = None, {}
    if world > 1:
        for tree in (params, grads):
            tree["wide"] = tree["wide"][:, :, 3 * rank:3 * rank + 3]
        reduce = model_square_sums([False, True], ModelShard(rank, world))
    _, p = flat_copy(params)
    _, gr = flat_copy(grads)

    def sums(s):
        seen["sums"] = s if reduce is None else reduce(s)
        return seen["sums"]
    init, apply = population_adam(1e-2, max_grad_norm=1.0, flat=True,
                                  reduce_square_sums=sums)
    apply(p, gr, init(p))
    norm = torch.sqrt(seen["sums"].sum(1))
    return {"wide": p["wide"].numpy(), "norm": p["norm"].numpy(),
            "scale": (1.0 / (norm + 1e-9)).numpy()}


# ------------------------------------ exchange, checkpoints, the CLI
def _islands_rank(rank, world, ckpt, restore_from):
    """Model 2 over ``world`` ranks (rwkv6-test, 4 members): on 4 ranks (2
    islands) one step, an evolve on fitness [4, 3, 2, 1] (member 3,
    island 1, adopts member 0, island 0) and a blocking checkpoint; or,
    with ``restore_from``, a fresh trainer restored from that
    directory."""
    cfg = _config("rwkv6-test")
    agent = LMAgent(cfg, TrainConfig(**TCFG), device="cpu")
    layout = plan_layout(world, N, preferred_model=2)
    pcfg = PopulationConfig(size=N, backend="islands", pbt_interval=0,
                            hyper_space=SPACE)
    tr = PopTrainer(agent, pcfg, seed=0, layout=layout,
                    checkpoint_dir=restore_from or ckpt)
    if restore_from is not None:
        restore_elastic(tr)
        return {"coord": layout.model_coord(), "rows": tuple(tr.rows),
                "state": [x.numpy().copy() for x in leaves(tr.state)],
                "dims": agent.shard_dims(tr.state, tr.shard)}
    tr.step({"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 0))})
    before = [x.numpy().copy() for x in leaves(tr.state)]
    tr.report_fitness(torch.tensor([4.0, 3.0, 2.0, 1.0]))
    lineage = tr.evolve().tolist()
    tr.save(blocking=True)
    return {"coord": layout.model_coord(), "rows": tuple(tr.rows),
            "before": before, "lineage": lineage,
            "after": [x.numpy().copy() for x in leaves(tr.state)],
            "bytes": tr.strategy.gather.last["bytes"]}


def _npz(directory):
    step = sorted(Path(directory).glob("step_*"))[-1]
    with np.load(step / "arrays.npz") as data:
        return [data[f"leaf_{i}"] for i in range(len(data.files))]


def test_exchange_and_checkpoints_cross_model_widths(tmp_path):
    """4 ranks, 2 islands of model 2: member 3 (ranks 2, 3) adopts member
    0 (ranks 0, 1) part by part, bit for bit, each part moved between the
    ranks of one model coordinate; rank 0's checkpoint holds whole leaves
    in the one-rank format, whose parts are what the ranks hold; it
    restores onto one rank (model 1), and that one's onto 2 ranks at
    model 2, bit for bit."""
    ckpt = tmp_path / "m2"
    outs = run_ranks(_islands_rank, 4, tmp_path, str(ckpt), None)
    for r in range(2):          # parent on rank r, child on rank r + 2
        parent, child = outs[r], outs[r + 2]
        assert parent["coord"] == child["coord"] == r
        assert child["lineage"][3] == 0 and child["bytes"] > 0
        for got, want in zip(child["after"], parent["before"]):
            if got.ndim and got.shape[0] == 2:
                np.testing.assert_array_equal(got[1], want[0])
    saved = _npz(ckpt)
    one = LMAgent(_config("rwkv6-test"), TrainConfig(**TCFG), device="cpu")
    template = one.population_init(torch.Generator().manual_seed(0), N)
    assert [x.shape for x in saved[:len(leaves(template))]] == \
        [tuple(x.shape) for x in leaves(template)]
    # model 2 -> 1: a world of one restores the whole checkpoint
    pcfg = PopulationConfig(size=N, backend="islands", pbt_interval=0,
                            hyper_space=SPACE)
    tr = PopTrainer(one, pcfg, seed=0, checkpoint_dir=ckpt)
    restore_elastic(tr)
    for got, want in zip(leaves(tr.state), saved):
        np.testing.assert_array_equal(got.numpy(), want)
    # the parts each rank held after the evolve are the checkpoint's
    for out in outs:
        lo, hi, _ = out["rows"]
        dims = one.shard_dims(tr.state, ModelShard(out["coord"], 2))
        for got, want, dim in zip(out["after"], saved, dims):
            np.testing.assert_array_equal(
                got, _part(want[lo:hi], dim, out["coord"], 2))
    # model 1 -> 2: the one-rank trainer's checkpoint onto one island of
    # model 2 (2 ranks)
    tr.save(blocking=True)
    back = run_ranks(_islands_rank, 2, tmp_path, None, str(ckpt))
    saved = _npz(ckpt)
    for out in back:
        lo, hi, _ = out["rows"]
        for got, want, dim in zip(out["state"], saved, out["dims"]):
            np.testing.assert_array_equal(
                got, _part(want[lo:hi], dim, out["coord"], 2))


def test_train_cli_model_axis_on_two_ranks(tmp_path, monkeypatch):
    """``--arch rwkv6-test --backend islands --model-axis 2`` on 2 gloo
    ranks trains, evolves and writes a checkpoint holding whole leaves,
    within rounding of the one-rank run's (run in this process, its
    members' gradients recorded): the Adam moments, gradients in effect,
    at rtol 1e-5 and an atol of MOMENTS_ATOL_OF_MAX of the leaf's
    largest; the parameters at rtol 1e-5, atol 1e-6 where every recorded
    gradient of theirs reaches STEP_GRAD_FLOOR_OF_MAX of its leaf's
    largest. Adam's step divides a gradient's rounding by the gradient,
    and the model-2 gradients differ from one rank's by up to 3.2e-5 of a
    leaf's largest (ROADMAP §3); a one-rank run (the model axis halved to
    1, with JAX's warning) resumes the checkpoint at 3 members through
    ``--resize auto``."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import lm as lm_mod
    lm = ["--arch", "rwkv6-test", "--population", "2", "--steps", "4",
          "--pbt-interval", "2", "--batch", "2", "--seq-len", "32",
          "--device", "cpu", "--backend", "islands"]
    two = _run(lm + ["--ckpt-dir", str(tmp_path / "two"), "--model-axis",
                     "2"], 2)
    grads, real = [], lm_mod._make_grads_fn

    def recorded(cfg, tcfg):
        grads_of = real(cfg, tcfg)

        def record(params, batch):
            g, loss, metrics = grads_of(params, batch)
            grads.append([x.detach().numpy().copy() for x in leaves(g)])
            return g, loss, metrics
        return record
    monkeypatch.setattr(lm_mod, "_make_grads_fn", recorded)
    train_main(lm + ["--ckpt-dir", str(tmp_path / "one")])
    assert "model axis 2: each member sharded over 2 ranks" in two
    assert "evolve at step 2" in two and "evolve at step 4" in two
    one, got = _npz(tmp_path / "one"), _npz(tmp_path / "two")
    p = len(grads[0])                  # params, step, mu, nu, step
    assert len(grads) == 2 * 4 and len(one) == len(got) == 3 * p + 2
    held_share = []
    for i, (a, b) in enumerate(zip(one, got)):
        assert a.shape == b.shape
        if i < p:
            held = np.ones(a.shape[1:], bool)
            for g in grads:
                held &= (np.abs(g[i])
                         >= STEP_GRAD_FLOOR_OF_MAX * np.abs(g[i]).max())
            held_share.append(held.mean())
            a, b = a[:, held], b[:, held]
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            atol = (max(1e-6, MOMENTS_ATOL_OF_MAX * float(np.abs(a).max()))
                    if p < i < 3 * p + 1 else 0)
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol)
    assert np.mean(held_share) > 0.5
    resumed = _run(lm + ["--ckpt-dir", str(tmp_path / "two"), "--steps",
                         "6", "--model-axis", "2", "--population", "3",
                         "--resize", "auto"], 0)
    assert "elastic resume from step 3: population 2 -> 3" in resumed
    assert "step 6: loss" in resumed
