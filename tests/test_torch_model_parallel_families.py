"""Model-sharded members of the MoE, MLA and Mamba2 families over an
island's model axis, on gloo ranks.

The cases follow ``tests/test_torch_model_parallel.py`` (its ``run_ranks``
ranks and ``_check_parts`` rules): a member's leaves are cut over the
model ranks by the rules of ``repro_torch.models.sharding``, and sharding
decides where, never what, so:

  * the smoke configs of ``qwen3-moe-30b-a3b`` (experts over the model
    axis, GQA), ``deepseek-v2-lite-16b`` (MLA, shared experts, a dense
    first layer) and ``zamba2-7b`` (cut to 5 layers: a super-block of 4
    Mamba2 layers and a 1-layer tail, each under the shared attention
    block) at model 2 are held against the JAX package's ``islands``
    update on ``plan_layout(8, 4, preferred_model=2)`` (8 host devices in
    one subprocess for the three): 2 steps from JAX's initial state with
    per-member hypers, the loss at rtol 2e-5 and every state leaf
    (``router.w``, ``w_kr``, ``kv_norm``, ``a_log``, ``dt_bias``,
    ``d_skip`` and the norms among them) at rtol 2e-5, atol 2e-5, the
    parameters by the LM update rule of ``chip_smoke.py`` (held where
    both steps' reference gradients reach 1e-6: an embedding row whose
    gradient is about 1e-9 takes an Adam step of either sign, as the
    rounding of each package decides, in the one-rank port as well);
  * model 4 on 4 ranks (one expert a rank; zamba2 at d_model 96, whose 6
    SSD heads do not divide over 4 ranks and whose ``in_proj`` of 422
    columns stays whole) against the one-rank port update by
    ``chip_smoke.py``'s LM update rule;
  * a rank's dispatch and combine columns equal those of the whole
    tensors bit for bit;
  * zamba2 cut below one super-block (phase 56's depth on the card) has
    an empty segment, whose leaves take empty gradients, the rest JAX's;
  * PBT's exchange across 2 islands of model 2 and ``restore_elastic``
    across model 2 -> 1 -> 2 are bit for bit for an MoE config;
  * the train CLI runs ``--arch qwen3-moe-30b-a3b --smoke --backend
    islands --model-axis 2`` under ``torch.distributed.run`` on 2 gloo
    ranks, within rounding of the one-rank run.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import PopulationConfig
from repro_torch.elastic import plan_layout, restore_elastic
from repro_torch.models import lm
from repro_torch.models.sharding import ModelShard
from repro_torch.nn.moe import _dispatch_combine
from repro_torch.pop import LMAgent, PopTrainer
from repro_torch.pop.backend import make_update
from repro_torch.tree import copy_into, leaves
from test_torch_islands import run_ranks
from test_torch_islands_cli import _run
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401
from test_torch_model_parallel import (B, JAX_TOL, N, PORT_TOL, REPO, S,
                                       SPACE, TCFG, _check_parts, _hypers,
                                       _npz, _numpy_tree, _part, _tokens)

torch.set_num_threads(1)

ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "zamba2-7b")
# each arch's smoke config and its cut; "zamba2-d96": 6 SSD heads of 32
CUTS = {"zamba2-7b": dict(num_layers=5),
        "zamba2-d96": dict(num_layers=5, d_model=96)}


def _config(name, **kw):
    arch = "zamba2-7b" if name.startswith("zamba2") else name
    return get_config(arch).smoke().replace(**{**CUTS.get(name, {}), **kw})


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
for name in %(archs)r:
    cfg = get_config(name).smoke().replace(**%(cuts)r.get(name, {}))
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
        if step == 0:
            mu1 = jax.device_get(state.opt_state.mu)
    out[name] = {"init": init, "final": jax.device_get(state),
                 "mu1": mu1, "losses": losses, "model": layout.model,
                 "islands": layout.islands}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "families.pkl"
    script = JAX_ISLANDS % dict(tcfg=TCFG, archs=ARCHS, cuts=CUTS, n=N, b=B,
                                s=S, hypers={k: v.tolist()
                                             for k, v in _hypers().items()})
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", script, str(path)], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _ranks_update(rank, world, name, init, kw):
    """``world`` gloo ranks, one island of model ``world``: this rank's
    parts of the given whole initial state, 2 islands-backend updates
    with per-member hypers. Returns the losses, this rank's state leaves,
    their shard dims and the rank's model coordinate."""
    cfg = _config(name, **kw)
    agent = LMAgent(cfg, TrainConfig(**TCFG), device="cpu")
    layout = plan_layout(world, N, preferred_model=world)
    state = agent.population_init(torch.Generator().manual_seed(0), N,
                                  shard=layout.model_shard())
    whole = agent.population_init(torch.Generator().manual_seed(0), N)
    copy_into(whole, init)
    copy_into(state, layout.place(whole, model_rules=True))
    update = make_update(agent, "islands", mesh=layout.mesh)
    h = {k: torch.from_numpy(v) for k, v in _hypers().items()}
    losses = []
    for step in range(2):
        batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, step))}
        state, metrics = update(state, batch, h)
        losses.append(metrics["loss"].numpy())
    return {"losses": losses, "state": [x.numpy() for x in leaves(state)],
            "dims": agent.shard_dims(state, layout.model_shard()),
            "coord": layout.model_coord()}


@pytest.mark.parametrize("name", ARCHS)
def test_model_two_update_matches_jax_islands(tmp_path, jax_reference,
                                               name):
    """2 ranks at model 2 (one island of 4 members) against JAX's islands
    update on 8 devices (4 islands x model 2), from JAX's initial state,
    2 steps with per-member hypers: the experts, MLA's latent and heads
    and Mamba2's projections cut, every whole leaf's gradient whole."""
    ref = jax_reference[name]
    assert (ref["model"], ref["islands"]) == (2, 4)
    outs = run_ranks(_ranks_update, 2, tmp_path, name,
                     _numpy_tree(ref["init"]), {})
    cut = {"qwen3-moe-30b-a3b": "experts.w_gate",
           "deepseek-v2-lite-16b": "attn.w_dkv",
           "zamba2-7b": "mamba.in_proj"}[name]
    assert any(d is not None for p, d in
               lm.shard_table(_config(name), 2).items() if cut in p)
    _check_parts(outs, ref["losses"], _numpy_tree(ref["final"]), 2,
                 JAX_TOL, _numpy_tree(ref["mu1"]))


def _one_rank(name, kw):
    cfg = _config(name, **kw)
    agent = LMAgent(cfg, TrainConfig(**TCFG), device="cpu")
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


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b",
                                  "zamba2-d96"])
def test_model_four_matches_one_rank(tmp_path, name):
    """Model 4 on 4 ranks against the one-rank update of the same members:
    one of the 4 experts a rank, one MLA head a rank, and zamba2 at
    d_model 96, whose 6 SSD heads do not divide over the ranks (every
    rank computes every head from the gathered projection and takes its
    rows of ``out_proj``) and whose ``in_proj`` stays whole."""
    init, losses, final, mu1 = _one_rank(name, {})
    outs = run_ranks(_ranks_update, 4, tmp_path, name, init, {})
    _check_parts(outs, losses, final, 4, PORT_TOL, mu1)


def test_rank_dispatch_and_combine_are_the_whole_columns():
    """A rank's dispatch and combine tensors, built for its experts'
    columns only, equal those columns of the whole ones bit for bit, at a
    capacity that drops tokens, at model 2 and 4."""
    g = torch.Generator().manual_seed(5)
    e, k = 8, 2
    logits = torch.randn(2, 3, 16, e, generator=g)
    gates, idx = torch.sort(torch.softmax(logits, -1), dim=-1,
                            descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    combine, dispatch = _dispatch_combine(gates, idx, e, 3)
    assert (combine.sum(-1) > 0).sum() < idx.numel()    # some dropped
    for world in (2, 4):
        for coord in range(world):
            lo, hi = ModelShard(coord, world).bounds(e)
            c, d = _dispatch_combine(gates, idx, e, 3, experts=(lo, hi))
            assert torch.equal(c, combine[..., lo:hi, :])
            assert torch.equal(d, dispatch[..., lo:hi, :])


def test_zamba2_below_one_super_block_takes_gradients():
    """zamba2-7b cut to 2 layers, fewer than one super-block (as phase 56
    of ``chip_smoke.py`` cuts it at full width): its main segment stacks
    no layer, whose empty leaves take empty gradients, and every other
    leaf's gradient equals ``jax.grad`` of the JAX package's
    ``lm_loss``."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as jax_lm
    from test_torch_lm_train import (GRAD_ATOL_OF_MAX, GRAD_RTOL, SEQ,
                                     _configs, _params, _sorted_paths)
    jc, tc = _configs("zamba2-7b", num_layers=2)
    assert [seg.count for seg in lm.layout(tc)] == [0, 1]
    tp, jp = _params(tc)
    tokens = np.random.default_rng(2).integers(0, tc.vocab_size, (2, SEQ),
                                               dtype=np.int32)
    want = _sorted_paths(jax.grad(lambda p: jax_lm.lm_loss(
        p, jc, {"tokens": jnp.asarray(tokens)})[0])(jp))
    got, _, _ = lm._make_grads_fn(tc, TrainConfig())(
        tp, {"tokens": torch.from_numpy(tokens)})
    got = _sorted_paths(got)
    assert list(got) == list(want)
    assert any(g.numel() == 0 for g in got.values())
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        if w.size:
            np.testing.assert_allclose(
                g.numpy(), w, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_OF_MAX * np.abs(w).max(), err_msg=path)


# ------------------------------------ exchange, checkpoints, the CLI
MOE = "qwen3-moe-30b-a3b"


def _islands_rank(rank, world, ckpt, restore_from):
    """Model 2 over ``world`` ranks (the MoE smoke config, 4 members): on 4
    ranks (2 islands) one step, an evolve on fitness [4, 3, 2, 1] (member
    3, island 1, adopts member 0, island 0) and a blocking checkpoint; or,
    with ``restore_from``, a fresh trainer restored from that
    directory."""
    cfg = _config(MOE)
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
            "dims": agent.shard_dims(tr.state, tr.shard),
            "bytes": tr.strategy.gather.last["bytes"]}


def test_moe_exchange_and_checkpoints_cross_model_widths(tmp_path):
    """4 ranks, 2 islands of model 2 of the MoE config: member 3 adopts
    member 0 part by part, bit for bit (each rank's experts moved to the
    rank of its model coordinate); rank 0's checkpoint holds whole leaves,
    whose parts are what the ranks hold; it restores onto one rank (model
    1), and that one's onto 2 ranks at model 2, bit for bit."""
    ckpt = tmp_path / "m2"
    outs = run_ranks(_islands_rank, 4, tmp_path, str(ckpt), None)
    experts = [i for i, d in enumerate(outs[0]["dims"]) if d is not None]
    assert experts
    for r in range(2):          # parent on rank r, child on rank r + 2
        parent, child = outs[r], outs[r + 2]
        assert parent["coord"] == child["coord"] == r
        assert child["lineage"][3] == 0 and child["bytes"] > 0
        for got, want in zip(child["after"], parent["before"]):
            if got.ndim and got.shape[0] == 2:
                np.testing.assert_array_equal(got[1], want[0])
    saved = _npz(ckpt)
    one = LMAgent(_config(MOE), TrainConfig(**TCFG), device="cpu")
    pcfg = PopulationConfig(size=N, backend="islands", pbt_interval=0,
                            hyper_space=SPACE)
    tr = PopTrainer(one, pcfg, seed=0, checkpoint_dir=ckpt)
    restore_elastic(tr)
    for got, want in zip(leaves(tr.state), saved):
        np.testing.assert_array_equal(got.numpy(), want)
    for out in outs:
        lo, hi, _ = out["rows"]
        for got, want, dim in zip(out["after"], saved, out["dims"]):
            np.testing.assert_array_equal(
                got, _part(want[lo:hi], dim, out["coord"], 2))
    tr.save(blocking=True)
    back = run_ranks(_islands_rank, 2, tmp_path, None, str(ckpt))
    saved = _npz(ckpt)
    for out in back:
        lo, hi, _ = out["rows"]
        for got, want, dim in zip(out["state"], saved, out["dims"]):
            np.testing.assert_array_equal(
                got, _part(want[lo:hi], dim, out["coord"], 2))


def test_train_cli_moe_model_axis_on_two_ranks(tmp_path):
    """``--arch qwen3-moe-30b-a3b --smoke --backend islands --model-axis
    2`` on 2 gloo ranks trains and evolves, and its checkpoint (whole
    leaves) is within rounding of the one-rank run's."""
    lm = ["--arch", MOE, "--smoke", "--population", "2", "--steps", "2",
          "--pbt-interval", "2", "--batch", "2", "--seq-len", "32",
          "--device", "cpu", "--backend", "islands"]
    two = _run(lm + ["--ckpt-dir", str(tmp_path / "two"), "--model-axis",
                     "2"], 2)
    one = _run(lm + ["--ckpt-dir", str(tmp_path / "one")], 0)
    assert "model axis 2: each member sharded over 2 ranks" in two
    assert "evolve at step 2" in two and "evolve at step 2" in one
    for a, b in zip(_npz(tmp_path / "one"), _npz(tmp_path / "two")):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
