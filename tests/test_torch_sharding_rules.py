"""``repro_torch.models.sharding`` against ``repro.models.sharding``, on
shapes only.

Every leaf of every registered config (the JAX package's
``jax.eval_shape`` of ``repro.models.lm.init_params``, beside the port's
``lm.param_shapes`` on the ``meta`` device) gets the JAX package's spec
from the port's ``spec_for``, at model 2 and 4, under ``population_mode``
and outside it, on the islands mesh ``("pop", "data", "model")`` and on a
``("pod", "data", "model")`` one (the JAX side handed a stand-in mesh of
``axis_names`` and ``shape``). Then the quirks by name, ``batch_spec``,
the placement and ``relayout`` by the rules, what a model axis above 1
still refuses, and ``TrainConfig.grad_compression``.
"""
from contextlib import nullcontext
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.models import sharding as jax_sharding
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.registry import list_configs
from repro_torch.elastic import plan_layout, relayout
from repro_torch.models import lm, sharding
from repro_torch.models.sharding import MeshShape, ModelShard
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)


def _meshes(kind, model):
    names = (("pop", "data", "model") if kind == "islands"
             else ("pod", "data", "model"))
    sizes = (2, 2, model)
    jax_mesh = SimpleNamespace(axis_names=names, shape=dict(zip(names,
                                                                sizes)))
    return jax_mesh, MeshShape(names, sizes)


def _jax_paths(cfg):
    shapes = jax.eval_shape(lambda k: jax_lm.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return [(jax_sharding._path_str(p), tuple(x.shape)) for p, x in flat]


@pytest.mark.parametrize("kind, model, population", [
    ("islands", 2, True), ("islands", 4, True), ("islands", 2, False),
    ("pod", 4, False)], ids=["model2-population", "model4-population",
                             "model2-fsdp", "pod-model4-fsdp"])
def test_specs_match_jax_on_every_leaf(kind, model, population):
    jax_mesh, mesh = _meshes(kind, model)
    for arch in list_configs():
        want = _jax_paths(jax_get_config(arch))
        shapes = lm.param_shapes(get_config(arch))
        got = list(zip(sharding.tree_paths(shapes),
                       [tuple(x.shape) for x in leaves(shapes)]))
        assert got == want, arch           # the same tree, paths, shapes
        with (sharding.population_mode() if population else
              nullcontext()), (jax_sharding.population_mode() if population
                            else nullcontext()):
            for path, shape in want:
                assert sharding.spec_for(path, shape, mesh) == tuple(
                    jax_sharding.spec_for(path, shape, jax_mesh)), \
                    (arch, path, shape)
            specs = sharding.param_specs(shapes, mesh)
            for path, shape in got:
                assert _at(specs, path) == sharding.spec_for(path, shape,
                                                             mesh)


def _at(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def test_the_rules_quirks_by_name():
    """The stacked ``wq.b`` is sharded on its last dimension, the
    unstacked ``shared_attn`` bias stays whole; RWKV6's ``channel_mix.wv``
    is sharded on its output; ``bonus``, ``decay_base``, ``ln_x`` and the
    norms have no rule; an axis that does not divide its dimension is
    dropped."""
    mesh = MeshShape(("pop", "data", "model"), (1, 1, 2))
    with sharding.population_mode():
        spec = lambda path, shape: sharding.spec_for(path, shape, mesh)
        assert spec("segments.dense.attn.wq.b", (24, 896)) == (None,
                                                                "model")
        assert spec("shared_attn.attn.wq.b", (4096,)) == (None,)
        assert spec("segments.rwkv.channel_mix.wv.w", (24, 7168, 2048)) \
            == (None, None, "model")
        for path in ("segments.rwkv.time_mix.bonus",
                     "segments.rwkv.time_mix.decay_base",
                     "segments.rwkv.time_mix.ln_x.scale",
                     "segments.dense.attn_norm.scale", "final_norm.scale"):
            assert spec(path, (24, 32, 64)) == ()
        assert spec("segments.dense.attn.wk.w", (2, 896, 127)) == (
            None, None, None)
    assert sharding.spec_for("lm_head.w", (64, 256), mesh) == (
        "data", "model")
    tables = {n: lm.shard_table(get_config(n), 2)
              for n in ("qwen2-0.5b", "rwkv6-1.6b")}
    assert tables["qwen2-0.5b"]["embed.embedding"] == 0
    assert tables["qwen2-0.5b"]["segments.dense.attn.wo.w"] == 1
    assert tables["rwkv6-1.6b"]["segments.rwkv.channel_mix.wv.w"] == 2


def test_batch_spec_and_fsdp_axes_match_jax():
    for kind in ("islands", "pod"):
        jax_mesh, mesh = _meshes(kind, 2)
        assert sharding.fsdp_axes(mesh) == jax_sharding.fsdp_axes(jax_mesh)
        for shape in ((8, 32), (3, 32, 4), (4,)):
            assert sharding.batch_spec(shape, mesh) == tuple(
                jax_sharding.batch_spec(shape, jax_mesh))


def test_place_and_relayout_cut_by_the_rules():
    """``IslandLayout.place(model_rules=True)`` cuts each member leaf of a
    population tree along the dimension JAX's rule names (under
    ``population_mode``), and ``relayout`` cuts a whole member's host tree
    along every axis of its spec (the "F" axes too, outside
    ``population_mode``); each part is its own contiguous tensor, and the
    parts put together are the whole."""
    cfg = get_config("rwkv6-test")
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    stacked = {"params": {k: torch.stack([v, v + 1]) for k, v in
                          _flat_items(params)}}
    lay = plan_layout(2, 2, preferred_model=2)
    parts = [lay.place(stacked, rank=r, model_rules=True) for r in (0, 1)]
    jax_mesh = SimpleNamespace(axis_names=("pop", "data", "model"),
                               shape={"pop": 1, "data": 1, "model": 2})
    for path, whole in stacked["params"].items():
        with jax_sharding.population_mode():
            spec = tuple(jax_sharding.spec_for(path, whole.shape[1:],
                                               jax_mesh))
        dim = next((d + 1 for d, a in enumerate(spec) if a == "model"),
                   None)
        got = [p["params"][path] for p in parts]
        assert all(g.is_contiguous() for g in got)
        if dim is None:
            assert all(torch.equal(g, whole) for g in got), path
        else:
            assert torch.equal(torch.cat(got, dim), whole), path
            assert got[0].shape[dim] * 2 == whole.shape[dim]
    mesh = MeshShape(("data", "model"), (2, 2))
    cut = {(d, m): relayout(params, mesh, coords={"data": d, "model": m})
           for d in range(2) for m in range(2)}
    w = params["lm_head"]["w"]                        # ("data", "model")
    assert torch.equal(torch.cat([torch.cat(
        [cut[(d, m)]["lm_head"]["w"] for m in range(2)], 1)
        for d in range(2)], 0), w)
    bonus = params["segments"]["rwkv"]["time_mix"]["bonus"]
    assert torch.equal(cut[(1, 1)]["segments"]["rwkv"]["time_mix"]["bonus"],
                       bonus)


def _flat_items(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _flat_items(tree[k], path)
        else:
            yield path, tree[k]


def test_constrain_cuts_only_inside_a_model_parallel_context():
    """Outside a context ``constrain`` and ``constrain_tree`` return their
    input; inside one (a shard with no group: no gradient asked) they cut
    this rank's part by the spec and by the rules."""
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert sharding.constrain(x, None, None, "M") is x
    w = {"wq": {"w": torch.arange(32.0).reshape(4, 8)}}
    assert sharding.constrain_tree(w) is w
    with sharding.model_parallel(ModelShard(1, 2)):
        assert torch.equal(sharding.constrain(x, None, None, "M"),
                           x[..., 2:])
        assert torch.equal(sharding.constrain(x, None, "M", None), x)
        assert torch.equal(sharding.constrain_tree(w)["wq"]["w"],
                           w["wq"]["w"][:, 4:])
    with sharding.model_parallel(ModelShard(0, 1)):
        assert sharding.active() is None


def test_families_without_a_sharded_forward_are_refused_by_name(
        monkeypatch):
    """What a model axis above 1 still refuses, by name, before any group
    is joined: a decode state (serving a model-sharded member) and
    ``--model-axis`` beside another backend than islands. Every family
    now has a sharded forward: the MoE, MLA and Mamba2 configs pass the
    pre-group check as the dense attention and RWKV6 ones do, under PBT
    and under CEM, which now runs over model-sharded members (its run
    stops only where the group is joined, for want of a ``RANK``)."""
    from repro_torch.launch.train import _check_layout
    from repro_torch.launch.train import main as train_main
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        train_main(["--arch", "rwkv6-test", "--population", "2",
                    "--ckpt-dir", "unused", "--device", "cpu", "--backend",
                    "islands", "--model-axis", "2", "--strategy", "cem"])
    with pytest.raises(ValueError, match="taken by --backend islands only"):
        train_main(["--arch", "qwen3-moe-30b-a3b", "--smoke",
                    "--population", "2", "--ckpt-dir", "unused", "--device",
                    "cpu", "--backend", "sharded", "--model-axis", "2"])
    cfg = get_config("zamba2-7b").smoke()
    with sharding.model_parallel(ModelShard(0, 2)), pytest.raises(
            NotImplementedError, match="a decode state over a model axis"):
        lm.forward(lm.param_shapes(cfg), cfg,
                   {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                   state={}, cache_index=0)
    for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "zamba2-7b",
                 "qwen2-0.5b", "rwkv6-1.6b"):
        for strategy in ("pbt", "cem"):
            args = SimpleNamespace(devices=0, model_axis=2,
                                   backend="islands", population=2,
                                   arch=arch, strategy=strategy,
                                   fused_epoch=False, policy_lag=None)
            _check_layout(args)
            assert args.layout.model == 2 and args.layout.islands == 1


def test_grad_compression_field_matches_jax():
    """``TrainConfig.grad_compression``: the JAX package's default, and
    the two reductions ``optim.dp.make_dp_update`` selects by it (another
    value is refused)."""
    from repro_torch.optim.dp import make_dp_update
    assert TrainConfig().grad_compression == \
        JaxTrainConfig().grad_compression == "none"
    for choice in ("none", "int8"):
        cfg = TrainConfig(grad_compression=choice)
        assert JaxTrainConfig(grad_compression=choice).grad_compression \
            == cfg.grad_compression
        assert callable(make_dp_update(None, None, compression=cfg))
    with pytest.raises(ValueError, match="unknown compression 'fp8'"):
        make_dp_update(None, None,
                       compression=TrainConfig(grad_compression="fp8"))
