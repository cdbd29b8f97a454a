"""The dry run: every (arch x input shape x mesh) cell reckoned without a
card (``repro.launch.dryrun``).

The JAX package lowers and compiles each cell for 256 (512) fake CPU
devices and reads the compiled artifact. The port has no compiler to ask,
so it runs one rank's pass on the ``meta`` device (shapes and dtypes,
nothing allocated, no kernel built or launched) under
:class:`repro_torch.launch.hlo_analysis.OpCounter`. It needs no process
group and no card, and never runs a real pass.

Meshes are JAX's 16 x 16 (``data``, ``model``) and 2 x 16 x 16 (``pod``,
``data``, ``model``), as virtual shapes (:class:`~repro_torch.models.
sharding.MeshShape`); ``build_cell(..., mesh=)`` takes a smaller one.
``make_production_mesh`` is not used: it wants a real world of 256 ranks.

One pass, for one rank. Ranks are symmetric: the rules cut every sharded
dimension evenly (an axis that does not divide stays whole), so every
rank holds parts of the same shapes and runs the same ops on them; the
pass is rank 0's (model coordinate 0, whose collectives are recorded over
a :class:`~repro_torch.core.distributed.VirtualGroup` of the axis's size).
The only asymmetry is which positions a sequence-cut cache holds, which
changes no shape.

  * **parameters** are ``lm.param_shapes`` (the counterpart of
    ``jax.eval_shape``): nothing is drawn. A train cell's are float32
    masters, as JAX's; a serve cell's (prefill, decode) the compute copy
    ``cast_params`` gives, which the port's serve step takes (JAX casts
    inside its step).
  * **train**: forward, backward and Adam for one member
    (``lm.make_train_step``), the leaves cut by the F and M rules
    (``param_specs``). The tensor-parallel half (M) is the forward the
    port executes; FSDP's data parts (F) are reckoned by rule, not
    executed: an all-gather of each F-sharded leaf at each use (again in
    the backward under remat) and a reduce-scatter of its gradient, both
    recorded as collectives. The batch is cut over ``("pod", "data")``
    where it divides (``batch_spec``).
  * **prefill**: the forward, F leaves gathered once.
  * **decode**: the serve step with a decode state at ``shape.seq_len``,
    cut over the model axis by ``models.sharding.decode_state_dim`` and
    its batch over ``("pod", "data")`` where it divides (JAX's
    ``_decode_state_shardings``).
  * **population** (``--population N``): the LM population update of
    ``lm.make_population_update`` over this rank's rows (N over
    ``("pod", "data")``) and model parts, in population mode (TP only),
    each member's share of the shape's tokens; ``pop_adam`` counted
    through its meta route. JAX's ``build_population_cell``.

``info`` has the keys of JAX's. ``bytes_per_device``: ``arguments`` (the
rank's parameters, optimizer or decode state and batch, at their final
cut), ``outputs`` (what the step returns, the updated state included),
``aliased`` (the in-place update's: parameters and optimizer
state of a train cell, the decode state of a decode cell, as JAX donates
them) and ``temps`` (the peak of live ``meta`` storages the pass
allocated, a storage counted once). ``compile_s`` holds the pass's
seconds: there is no compile.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --both-meshes --out cells.json
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch

from repro_torch.configs import (LM_SHAPES, TrainConfig, applicable_shapes,
                                 get_config, list_configs)
from repro_torch.core.distributed import VirtualGroup
from repro_torch.launch.hlo_analysis import (OpCounter, nbytes,
                                             roofline_terms, top_collectives)
from repro_torch.models import lm as lm_mod
from repro_torch.models.sharding import (MeshShape, ModelShard, batch_spec,
                                         fsdp_axes, local_tree, member_dims,
                                         model_parallel, param_specs,
                                         population_mode, tree_paths)
from repro_torch.tree import flat_empty, leaves, tree_map

SINGLE_POD = MeshShape(("data", "model"), (16, 16))
MULTI_POD = MeshShape(("pod", "data", "model"), (2, 16, 16))


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """JAX's production grid as a virtual shape."""
    return MULTI_POD if multi_pod else SINGLE_POD


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    names = tuple(mesh.mesh_dim_names)
    return math.prod(mesh.shape[names.index(a)] for a in axes)


def _cut_shape(shape, spec, mesh):
    """A leaf's per-device shape under ``spec`` (an axis that does not
    divide was already dropped by the rules; ``()``: whole)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // _size(mesh, ax) for d, ax in zip(shape, spec))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _model_shard(mesh):
    m = _size(mesh, "model") if "model" in mesh.mesh_dim_names else 1
    return ModelShard(0, m, VirtualGroup("model", m)) if m > 1 else None


def _tp_params(params, shard):
    """The parameters cut over the model axis only (what the executed
    tensor-parallel pass holds)."""
    if shard is None:
        return params
    return local_tree(params, member_dims(params, shard, lead=0), shard)


def _fsdp_leaves(params, mesh, shard):
    """For every leaf the rules cut over the FSDP axes: its path, its
    bytes in the tensor-parallel pass (the all-gather's output) and its
    bytes at its final cut (the reduce-scatter's)."""
    out = []
    flat = leaves(params)
    specs = _spec_leaves(param_specs(params, mesh))
    tp = leaves(_tp_params(params, shard))
    dp = fsdp_axes(mesh)
    for path, x, t, spec in zip(tree_paths(params), flat, tp, specs):
        if dp is None or not any(ax is not None and ax != "model"
                                 for ax in spec):
            continue
        out.append((path, nbytes(t), math.prod(_cut_shape(
            x.shape, spec, mesh)) * x.element_size()))
    return out


def _spec_leaves(spec_tree):
    """The spec tuples of a :func:`param_specs` tree, in flatten order."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            out.append(t)
    walk(spec_tree)
    return out


def _arg_bytes(params, mesh) -> int:
    specs = _spec_leaves(param_specs(params, mesh))
    return sum(math.prod(_cut_shape(x.shape, s, mesh)) * x.element_size()
               for x, s in zip(leaves(params), specs))


def _batch(cfg, shape, mesh):
    """The rank's part of the cell's inputs (batch over the data axes
    where it divides)."""
    whole = lm_mod.input_specs(cfg, shape)
    return {k: _meta(_cut_shape(v.shape, batch_spec(v.shape, mesh), mesh),
                     v.dtype) for k, v in whole.items()}


def _decode_state(cfg, shape, mesh, shard):
    """The rank's part of the decode state at ``shape.seq_len``: the model
    axis by ``decode_state_dim``, the batch dimension over the data axes
    where it divides (JAX's rule)."""
    b, s = shape.global_batch, shape.seq_len
    whole = lm_mod.decode_state_shapes(cfg, b, s)
    local = lm_mod.decode_state_shapes(cfg, b, s, shard=shard)
    dp = fsdp_axes(mesh)
    data = _size(mesh, dp)

    def walk(w, loc):
        if isinstance(w, dict):
            return {k: walk(w[k], loc[k]) for k in w}
        (wshape, dtype), (lshape, _) = w, loc
        lshape = list(lshape)
        for i, d in enumerate(wshape):
            if i and d == b and b > 1 and d % data == 0:
                lshape[i] = d // data
                break
        return _meta(tuple(lshape), dtype)
    return walk(whole, local)


def _info(cfg, shape_name, mesh, counter, seconds, arguments, outputs,
          aliased, population=None):
    a = counter.analysis()
    info = {"arch": cfg.name, "shape": shape_name,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "num_devices": math.prod(mesh.shape),
            "compile_s": round(seconds, 1),
            "bytes_per_device": {
                "arguments": int(arguments), "outputs": int(outputs),
                "temps": int(a["peak_bytes"]),
                "aliased": int(aliased)},
            "xla_cost_analysis_flops": None}
    if population is not None:
        info["population"] = population
    return info


def build_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               cfg_override=None, mesh=None):
    """Run one cell's pass on ``meta`` tensors. Returns ``(counter,
    info)``: the :class:`OpCounter` that saw the pass, and JAX's ``info``
    keys."""
    cfg = cfg_override or get_config(arch)
    shape = LM_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        raise ValueError(f"{arch} is pure full-attention; long_500k skipped "
                         f"by design (DESIGN.md §Arch-applicability)")
    mesh = mesh or production_mesh(multi_pod)
    shard = _model_shard(mesh)
    master = lm_mod.param_shapes(cfg)
    batch = _batch(cfg, shape, mesh)
    batch_bytes = sum(nbytes(t) for t in batch.values())
    fsdp = _fsdp_leaves(master, mesh, shard)
    t0 = time.perf_counter()
    if shape.kind == "train":
        tcfg = TrainConfig()
        params = _tp_params(master, shard)
        opt_init, train_step = lm_mod.make_train_step(cfg, tcfg)
        opt = opt_init(params)
        step = _meta((), torch.int32)
        counter = OpCounter((params, opt, batch))
        with counter, model_parallel(shard):
            new_params, new_opt, metrics = train_step(params, opt, batch,
                                                      step)
        uses = 2 if cfg.remat else 1
        for path, gathered, part in fsdp:
            for _ in range(uses):
                counter.record_collective("all-gather", gathered,
                                          f"fsdp:{path}")
            counter.record_collective("reduce-scatter", part,
                                      f"fsdp:{path}")
        p_bytes = _arg_bytes(master, mesh)
        opt_bytes = 2 * p_bytes + 4                    # mu, nu, step
        arguments = p_bytes + opt_bytes + batch_bytes + 4
        aliased = p_bytes + opt_bytes
        outputs = aliased + sum(nbytes(t) for t in leaves(metrics))
    else:
        cast = lm_mod.cast_params(master, cfg)
        params = _tp_params(cast, shard)
        p_bytes = _arg_bytes(cast, mesh)
        if shape.kind == "prefill":
            state, index, state_bytes = None, None, 0
        else:
            state = _decode_state(cfg, shape, mesh, shard)
            state_bytes = sum(nbytes(t) for t in leaves(state))
            index = shape.seq_len - 1
        counter = OpCounter((params, batch, state))
        with counter:
            logits, _ = lm_mod.make_serve_step(cfg, shard)(
                params, batch, state, index)
        for path, gathered, _ in fsdp:
            counter.record_collective("all-gather", gathered,
                                      f"fsdp:{path}")
        # the int32 cache index, where an attention cache reads it (XLA
        # prunes an argument its step never reads)
        reads_index = state is not None and (
            cfg.block_type != "rwkv6" or cfg.shared_attn_every > 0)
        arguments = p_bytes + batch_bytes + state_bytes + (
            4 if reads_index else 0)
        aliased = state_bytes
        outputs = aliased + nbytes(logits)
    seconds = time.perf_counter() - t0
    return counter, _info(cfg, shape_name, mesh, counter, seconds,
                          arguments, outputs, aliased)


def build_population_cell(arch: str, shape_name: str, n: int, *,
                          multi_pod: bool = False, mesh=None,
                          cfg_override=None):
    """The paper's protocol at LM scale: one rank's population update of
    ``n`` members over ``("pod", "data")`` (its rows), each member sharded
    over ``model`` by the TP rules; the shape's tokens split over the
    members. Returns ``(counter, info)``."""
    cfg = cfg_override or get_config(arch)
    shape = LM_SHAPES[shape_name]
    if shape.kind != "train":
        raise ValueError("the population dry run targets train shapes")
    mesh = mesh or production_mesh(multi_pod)
    shard = _model_shard(mesh)
    pop = _size(mesh, fsdp_axes(mesh))
    rows = n // pop if n % pop == 0 else n
    per_member = max(shape.global_batch // n, 1)
    member = _tp_params(lm_mod.param_shapes(cfg), shard)
    with population_mode():
        like = tree_map(lambda x: x[None].expand((rows,) + x.shape), member)
        _, params = flat_empty(like)
        _, mu = flat_empty(params)
        _, nu = flat_empty(params)
    from repro_torch.optim.optimizers import AdamState
    from repro_torch.pop.agent import LMState
    steps = lambda: _meta((rows,), torch.int32)
    state = LMState(params=params, opt_state=AdamState(step=steps(), mu=mu,
                                                       nu=nu), step=steps())
    batch = {"tokens": _meta((rows, per_member, shape.seq_len), torch.int32)}
    if cfg.frontend == "audio_frames":
        batch["embeds"] = _meta((rows, per_member, shape.seq_len,
                                 cfg.d_model), lm_mod.compute_dtype(cfg))
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = _meta(
            (rows, per_member, cfg.num_frontend_positions, cfg.d_model),
            lm_mod.compute_dtype(cfg))
    hypers = {"lr_scale": _meta((rows,), torch.float32)}
    update = lm_mod.make_population_update(cfg, TrainConfig(), shard=shard)
    t0 = time.perf_counter()
    counter = OpCounter((state, batch, hypers))
    with counter, population_mode():
        _, metrics = update(state, batch, hypers)
    seconds = time.perf_counter() - t0
    state_bytes = sum(nbytes(t) for t in leaves(state))
    arguments = state_bytes + sum(nbytes(t) for t in batch.values()) + 4 \
        + rows * 4
    return counter, _info(cfg, shape_name, mesh, counter, seconds,
                          arguments, state_bytes + sum(
                              nbytes(t) for t in leaves(metrics)),
                          state_bytes, population=n)


def analyze_cell(counter, info) -> dict:
    """``info`` with the counted pass and its roofline terms (JAX's
    keys)."""
    a = counter.analysis()
    info = dict(info)
    info.update({
        "hlo_flops_per_device": a["flops"],
        "hlo_traffic_bytes_per_device": a["traffic_bytes"],
        "collective_bytes_per_device": a["collective_bytes"],
        "collective_counts": a["collective_counts"],
        "kernel_meta_calls": a["custom_calls"],
        "top_collectives": top_collectives(counter, 5),
        **roofline_terms(a),
    })
    return info


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             analyze: bool = True, mesh=None) -> dict:
    counter, info = build_cell(arch, shape_name, multi_pod=multi_pod,
                               mesh=mesh)
    return analyze_cell(counter, info) if analyze else info


def all_cells() -> list:
    """Every (arch, shape) of the registry's configs that applies."""
    return [(a, s) for a in list_configs()
            for s in applicable_shapes(get_config(a))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--population", type=int, default=0,
                    help="the paper's population update of N members in "
                         "place of the plain cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-analyze", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            try:
                if args.population:
                    counter, info = build_population_cell(
                        arch, shape, args.population, multi_pod=mp)
                    if not args.no_analyze:
                        info = analyze_cell(counter, info)
                else:
                    info = run_cell(arch, shape, multi_pod=mp,
                                    analyze=not args.no_analyze)
                info["status"] = "ok"
                print(f"[dryrun] OK   {tag}: pass={info['compile_s']}s "
                      f"bottleneck={info.get('bottleneck')}", flush=True)
            except Exception as e:
                info = {"arch": arch, "shape": shape, "multi_pod": mp,
                        "status": "error", "error": f"{type(e).__name__}: {e}"}
                print(f"[dryrun] FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
            results.append(info)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_bad = sum(r["status"] != "ok" for r in results)
    print(f"[dryrun] {len(results) - n_bad}/{len(results)} cells OK")
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
