"""Resume a checkpointed trainer at another population size, on another
number of ranks (``repro.elastic.relayout``).

Checkpoints hold host numpy trees of the whole population (rank 0 writes
every island's rows), so an elastic resume is: restore -> plan the resize
on the full tree -> take this rank's rows -> write them into the new
trainer's tensors. Every rank plans the same resize, so a checkpoint
written on K ranks resumes on K' ranks, at the same or another size. The
resize is PBT's mechanics (:mod:`repro_torch.elastic.resize`): a shrink
drops the least fit members, a grow refills with clones of the fittest,
and the attached engine's replay buffers and env states ride along,
gathered by the same member map, so survivors keep their collected
experience bit for bit. A checkpoint holds every leaf whole (rank 0
gathers model-sharded members along their sharded dimensions), so the
resume also crosses model widths: each rank cuts its parts of the resized
members by the rules (``PopTrainer.model_part``).

:func:`relayout` is the placement of one large member's host tree by the
rules of :mod:`repro_torch.models.sharding` over a mesh: this rank's part
of every leaf.

    trainer = PopTrainer(agent, PopulationConfig(size=8, ...),
                         checkpoint_dir=DIR)
    trainer.attach_rollout(env)
    trainer.run_env_loop(100)
    trainer.save(blocking=True)
    # ... restart with a smaller population:
    trainer = PopTrainer(agent, PopulationConfig(size=6, ...),
                         checkpoint_dir=DIR)
    trainer.attach_rollout(env)
    step, lineage = restore_elastic(trainer)   # worst 2 members dropped
    trainer.run_env_loop(100)                  # training continues
"""
from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from repro_torch.elastic.resize import plan_resize, resize_into, resize_tree
from repro_torch.models.sharding import _axes, _size_of, spec_for, tree_paths
from repro_torch.tree import flatten, leaves, unflatten


def relayout(tree, mesh, *, coords=None, device=None):
    """This rank's part of a host (whole) parameter tree placed onto
    ``mesh`` by the rules (:func:`~repro_torch.models.sharding.spec_for`,
    as ``param_specs`` gives them): each
    leaf cut along every dimension its spec shards, by this rank's
    coordinates on the spec's axes (a tuple of axes in mesh order), each
    part its own contiguous tensor on ``device`` (the leaf's, by default).
    ``coords`` ({axis name: coordinate}) places for another rank, or on a
    :class:`~repro_torch.models.sharding.MeshShape`; by default they are
    ``mesh.get_coordinate()``'s."""
    names = _axes(mesh)
    if coords is None:
        coords = dict(zip(names, mesh.get_coordinate()))
    flat, treedef = flatten(tree)
    specs = [spec_for(p, tuple(x.shape), mesh)
             for p, x in zip(tree_paths(tree), flat)]

    def place(x, spec):
        x = torch.as_tensor(x)
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            axes = axis if isinstance(axis, tuple) else (axis,)
            size, index = 1, 0
            for a in axes:
                size *= _size_of(mesh, a)
                index = index * _size_of(mesh, a) + coords[a]
            per = x.shape[dim] // size
            x = x.narrow(dim, index * per, per)
        return x.to(device=device).contiguous().clone() if device \
            is not None else x.contiguous().clone()
    return unflatten(treedef, [place(x, s) for x, s in zip(flat, specs)])


def restore_elastic(trainer, directory=None, *, step=None, layout=None):
    """Restore ``trainer`` (and its attached engine, if any) from a
    checkpoint written by a trainer of a possibly different population
    size.

    The trainer must be freshly built at the NEW size (``pcfg.size``),
    with the checkpointed run's strategy and hyper space so the trees line
    up. Returns ``(saved_step, lineage)``: ``lineage[i]`` is the
    checkpointed member whose state member ``i`` now holds (every member,
    on every rank). ``layout`` (an
    :class:`~repro_torch.elastic.IslandLayout`) defaults to the trainer's;
    the rank writes that layout's rows of the resized population. Raises
    ``FileNotFoundError`` when no checkpoint exists (callers deciding
    between a fresh start and an elastic resume check
    ``manager.peek_extra()`` first, as ``launch.train --resize auto``
    does), ``ValueError`` when the trainer has no checkpoint directory and
    none is given, and ``RuntimeError`` once a fused epoch was captured
    (as :meth:`PopTrainer.resume`).

    Every leaf is gathered from the loaded numpy tree into the trainer's
    own tensors (the population state, the hypers, the engine's buffers
    and env states), never rebinding them. The strategy's state is
    restored unresized (it has no member axis), as in the JAX package: a
    CEM run's whole distribution, of which each rank keeps its columns,
    so it resumes at another size, world and model width.
    The trainer's generator is restored from the ``rng`` aux tree, as
    :meth:`PopTrainer.resume` restores it: the port draws every member's
    numbers from that one generator where the JAX package carries a key a
    member, so there are no keys to resize. The JAX package warms the
    next iteration's compile on a thread during the restore; the port
    compiles nothing but its kernels, which are cached, so there is
    nothing to overlap. Kernel builds and graph captures inside are
    labelled ``"resize"`` in the trainer's telemetry."""
    from repro_torch.checkpoint import CheckpointManager

    if directory is not None:
        if not Path(directory).is_dir():   # the manager would mkdir a
            raise FileNotFoundError(       # typo'd path; stay read-only
                f"restore_elastic: checkpoint directory {directory} does "
                f"not exist")
        mgr = CheckpointManager(directory)
    elif trainer._mgr is not None:
        mgr = trainer._mgr
    else:
        raise ValueError("restore_elastic: trainer has no checkpoint_dir; "
                         "pass directory=")
    step = mgr.latest() if step is None else step
    if step is None:
        raise FileNotFoundError(
            f"restore_elastic: no checkpoint in {mgr.dir}; check "
            f"manager.peek_extra() (None when empty) before calling, or "
            f"start fresh")
    trainer.refuse_after_capture("an elastic restore")

    with trainer.telemetry.compile_scope("resize"):
        (state, strat_state), extra = mgr.restore(
            (trainer.state, trainer.strategy.export_state()), step)
        old_n = extra.get("size")
        if old_n is None:
            old_n = leaves(trainer.agent.actor_params(state))[0].shape[0]
        fitness = extra.get("fitness")
        if old_n != trainer.n and fitness is None:
            warnings.warn(
                "restore_elastic: checkpoint has no fitness record; "
                f"resizing {old_n} -> {trainer.n} by member index, not by "
                f"fitness", stacklevel=2)
        parents, lineage = plan_resize(old_n, trainer.n, fitness)

        rows = layout.rows() if layout is not None else trainer.rows
        mine = parents[rows.lo:rows.hi]
        resize_into(trainer.state, trainer.model_part(state), old_n, mine)
        del state
        if trainer.hypers is not None:   # fresh hypers stay when the
            hypers = mgr.restore_aux("hypers", trainer.hypers, step)
            if hypers is not None:       # source run had none
                resize_into(trainer.hypers, hypers, old_n, parents)
        if strat_state is not None:   # whole: this rank's columns of it
            trainer.strategy.import_state(strat_state)

        if trainer._rollout is not None:
            rstate = mgr.restore_aux("rollout",
                                     trainer._rollout.export_state(), step)
            if rstate is not None:
                trainer._rollout.import_state(
                    resize_tree(rstate, old_n, mine))
                # an RL trainer step is one engine iteration
                trainer._rollout.iterations = extra["step"] + 1
        trainer.restore_generator(mgr, step)

    trainer._window.clear()
    trainer.step_count = extra["step"] + 1
    trainer.last_fitness = None if fitness is None else torch.as_tensor(
        np.asarray(fitness)[parents], dtype=torch.float32,
        device=trainer.agent.device)
    return extra["step"], lineage
