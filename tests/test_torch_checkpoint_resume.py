"""Checkpoint resume on the port, held on the CPU.

The manager's asynchronous save, wait and restore, and retention past a
partial ``.tmp`` (as ``tests/test_checkpoint_optim.py`` holds the JAX
manager); the crossing with the JAX package (a plain tree both ways, the
trainers' main trees refused both ways by the leaf-count check, the
``actors`` and ``hypers`` aux trees bit for bit); a resumed run equal to
the uninterrupted one bit for bit (TD3 eager at an evolve boundary, TD3
in fused epochs at an epoch boundary) and a fused resume off an epoch's
end refused. ``test_torch_resume.py`` holds the rest: the in-place
restore, the CLIs run twice, the refusals. (Each file stays under 11
tests: see ROADMAP §3 on xdist's file queue.)
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs.base import PopulationConfig as JaxPopulationConfig
from repro.envs import make as jax_make
from repro.pop import PopTrainer as JaxPopTrainer
from repro.rl import get_algo as jax_get_algo
from repro.rl import make_agent as jax_make_agent
from repro_torch.checkpoint import (CheckpointManager, SignalHandler,
                                    load_pytree, save_pytree)
from repro_torch.configs.base import PopulationConfig
from repro_torch.envs import make
from repro_torch.pop import PopTrainer
from repro_torch.rl import get_algo, make_agent
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)


def _trainer(ckpt, *, env="pendulum", n=3, pbt_interval=2, policy_lag=None):
    agent = make_agent("td3", make(env).spec, device="cpu")
    pcfg = PopulationConfig(size=n, num_steps=2, pbt_interval=pbt_interval,
                            hyper_space=get_algo("td3").hyper_space)
    trainer = PopTrainer(agent, pcfg, seed=1, checkpoint_dir=ckpt)
    trainer.attach_rollout(make(env), num_envs=2, collect_steps=8,
                           batch_size=20, buffer_capacity=256, eval_envs=2,
                           policy_lag=policy_lag)
    return trainer


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_save_async_wait_restore_round_trip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, run_meta={"run_id": "r1"})
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.int32), np.full((1,), 7.0)]}
    mgr.save_async(5, tree, {"loss": 1.5}, aux={"side": {"x": torch.zeros(2)}})
    mgr.wait()
    got, extra = mgr.restore(tree)
    assert extra == {"loss": 1.5, "step": 5, "run": {"run_id": "r1"}}
    for x, y in zip(leaves(tree), leaves(got)):
        np.testing.assert_array_equal(np.asarray(x), y)
    assert got["b"][0].dtype == np.int32
    side = mgr.restore_aux("side", {"x": 0})
    np.testing.assert_array_equal(side["x"], np.zeros(2, np.float32))
    assert mgr.restore_aux("absent", {"x": 0}) is None
    assert CheckpointManager(tmp_path / "empty").restore(tree) == (None,
                                                                   None)


def test_save_async_copies_before_it_returns(tmp_path):
    """The next update writes the same tensors in place: what is saved is
    the value at the call, not what the tensor holds when the writer runs."""
    mgr = CheckpointManager(tmp_path)
    w = torch.full((1000,), 3.0)
    mgr.save_async(1, {"w": w})
    w.fill_(-1.0)
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore({"w": w})[0]["w"], 3.0)


def test_failed_async_write_raises_from_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(1, {"w": torch.ones(2)}, {"bad": object()})
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        mgr.wait()
    mgr.wait()      # reported once


def test_retention_and_resume_after_a_partial_write(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"w": torch.ones(3)}
    for s in (10, 20, 30):
        mgr.save_async(s, {"w": tree["w"] * s})
    mgr.wait()
    assert mgr.all_steps() == [20, 30]
    os.makedirs(tmp_path / "step_0000000040.tmp")  # a preempted writer
    assert mgr.latest() == 30
    np.testing.assert_array_equal(mgr.restore(tree)[0]["w"], 30.0)


def test_signal_handler_writes_an_emergency_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path)
    handler = SignalHandler(mgr, lambda: (7, {"w": torch.ones(2)},
                                          {"loss": 0.5}))
    handler._handle(15, None)
    assert handler.triggered
    assert mgr.peek_extra(require=()) == {"loss": 0.5, "preempted": True,
                                          "step": 7}


def test_plain_tree_crosses_both_ways(tmp_path):
    tree = {"layer_10": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "layer_2": {"b": np.full((3,), 2, np.int32)},
            "steps": [np.ones(2, np.float32)]}
    save_pytree(tmp_path / "port", tree, {"step": 0})
    back = jax_load_pytree(tmp_path / "port", tree)
    jax_save_pytree(tmp_path / "jax", jax.tree.map(jnp.asarray, tree),
                    {"step": 0})
    ours = load_pytree(tmp_path / "jax", tree)
    for want, a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back),
                          leaves(ours)):
        np.testing.assert_array_equal(np.asarray(a), want)
        np.testing.assert_array_equal(b, want)
        assert b.dtype == want.dtype


def test_trainer_main_trees_refuse_each_other_and_aux_trees_cross(tmp_path):
    """JAX's main tree carries per-member key leaves, the port's does not
    (its ``rng`` aux tree is their counterpart): each package refuses the
    other's with the leaf-count ValueError; ``actors`` and ``hypers``
    cross bit for bit, and JAX's restore ignores the ``rng`` tree."""
    port = _trainer(tmp_path / "port")
    port.save(blocking=True)
    jagent = jax_make_agent("td3", jax_make("pendulum").spec)
    jpcfg = JaxPopulationConfig(size=3, num_steps=2, pbt_interval=2,
                                hyper_space=jax_get_algo("td3").hyper_space)
    jtrainer = JaxPopTrainer(jagent, jpcfg, seed=1,
                             checkpoint_dir=tmp_path / "jax")
    jtrainer.save(blocking=True)
    with pytest.raises(ValueError, match="leaves but the restore template"):
        _trainer(tmp_path / "jax").resume()
    jport = JaxPopTrainer(jagent, jpcfg, seed=1,
                          checkpoint_dir=tmp_path / "port")
    with pytest.raises(ValueError, match="leaves but the restore template"):
        jport.resume()
    jmgr = JaxManager(tmp_path / "port")
    for name, tree in (("actors", port.actors), ("hypers", port.hypers)):
        got = jmgr.restore_aux(name, tree)
        for a, b in zip(jax.tree.leaves(got), leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = CheckpointManager(tmp_path / "jax").restore_aux(
        "hypers", port.hypers)
    for a, b in zip(leaves(back), jax.tree.leaves(jtrainer.hypers)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_td3_eager_resume_at_an_evolve_boundary_is_bitwise(tmp_path):
    run = _trainer(tmp_path)
    run.run_env_loop(2, eval_every=1)      # evolves at iteration 2
    run.save()
    run.run_env_loop(2, eval_every=1)
    run.wait()
    again = _trainer(tmp_path)
    assert again.resume() == 1 and again.step_count == 2
    assert again.rollout.iterations == 2
    again.run_env_loop(2, eval_every=1)
    assert _equal(run.state, again.state)
    assert _equal(run.hypers, again.hypers)
    assert _equal(run.rollout.export_state(), again.rollout.export_state())
    assert torch.equal(run.generator.get_state(),
                       again.generator.get_state())


def test_td3_fused_resume_at_an_epoch_boundary_is_bitwise(tmp_path):
    run = _trainer(tmp_path, env="hopper2d")
    run.run_env_loop(2, eval_every=1, fused=True)
    run.save(blocking=True)
    run.run_env_loop(2, eval_every=1, fused=True)
    again = _trainer(tmp_path, env="hopper2d")
    again.resume()
    again.run_env_loop(2, eval_every=1, fused=True)
    assert _equal(run.state, again.state)
    assert _equal(run.rollout.export_state(), again.rollout.export_state())
    assert _equal(run.hypers, again.hypers)


def test_fused_resume_off_an_epoch_boundary_raises(tmp_path):
    eager = _trainer(tmp_path, env="hopper2d")
    eager.run_env_loop(1, eval_every=1)
    eager.save(blocking=True)
    again = _trainer(tmp_path, env="hopper2d")
    assert again.resume() == 0
    with pytest.raises(ValueError, match="not epoch-aligned"):
        again.run_env_loop(2, eval_every=1, fused=True)
