"""Checkpoints cross between the two packages bit for bit.

The port writes and reads the JAX package's layout (``arrays.npz`` /
``aux_<name>.npz`` with ``leaf_<i>`` in JAX's flatten order, which sorts
dict keys, and ``meta.json``): a JAX population trainer's checkpoint
serves from the port, and a checkpoint the port writes serves from the
JAX package. Arrays must be bitwise equal.
"""
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint.manager import load_aux as jax_load_aux
from repro.checkpoint.manager import save_pytree as jax_save_pytree
from repro.configs.base import PopulationConfig
from repro.envs import make as jax_make
from repro.pop import PopTrainer
from repro.rl import make_agent as jax_make_agent
from repro.serve import load_actor_stack as jax_load_actor_stack
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import load_aux, save_pytree
from repro_torch.convert import to_numpy
from repro_torch.envs import make
from repro_torch.rl import make_agent
from repro_torch.serve import load_actor_stack
from repro_torch.tree import flatten, stack, tree_map, unflatten
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)


def _twelve_layers():
    rng = np.random.default_rng(0)
    return {f"layer_{i}": {"w": rng.standard_normal((i + 1, 2)).astype(
        np.float32), "b": np.full((2,), i, np.float32)} for i in range(12)}


def test_flatten_order_is_jax_order():
    """Sorted keys: layer_10 and layer_11 come before layer_2, b before w
    — exactly jax.tree_util's leaf order."""
    tree = _twelve_layers()
    ours, _ = flatten(tree)
    theirs = jax.tree_util.tree_leaves(tree)
    assert len(ours) == len(theirs) == 24
    for a, b in zip(ours, theirs):
        assert a is b
    assert ours[4] is tree["layer_10"]["b"]   # after layer_0, layer_1


def test_twelve_layer_tree_crosses_both_ways(tmp_path):
    tree = _twelve_layers()
    save_pytree(tmp_path / "port", {}, extra={"step": 1}, aux={"t": tree})
    back = jax_load_aux(tmp_path / "port", "t", tree)
    jax_save_pytree(tmp_path / "jax", {}, extra={"step": 1}, aux={"t": tree})
    ours = load_aux(tmp_path / "jax", "t", tree)
    for got in (back, ours):
        for name in tree:
            for leaf in ("w", "b"):
                np.testing.assert_array_equal(np.asarray(got[name][leaf]),
                                              tree[name][leaf])


class _State(NamedTuple):
    actor: dict
    extra: object


def test_tree_roundtrip_with_namedtuple_none_and_sequences():
    tree = (_State(actor={"z": torch.ones(2), "a": [torch.zeros(1), 3.0]},
                   extra=None), {})
    leaves, treedef = flatten(tree)
    assert len(leaves) == 3
    back = unflatten(treedef, leaves)
    assert isinstance(back[0], _State) and back[0].extra is None
    assert back[0].actor["a"][1] == 3.0 and back[1] == {}
    doubled = tree_map(lambda x: x * 2, tree)
    assert doubled[0].actor["a"][1] == 6.0
    st = stack([{"w": torch.zeros(3)}, {"w": torch.ones(3)}])
    assert tuple(st["w"].shape) == (2, 3)
    with pytest.raises(ValueError, match="more leaves"):
        unflatten(treedef, leaves + [1])


def _jax_trainer(path, n=4):
    env = jax_make("pendulum")
    agent = jax_make_agent("td3", env.spec)
    trainer = PopTrainer(agent, PopulationConfig(size=n, strategy="none",
                                                 donate=False),
                         seed=0, checkpoint_dir=str(path))
    return agent, trainer


def test_jax_trainer_checkpoint_loads_bitwise_in_the_port(tmp_path):
    _, trainer = _jax_trainer(tmp_path)
    trainer.step_count = 1
    trainer.report_fitness(np.array([1.0, 2.0, 3.0, 0.0]))
    trainer.save(blocking=True)

    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    actors, extra = load_actor_stack(CheckpointManager(tmp_path), agent)
    assert extra["size"] == 4 and extra["fitness"][2] == 3.0
    ours = flatten(actors)[0]
    theirs = jax.tree_util.tree_leaves(trainer.actors)
    assert len(ours) == len(theirs) == 6
    for got, ref in zip(ours, theirs):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_port_checkpoint_loads_bitwise_in_jax(tmp_path):
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    state = agent.population_init(torch.Generator().manual_seed(5), 3)
    actors = agent.actor_params(state)
    CheckpointManager(tmp_path).save(
        7, (state, {}), {"size": 3, "fitness": [0.5, -1.0, 2.0]},
        aux={"actors": actors})

    jagent = jax_make_agent("td3", jax_make("pendulum").spec)
    jactors, extra = jax_load_actor_stack(JaxManager(str(tmp_path)), jagent)
    assert extra == {"size": 3, "fitness": [0.5, -1.0, 2.0], "step": 7}
    for name, layer in to_numpy(actors).items():
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(jactors[name][leaf]),
                                          layer[leaf])


def test_manager_latest_retention_and_strict_extras(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    assert mgr.latest() is None and mgr.peek_extra() is None
    for step in (3, 5, 9):
        mgr.save(step, {"w": np.zeros(2)}, extra={"loss": 1.5},
                 aux={"side": {"v": np.full(3, step)}})
    assert mgr.all_steps() == [5, 9] and mgr.latest() == 9
    with pytest.raises(KeyError, match="lacks extras.*size"):
        mgr.peek_extra()
    assert mgr.peek_extra(require=())["loss"] == 1.5
    assert mgr.peek_extra(require=())["step"] == 9
    assert mgr.restore_aux("actors", {"w": 0}) is None
    np.testing.assert_array_equal(mgr.restore_aux("side", {"v": 0})["v"],
                                  np.full(3, 9))
    np.testing.assert_array_equal(
        mgr.restore_aux("side", {"v": 0}, step=5)["v"], np.full(3, 5))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore_aux("side", {"v": 0, "w": 0})


def test_load_actor_stack_rejects_unservable_checkpoint(tmp_path):
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_actor_stack(mgr, agent)
    mgr.save(0, {"w": np.zeros(2)}, extra={"size": 2, "fitness": None})
    with pytest.raises(ValueError, match="no 'actors' aux"):
        load_actor_stack(mgr, agent)
