"""Elastic population resize on the port, held on the CPU against the JAX
package (``repro.elastic``).

``plan_resize``, ``resize_tree``, ``shrink_population`` and
``grow_population`` equal JAX's over a grid of sizes and fitness with
ties, the non-population leaves and the errors included.
``restore_elastic`` gathers a TD3 trainer's state, hypers, replay rings
and env states by JAX's lineage, bit for bit, into the new trainer's own
tensors; a JAX trainer and a port trainer carrying its parameters,
resized alike, hold equal members and take one update that agrees at the
TD3 update parity's tolerance (rtol 1e-4, atol 1e-5); a language-model
population's rows are gathered into its flat buffers, which stay the
leaves' base; a fused epoch and the overlapped engine run on from a
resized state. (Under 11 tests: ROADMAP §3 on xdist's file queue.)
"""
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PopulationConfig as JaxPopulationConfig
from repro.elastic import grow_population as jax_grow
from repro.elastic import plan_resize as jax_plan
from repro.elastic import resize_tree as jax_resize_tree
from repro.elastic import restore_elastic as jax_restore_elastic
from repro.elastic import shrink_population as jax_shrink
from repro.envs import make as jax_make
from repro.pop import PopTrainer as JaxPopTrainer
from repro.rl import get_algo as jax_get_algo
from repro.rl import make_agent as jax_make_agent
from repro.rl import td3 as jax_td3
from repro.rl.fused import pop_split
from repro_torch.configs import (HyperSpace, PopulationConfig, TrainConfig,
                                 get_config)
from repro_torch.convert import from_jax_params
from repro_torch.elastic import (grow_population, plan_resize, resize_tree,
                                 restore_elastic, shrink_population)
from repro_torch.envs import make
from repro_torch.pop import LMAgent, PopTrainer
from repro_torch.rl import get_algo, make_agent, td3
from repro_torch.tree import copy_into, flat_buffer, leaves, tree_map
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

FITNESS = [3.0, 1.0, 4.0, 2.0]
TOL = dict(rtol=1e-4, atol=1e-5)     # the TD3 update parity test's


def _trainer(ckpt, n, *, env="pendulum", pbt_interval=0, policy_lag=None):
    agent = make_agent("td3", make(env).spec, device="cpu")
    pcfg = PopulationConfig(size=n, num_steps=2, pbt_interval=pbt_interval,
                            hyper_space=get_algo("td3").hyper_space)
    trainer = PopTrainer(agent, pcfg, seed=0, checkpoint_dir=ckpt)
    trainer.attach_rollout(make(env), num_envs=2, collect_steps=8,
                           batch_size=16, buffer_capacity=256, eval_envs=1,
                           policy_lag=policy_lag)
    return trainer


def _saved(trainer):
    return [x.clone() for x in leaves((trainer.state, trainer.hypers,
                                       trainer.rollout.export_state()))]


def _assert_gathered(trainer, saved, parents, old_n):
    idx = torch.as_tensor(parents)
    got = leaves((trainer.state, trainer.hypers,
                  trainer.rollout.export_state()))
    assert len(got) == len(saved)
    for g, s in zip(got, saved):
        want = s[idx] if s.ndim and s.shape[0] == old_n else s
        assert torch.equal(g, want)


def test_resize_functions_match_jax():
    rng = np.random.default_rng(0)
    for old in (1, 3, 4, 7):
        fits = (None, rng.standard_normal(old), np.round(
            rng.standard_normal(old)), np.zeros(old))   # ties
        tree = {"stacked": np.arange(old * 2.0).reshape(old, 2),
                "ints": np.arange(old, dtype=np.int32),
                "shared_critic": np.ones((5, 3)), "scalar": np.float32(2),
                "none": None}
        for new in range(1, 2 * old + 2):
            for fit in fits:
                want_p, want_l = jax_plan(old, new, fit)
                parents, lineage = plan_resize(old, new, fit)
                assert parents.dtype == want_p.dtype == np.int64
                np.testing.assert_array_equal(parents, want_p)
                np.testing.assert_array_equal(lineage, want_l)
                want = jax_resize_tree(tree, old, want_p)
                for name in ("stacked", "ints", "shared_critic", "scalar"):
                    np.testing.assert_array_equal(
                        resize_tree(tree, old, parents)[name], want[name])
                    as_tensor = resize_tree(
                        {name: torch.as_tensor(tree[name])}, old, parents)
                    np.testing.assert_array_equal(
                        as_tensor[name].numpy(), want[name])
                assert resize_tree(tree, old, parents)["none"] is None
                if fit is None:
                    continue
                if new <= old:
                    got, keep = shrink_population(tree, fit, new)
                    jgot, jkeep = jax_shrink(tree, fit, new)
                else:
                    got, keep = grow_population(tree, fit, new)
                    jgot, jkeep = jax_grow(tree, fit, new)
                np.testing.assert_array_equal(keep, jkeep)
                np.testing.assert_array_equal(got["stacked"],
                                              jgot["stacked"])
    for call in (lambda m: m[0](3, 0), lambda m: m[1]({}, [1, 2], 3),
                 lambda m: m[1]({}, [1, 2], 0), lambda m: m[2]({}, [1, 2], 1),
                 lambda m: m[2]({}, [[1, 2]], 3)):
        for mod in ((plan_resize, shrink_population, grow_population),
                    (jax_plan, jax_shrink, jax_grow)):
            with pytest.raises(ValueError):
                call(mod)


@pytest.mark.parametrize("new_n,expect_lineage", [
    (2, [0, 2]),              # shrink: fitness [3,1,4,2] keeps members 0, 2
    (6, [0, 1, 2, 3, 2, 0]),  # grow: survivors + fittest clones (2 then 0)
])
def test_restore_elastic_roundtrip_preserves_members(tmp_path, new_n,
                                                     expect_lineage):
    """JAX's lineage (``tests/test_elastic.py``'s numbers); the state,
    hypers, replay rings with their counters and env states with their
    episode accounting gathered bit for bit into the trainer's own
    tensors; training goes on."""
    tr = _trainer(tmp_path, 4)
    for _ in range(3):
        tr.env_iteration()
    tr.report_fitness(torch.tensor(FITNESS))
    tr.save(blocking=True)
    saved = _saved(tr)

    tr2 = _trainer(tmp_path, new_n)
    ptrs = [x.data_ptr() for x in leaves((tr2.state, tr2.hypers))]
    step, lineage = restore_elastic(tr2)
    assert step == 2 and lineage.tolist() == expect_lineage
    assert ptrs == [x.data_ptr() for x in leaves((tr2.state, tr2.hypers))]
    _assert_gathered(tr2, saved, lineage, 4)
    assert tr2.rollout.vstate.completed_return_sum.shape[0] == new_n
    assert tr2.step_count == 3 and tr2.rollout.iterations == 3
    assert tr2.last_fitness.tolist() == [FITNESS[p] for p in lineage]
    _, _, did = tr2.env_iteration()
    assert did
    assert all(torch.isfinite(x).all() for x in leaves(tr2.state)
               if x.is_floating_point())


def _jax_trainer(ckpt, n):
    agent = jax_make_agent("td3", jax_make("pendulum").spec)
    pcfg = JaxPopulationConfig(size=n, num_steps=1, pbt_interval=0,
                               hyper_space=jax_get_algo("td3").hyper_space,
                               donate=False)
    return JaxPopTrainer(agent, pcfg, seed=0, checkpoint_dir=ckpt)


def _port_trainer(ckpt, n):
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    pcfg = PopulationConfig(size=n, num_steps=1, pbt_interval=0,
                            hyper_space=get_algo("td3").hyper_space)
    return PopTrainer(agent, pcfg, seed=0, checkpoint_dir=ckpt)


def test_restore_elastic_against_jax(tmp_path):
    """A JAX trainer and a port trainer carrying its parameters and hypers,
    both saved at N = 4 with one fitness and restored at 6: the same
    lineage, the same members bit for bit, and one update on the same
    batch (JAX's target noise injected) within the parity tolerance."""
    jtr = _jax_trainer(tmp_path / "jax", 4)
    port = _port_trainer(tmp_path / "port", 4)
    fields = td3.TD3State._fields
    copy_into(port.state, td3.TD3State(*[
        from_jax_params(jax.device_get(getattr(jtr.state, f)))
        for f in fields]))
    copy_into(port.hypers, {k: np.array(v) for k, v in jtr.hypers.items()})
    for tr in (jtr, port):
        tr.report_fitness(np.asarray(FITNESS, np.float32))
        tr.save(blocking=True)

    j6, p6 = _jax_trainer(tmp_path / "jax", 6), _port_trainer(
        tmp_path / "port", 6)
    _, jlin = jax_restore_elastic(j6)
    _, plin = restore_elastic(p6)
    np.testing.assert_array_equal(plin, np.asarray(jlin))
    for f in fields:
        got, want = leaves(getattr(p6.state, f)), jax.tree.leaves(
            getattr(j6.state, f))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for k, v in j6.hypers.items():
        np.testing.assert_array_equal(p6.hypers[k].numpy(), np.asarray(v))

    rng = np.random.default_rng(1)
    n, b = 6, 8
    batch = {"obs": rng.standard_normal((n, b, 3)).astype(np.float32),
             "action": rng.uniform(-1, 1, (n, b, 1)).astype(np.float32),
             "reward": rng.standard_normal((n, b)).astype(np.float32),
             "next_obs": rng.standard_normal((n, b, 3)).astype(np.float32),
             "done": (rng.random((n, b)) < 0.2).astype(np.float32)}
    jnew, _ = jax_td3.make_population_update(fused_linear=True, fused=False)(
        j6.state, {k: jnp.asarray(v) for k, v in batch.items()}, j6.hypers)
    _, kc = pop_split(j6.state.key)
    noise = np.array(jax.vmap(lambda k: jax.random.normal(k, (b, 1)))(kc))
    new, _ = td3.make_population_update(fused_linear=True)(
        p6.state, {k: torch.from_numpy(v) for k, v in batch.items()},
        p6.hypers, noise=torch.from_numpy(noise))
    for f in fields:
        for g, w in zip(leaves(getattr(new, f)),
                        jax.tree.leaves(getattr(jnew, f))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=f)


def test_restore_elastic_errors_and_warning(tmp_path):
    """A missing or empty directory, no checkpoint directory, a restore
    after a captured epoch; a checkpoint without fitness resizes by
    member index with JAX's warning."""
    tr = _trainer(tmp_path / "empty", 2)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        restore_elastic(tr)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        restore_elastic(tr, tmp_path / "typo")
    assert not (tmp_path / "typo").exists()
    bare = PopTrainer(make_agent("td3", make("pendulum").spec,
                                 device="cpu"), PopulationConfig(size=2))
    with pytest.raises(ValueError, match="no checkpoint_dir"):
        restore_elastic(bare)

    src = _trainer(tmp_path / "ckpt", 3)
    src.env_iteration()
    src.save(blocking=True)              # an empty window: no fitness
    tr = _trainer(tmp_path / "other", 5)
    with pytest.warns(UserWarning, match="no fitness record"):
        step, lineage = restore_elastic(tr, tmp_path / "ckpt")
    assert step == 0 and lineage.tolist() == [0, 1, 2, 0, 1]
    assert tr.last_fitness is None
    with warnings.catch_warnings():      # the same size: no resize
        warnings.simplefilter("error")
        restore_elastic(_trainer(tmp_path / "ckpt", 3))
    tr._epochs = {"epoch": types.SimpleNamespace(graph=object())}
    with pytest.raises(RuntimeError, match="captured as a CUDA graph"):
        restore_elastic(tr, tmp_path / "ckpt")


@pytest.mark.parametrize("new_n", [2, 5])
def test_lm_population_resize_gathers_rows_into_its_flat_buffers(tmp_path,
                                                                 new_n):
    """A tiny LM population, N = 3 -> 2 and 5: the rows gathered by the
    lineage into the flat (N, P) buffers, whose views the leaves stay (no
    tensor rebound); one update equal bit for bit to a fresh trainer given
    the same rows."""
    cfg = get_config("qwen2-0.5b").smoke().replace(num_layers=1,
                                                   vocab_size=64)
    tcfg = TrainConfig(total_steps=8, warmup_steps=1)
    space = HyperSpace(log_uniform=(("lr_scale", 0.1, 10.0),
                                    ("weight_decay", 1e-3, 0.3)),
                       uniform=(("warmup_frac", 0.01, 0.25),))

    def trainer(n, ckpt=None):
        return PopTrainer(LMAgent(cfg, tcfg, device="cpu"),
                          PopulationConfig(size=n, pbt_interval=0,
                                           hyper_space=space),
                          seed=0, checkpoint_dir=ckpt)

    tokens = lambda n, seed: {"tokens": torch.from_numpy(
        np.random.default_rng(seed).integers(0, 64, (n, 1, 16)))}
    src = trainer(3, tmp_path)
    src.step(tokens(3, 0))
    src.report_fitness(torch.tensor([0.5, 2.0, 1.0]))
    src.save(blocking=True)
    saved = [x.clone() for x in leaves((src.state, src.hypers))]

    tr = trainer(new_n, tmp_path)
    buffers = [flat_buffer(t) for t in (tr.state.params,
                                        tr.state.opt_state.mu,
                                        tr.state.opt_state.nu)]
    ptrs = [x.data_ptr() for x in leaves((tr.state, tr.hypers))]
    step, lineage = restore_elastic(tr)
    assert step == 0
    assert lineage.tolist() == ([1, 2] if new_n == 2 else [0, 1, 2, 1, 2])
    assert ptrs == [x.data_ptr() for x in leaves((tr.state, tr.hypers))]
    for buf, t in zip(buffers, (tr.state.params, tr.state.opt_state.mu,
                                tr.state.opt_state.nu)):
        assert flat_buffer(t).data_ptr() == buf.data_ptr()
    idx = torch.as_tensor(lineage)
    for got, want in zip(leaves((tr.state, tr.hypers)), saved):
        assert torch.equal(got, want[idx])

    fresh = trainer(new_n)
    tree_map(lambda d, s: d.copy_(s), (fresh.state, fresh.hypers),
             (tr.state, tr.hypers))
    batch = tokens(new_n, 1)
    a, _ = tr.update(tr.state, batch, tr.hypers, tr.generator)
    b, _ = fresh.update(fresh.state, batch, fresh.hypers, fresh.generator)
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert flat_buffer(tr.state.params).data_ptr() == buffers[0].data_ptr()


def test_fused_epoch_from_a_resized_state_equals_the_eager_loop(tmp_path):
    """Saved at 4 members after two PBT epochs, restored at 6: one fused
    train-evolve epoch (eager on the CPU; a captured graph on the card)
    equals the eager loop from the same restore, bit for bit."""
    src = _trainer(tmp_path, 4, pbt_interval=2)
    src.run_env_loop(4, eval_every=1)
    src.report_fitness(torch.tensor(FITNESS))
    src.save(blocking=True)
    runs = []
    for fused in (True, False):
        tr = _trainer(tmp_path, 6, pbt_interval=2)
        assert restore_elastic(tr)[1].tolist() == [0, 1, 2, 3, 2, 0]
        tr.run_env_loop(2, eval_every=1, fused=fused)
        runs.append(leaves((tr.state, tr.hypers, tr.rollout.export_state(),
                            tr.generator.get_state())))
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_overlap_engine_restores_resized(tmp_path):
    """``policy_lag=1``: the overlapped engine takes the resized state (its
    pending collect dropped) and acts on from it."""
    src = _trainer(tmp_path, 3, policy_lag=1)
    src.run_env_loop(2, eval_every=1)
    src._window.clear()
    src.report_fitness(torch.tensor([1.0, 3.0, 2.0]))
    src.save(blocking=True)
    saved = _saved(src)
    tr = _trainer(tmp_path, 4, policy_lag=1)
    tr.run_env_loop(1, eval_every=1)
    assert tr.rollout._pending is not None
    _, lineage = restore_elastic(tr)
    assert lineage.tolist() == [0, 1, 2, 1]
    assert tr.rollout._pending is None
    _assert_gathered(tr, saved, lineage, 3)
    tr.run_env_loop(2, eval_every=1)
    assert tr.step_count == 4
