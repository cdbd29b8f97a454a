"""Fused train-evolve epochs of the port (``PopTrainer.run_env_loop(
fused=True)``, ``RolloutEngine.build_epoch``) against its eager loop, as
``tests/test_fused_epoch.py`` holds the JAX package's.

On the CPU the epoch function runs eagerly: the plain form that the card
captures as one CUDA graph. It must equal the eager loop bit for bit:
population state, hypers, the generator's state, the strategy's state,
the fitness window and the last fitness, the buffers and the env states,
over td3, sac, dqn and ppo and the pbt, cem and dvd strategies. Then the
non-evolving epoch, fused calls chained like one longer eager run, and
the alignment checks, whose messages carry the JAX package's phrases.
(``chip_smoke.py`` holds the captured graph to the eager loop on the
card.)
"""
import pytest
import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.envs import make
from repro_torch.pop import PopTrainer
from repro_torch.rl import get_algo, make_agent
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

ALGO_ENV = {"td3": "pendulum", "sac": "pendulum",
            "dqn": "cartpole", "ppo": "cartpole"}


def _build(algo, strategy, *, size=3, pbt_interval=4, fitness_window=10,
           seed=7):
    env = make(ALGO_ENV[algo])
    pcfg = PopulationConfig(
        size=size, strategy=strategy, backend="vectorized",
        num_steps=1 if algo == "ppo" else 2, pbt_interval=pbt_interval,
        fitness_window=fitness_window,
        hyper_space=get_algo(algo).hyper_space)
    tr = PopTrainer(make_agent(algo, env.spec, hidden=(8, 8), device="cpu"),
                    pcfg, seed=seed)
    kwargs = dict(num_envs=2, collect_steps=8, eval_envs=2, eval_steps=20)
    if algo == "ppo":
        tr.attach_rollout(env, batch_size=16, epochs=1, **kwargs)
    else:
        tr.attach_rollout(env, batch_size=16, buffer_capacity=512, **kwargs)
    return tr


def _assert_trees_equal(a, b, msg):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb), msg
    for x, y in zip(la, lb):
        assert torch.equal(x, y), msg


def _assert_trainers_equal(ea, fu):
    _assert_trees_equal(ea.state, fu.state, "population state")
    assert torch.equal(ea.generator.get_state(), fu.generator.get_state())
    assert ea.step_count == fu.step_count
    assert ea.rollout.iterations == fu.rollout.iterations
    assert (ea.hypers is None) == (fu.hypers is None)
    _assert_trees_equal(ea.hypers, fu.hypers, "hypers")
    _assert_trees_equal(ea.strategy.export_state(),
                        fu.strategy.export_state(), "strategy state")
    assert (ea.last_fitness is None) == (fu.last_fitness is None)
    if ea.last_fitness is not None:
        assert torch.equal(ea.last_fitness, fu.last_fitness)
    assert len(ea._window) == len(fu._window)
    for wa, wb in zip(ea._window, fu._window):
        assert torch.equal(wa, wb), "fitness window"
    _assert_trees_equal(ea.rollout.bufs, fu.rollout.bufs, "buffers")
    _assert_trees_equal(ea.rollout.vstate, fu.rollout.vstate, "env states")


@pytest.mark.parametrize("algo,strategy",
                         [(a, s) for a in sorted(ALGO_ENV)
                          for s in ("pbt", "cem", "dvd")])
def test_fused_epoch_bitwise_vs_eager(algo, strategy):
    """Two epochs (8 iterations, evolve every 4, evaluate every 2) equal
    the eager loop bit for bit; the per-iteration hook sees the same
    metrics, fitness and lineage."""
    ea = _build(algo, strategy)
    fu = _build(algo, strategy)
    seen = {"eager": [], "fused": []}

    def hook(name):
        def on_iter(it, metrics, stats, fitness, lineage):
            seen[name].append((it, metrics, stats, fitness, lineage))
        return on_iter

    ea.run_env_loop(8, eval_every=2, on_iter=hook("eager"))
    fu.run_env_loop(8, eval_every=2, on_iter=hook("fused"), fused=True)
    _assert_trainers_equal(ea, fu)
    assert len(seen["eager"]) == len(seen["fused"]) == 8
    for a, b in zip(seen["eager"], seen["fused"]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert (x is None) == (y is None)
            _assert_trees_equal(x, y, f"iteration {a[0]}")
    lineages = [lin for *_, lin in seen["fused"] if lin is not None]
    assert len(lineages) == 2
    if strategy == "cem":
        assert all((lin == -1).all() for lin in lineages)


def test_fused_epoch_bitwise_non_evolving():
    """Below the evolve cadence the epoch is iterations and evaluations;
    the fitness window fills with the same rows."""
    ea = _build("td3", "none")
    fu = _build("td3", "none")
    ea.run_env_loop(4, eval_every=2)
    fu.run_env_loop(4, eval_every=2, fused=True)
    _assert_trainers_equal(ea, fu)
    assert len(fu._window) == 2


def test_fused_epoch_resumes_across_calls():
    """Back-to-back fused calls chain like one longer eager run, and an
    eager call between them hands its state to the next epoch."""
    ea = _build("td3", "pbt")
    fu = _build("td3", "pbt")
    ea.run_env_loop(16, eval_every=2)
    fu.run_env_loop(8, eval_every=2, fused=True)
    fu.run_env_loop(4, eval_every=2)
    fu.run_env_loop(4, eval_every=2, fused=True)
    _assert_trainers_equal(ea, fu)
    # 16 transitions an iteration fill a batch of 16 from the first: every
    # epoch has the same gate pattern, so one epoch function serves all
    assert len(fu._epochs) == 1


def test_fused_epoch_alignment_errors():
    tr = _build("td3", "pbt")
    with pytest.raises(ValueError, match="multiple of pbt_interval"):
        tr.run_env_loop(6, eval_every=2, fused=True)
    with pytest.raises(ValueError, match="divide pbt_interval"):
        tr.run_env_loop(8, eval_every=3, fused=True)
    tr2 = _build("td3", "pbt", fitness_window=1)
    with pytest.raises(ValueError, match="overflow fitness_window"):
        tr2.run_env_loop(8, eval_every=2, fused=True)
    tr3 = _build("td3", "pbt")
    tr3.report_fitness(torch.zeros(3))
    with pytest.raises(ValueError, match="non-empty"):
        tr3.run_env_loop(8, eval_every=2, fused=True)


def test_fused_epoch_misaligned_step_count_errors():
    tr = _build("td3", "pbt")
    tr.run_env_loop(1, eval_every=0)          # eager, no window: no evolve
    with pytest.raises(ValueError, match="not epoch-aligned"):
        tr.run_env_loop(8, eval_every=2, fused=True)


def test_fused_epoch_boundary_crossing_errors():
    tr = _build("td3", "pbt")
    tr.run_env_loop(3, eval_every=0)          # step_count = 3
    with pytest.raises(ValueError, match="crosses an evolve boundary"):
        tr.run_env_loop(2, eval_every=2, fused=True)


def test_train_cli_fused_checkpoints_at_epoch_ends(tmp_path, monkeypatch):
    """Under --fused-epoch a checkpoint due mid-epoch (--ckpt-every 2 of
    an epoch of 4) is taken at the epoch's end, holding what the eager
    CLI's checkpoint of that iteration holds (the eager run saves at the
    epoch ends with --ckpt-every 4)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main as train_main

    argv = ["--algo", "td3", "--env", "pendulum", "--population", "3",
            "--steps", "8", "--pbt-interval", "4", "--eval-every", "2",
            "--num-envs", "2", "--collect-steps", "8", "--updates-per-iter",
            "2", "--batch", "16", "--device", "cpu"]
    saved = []
    save = PopTrainer.save
    monkeypatch.setattr(PopTrainer, "save", lambda self, *a, **k: (
        saved.append(self.step_count), save(self, *a, **k)))
    runs = {}
    for name, flags in (("eager", ["--ckpt-every", "4"]),
                        ("fused", ["--ckpt-every", "2", "--fused-epoch"])):
        report = train_main([*argv, "--ckpt-dir", str(tmp_path / name),
                             *flags])
        runs[name] = (CheckpointManager(tmp_path / name), report.trainer)
    assert saved == [4, 8, 4, 8]        # each run saves at its epoch ends
    assert runs["eager"][0].all_steps() == [3, 7]
    assert runs["fused"][0].all_steps() == [3, 7]
    for step in (3, 7):
        (mgr_e, tr_e), (mgr_f, _) = runs["eager"], runs["fused"]
        assert mgr_e.peek_extra(step) == mgr_f.peek_extra(step)
        got = [leaves(m.restore_aux("actors", tr_e.actors, step))
               for m in (mgr_e, mgr_f)]
        assert len(got[0]) == len(got[1])
        for a, b in zip(*got):
            assert (a == b).all(), f"actors at step {step}"
