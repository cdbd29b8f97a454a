"""The port's training path end to end on the CPU.

``PopTrainer`` + ``run_env_loop`` train a small TD3 population with PBT
(updates start once every buffer can serve a batch, an evolve fires); the
checkpoint it writes is read back bitwise by the JAX package's
``repro.serve.load_actor_stack`` (TD3's, and DQN's Q-networks); the train
CLI runs with ``--device cpu`` and the port's serve CLI serves what it
wrote (``train_then_serve`` runs the same for SAC and DQN from their own
test files). The CLI refuses to run
without CUDA unless ``--device cpu`` is given, refuses every flag whose
subsystem is not ported, ``--arch`` beside ``--algo``, ``--epochs`` beside
an off-policy ``--algo`` (``--backend sharded|islands`` run, as a world of
one), a ``--resume`` outside
``auto|none``, and a ``--ckpt-dir`` whose checkpoint has another
structure; ``--log-dir`` and ``--profile`` write their files.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.envs import make as jax_make
from repro.rl import make_agent as jax_make_agent
from repro.serve import load_actor_stack as jax_load_actor_stack
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import PopulationConfig
from repro_torch.envs import make
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import _REFUSED
from repro_torch.launch.train import main as train_main
from repro_torch.pop import PopTrainer
from repro_torch.rl import get_algo, make_agent
from repro_torch.serve import load_actor_stack
from repro_torch.tree import leaves
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

SMALL = ["--algo", "td3", "--env", "pendulum", "--population", "3",
         "--steps", "4", "--pbt-interval", "2", "--eval-every", "1",
         "--num-envs", "2", "--collect-steps", "8", "--updates-per-iter",
         "2", "--batch", "24", "--fused-adam", "--fused-linear"]


def _trainer(tmp_path, n=3):
    agent = make_agent("td3", make("pendulum").spec, device="cpu")
    pcfg = PopulationConfig(size=n, num_steps=2, pbt_interval=3,
                            hyper_space=get_algo("td3").hyper_space)
    trainer = PopTrainer(agent, pcfg, seed=1, checkpoint_dir=tmp_path)
    trainer.attach_rollout(make("pendulum"), num_envs=2, collect_steps=8,
                           batch_size=20, buffer_capacity=256, eval_envs=2)
    return trainer


def test_pop_trainer_env_loop_trains_and_evolves(tmp_path):
    trainer = _trainer(tmp_path)
    assert trainer.rollout.update is trainer.update
    seen = []
    trainer.run_env_loop(
        6, eval_every=1,
        on_iter=lambda it, m, s, f, lin: seen.append((it, m, f, lin)))
    # 16 transitions per iteration against a batch of 20: the first
    # iteration only collects
    assert [m is None for _, m, _, _ in seen] == [True] + [False] * 5
    assert trainer.state.critic_opt.step.tolist() == [10, 10, 10]
    evolved = [(it, lin) for it, _, _, lin in seen if lin is not None]
    assert [it for it, _ in evolved] == [2, 5]
    for _, lin in evolved:
        assert (lin != torch.arange(3)).sum() == 1      # round(3 * 0.3)
    assert all(f.shape == (3,) and torch.isfinite(f).all()
               for _, _, f, _ in seen)
    for m in seen[-1][1].values():
        assert torch.isfinite(m).all()
    # evolve cleared the window; one more evaluation refills it
    assert trainer.fitness() is None and trainer.last_fitness is not None
    trainer.report_fitness(trainer.evaluate_fitness())
    assert trainer.fitness().shape == (3,)
    # a fused epoch that evolves must start from an empty window
    with pytest.raises(ValueError, match="non-empty"):
        trainer.run_env_loop(3, eval_every=1, fused=True)
    with pytest.raises(ValueError, match="policy_lag must be 0 or 1"):
        trainer.attach_rollout(make("pendulum"), policy_lag=2)


def test_trainer_step_updates_without_a_rollout(tmp_path):
    trainer = _trainer(tmp_path)
    rng = np.random.default_rng(0)
    shape = (2, 3, 16)
    batch = {"obs": rng.standard_normal(shape + (3,)),
             "action": rng.uniform(-1, 1, shape + (1,)),
             "reward": rng.standard_normal(shape),
             "next_obs": rng.standard_normal(shape + (3,)),
             "done": np.zeros(shape)}
    batch = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in batch.items()}
    metrics = trainer.run(3, lambda step: batch)
    assert trainer.step_count == 3
    assert trainer.state.critic_opt.step.tolist() == [6, 6, 6]
    assert metrics["critic_loss"].shape == (3,)


def test_checkpoint_is_read_bitwise_by_jax(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.run_env_loop(2, eval_every=1)
    trainer.save(blocking=True)
    extra = CheckpointManager(tmp_path).peek_extra()
    assert extra["size"] == 3 and extra["step"] == 1
    assert len(extra["fitness"]) == 3

    jagent = jax_make_agent("td3", jax_make("pendulum").spec)
    jactors, jextra = jax_load_actor_stack(JaxCheckpointManager(tmp_path),
                                           jagent)
    assert jextra["fitness"] == extra["fitness"]
    want = leaves(trainer.actors)
    got = jax.tree.leaves(jactors)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    # and by the port's own serving loader, from one member's template
    actors, _ = load_actor_stack(CheckpointManager(tmp_path),
                                 trainer.agent)
    for g, w in zip(leaves(actors), want):
        assert torch.equal(g, w)
    # hypers and the main tree (state, strategy state) are there too
    hypers = CheckpointManager(tmp_path).restore_aux(
        "hypers", trainer.hypers)
    for k in trainer.hypers:
        np.testing.assert_array_equal(hypers[k], trainer.hypers[k].numpy())


def test_train_cli_on_cpu_then_serve_cli(tmp_path, capsys):
    ckpt = tmp_path / "ck"
    report = train_main(SMALL + ["--ckpt-dir", str(ckpt), "--device",
                                 "cpu"])
    out = capsys.readouterr().out
    assert "[train] algo=td3 env=pendulum pop=3 strategy=pbt" in out
    assert out.count("[train] evolve at iter") == 2
    assert "lineage=" in out and "[train] done in" in out
    assert [it for it, _ in report.evolutions] == [2, 4]
    assert np.isfinite(report.best_fitness)
    assert CheckpointManager(ckpt).latest() == 3
    served = serve_main(["--algo", "td3", "--ckpt-dir", str(ckpt),
                         "--ensemble", "2", "--fused-linear", "--batch",
                         "16", "--requests", "3", "--device", "cpu"])
    assert served.server.set.size == 2
    for _, actions in served.batches:
        assert actions.shape == (16, 1) and np.isfinite(actions).all()


def train_then_serve(tmp_path, capsys, algo, env, strategy, backend, mode):
    """SMALL's run of ``algo`` on ``env`` through the train CLI (``--device
    cpu``), then the checkpoint it wrote served through the serve CLI in
    ``mode``. The SAC and DQN test files run it for their algorithms
    under PBT and CEM, on both backends."""
    ckpt = tmp_path / "ck"
    argv = ["--algo", algo, "--env", env] + SMALL[4:] + [
        "--strategy", strategy, "--backend", backend, "--ckpt-dir",
        str(ckpt), "--device", "cpu"]
    report = train_main(argv)
    out = capsys.readouterr().out
    assert f"[train] algo={algo} env={env} pop=3 strategy={strategy}" in out
    assert [it for it, _ in report.evolutions] == [2, 4]
    if strategy == "cem":           # every member drawn afresh
        assert all(lin == [-1, -1, -1] for _, lin in report.evolutions)
    assert np.isfinite(report.best_fitness)
    assert all(torch.isfinite(v).all() for v in report.metrics.values())
    assert CheckpointManager(ckpt).latest() == 3
    served = serve_main(["--algo", algo, "--env", env, "--ckpt-dir",
                         str(ckpt), "--ensemble", "3", "--mode", mode,
                         "--fused-linear", "--batch", "16", "--requests",
                         "3", "--device", "cpu"])
    assert served.server.set.size == 3
    for obs, actions in served.batches:
        if algo == "dqn":           # the members' plurality action
            assert actions.shape == (16,)
            assert set(np.unique(actions)) <= {0, 1}
        else:
            assert actions.shape == (16, 1)
            assert np.isfinite(actions).all() and np.abs(actions).max() <= 1


def test_dqn_checkpoint_is_read_bitwise_by_jax(tmp_path):
    """A DQN population's ``actors`` aux tree (its Q-networks) crosses to
    the JAX package's layout bit for bit, as TD3's does."""
    agent = make_agent("dqn", make("cartpole").spec, device="cpu")
    pcfg = PopulationConfig(size=3, num_steps=2, pbt_interval=3,
                            hyper_space=get_algo("dqn").hyper_space)
    trainer = PopTrainer(agent, pcfg, seed=1, checkpoint_dir=tmp_path)
    trainer.attach_rollout(make("cartpole"), num_envs=2, collect_steps=8,
                           batch_size=16, buffer_capacity=256, eval_envs=2)
    trainer.run_env_loop(2, eval_every=1)
    trainer.save(blocking=True)
    jagent = jax_make_agent("dqn", jax_make("cartpole").spec)
    jactors, _ = jax_load_actor_stack(JaxCheckpointManager(tmp_path), jagent)
    want = leaves(trainer.actors)
    got = jax.tree.leaves(jactors)
    assert len(got) == len(want) == 6
    assert sorted(jactors) == ["head"]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    actors, _ = load_actor_stack(CheckpointManager(tmp_path), agent)
    for g, w in zip(leaves(actors), want):
        assert torch.equal(g, w)


def test_train_cli_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(SMALL + ["--ckpt-dir", str(tmp_path)])


# each refused flag of the JAX training CLI and the error the port gives;
# ``arch`` is --arch passed beside --algo, which the CLI refuses as the
# JAX one does, and ``epochs`` is --epochs beside an off-policy --algo
# (here td3), where it would do nothing. ``log_dir`` and ``profile`` are
# taken now (error None: the file whose name ends in ``match`` is written
# into the directory ``1``), ``devices`` and ``model_axis`` too (error
# None, match None: ``--devices 1`` is the world size here, ``--model-axis
# 1`` no model sharding; their refusals are test_torch_islands_cli.py's),
# and ``resume`` takes auto|none only.
_REFUSED_CASES = (
    ("arch", SystemExit, "pass exactly one of --arch"),
    ("compile_cache", NotImplementedError, "not supported by the port"),
    ("devices", None, None),
    ("epochs", ValueError, "taken by the on-policy algorithms only"),
    ("log_dir", None, "telemetry.jsonl"),
    ("model_axis", None, None),
    ("profile", None, ".trace.json"),
    ("resize", SystemExit, "invalid choice: '1'"),
    ("resume", SystemExit, "invalid choice: '1'"),
)


def test_refused_cases_cover_every_refused_flag():
    """Every flag still refused has its case; the flags this CLI now takes
    (``--log-dir``, ``--profile``, ``--resume auto|none``, ``--resize
    strict|auto``) keep theirs."""
    assert sorted(f for f, _, _ in _REFUSED_CASES
                  if f not in ("arch", "devices", "epochs", "log_dir",
                               "model_axis", "profile", "resize",
                               "resume")) == sorted(_REFUSED)


@pytest.mark.parametrize("flag, error, match", _REFUSED_CASES,
                         ids=[flag for flag, _, _ in _REFUSED_CASES])
def test_train_cli_refuses_unported_flags(tmp_path, capsys, monkeypatch,
                                          flag, error, match):
    """A refused flag raises; ``[log_dir]`` and ``[profile]``, refused
    until checkpoint resume and telemetry were ported, now hold that the
    run writes the log and the Chrome trace into the directory named;
    ``[resume]`` and ``[resize]`` (refused until elastic resize was
    ported) that a value outside ``auto|none`` or ``strict|auto`` is
    refused by argparse, as the JAX CLI's choices refuse it."""
    monkeypatch.chdir(tmp_path)
    argv = SMALL + ["--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu",
                    "--" + flag.replace("_", "-"), "1"]
    if error is None:
        train_main(argv)
        if match is not None:
            assert [p.name for p in (tmp_path / "1").iterdir()
                    if p.name.endswith(match)]
        return
    with pytest.raises(error) as raised:
        train_main(argv)
    said = str(raised.value) if error is not SystemExit \
        else capsys.readouterr().err
    assert match in said


def test_train_cli_refuses_unported_choices(tmp_path):
    """``--backend sharded|islands``, refused until the islands were
    ported, run here as a world of one (one island)."""
    for backend in ("sharded", "islands"):
        report = train_main(SMALL + ["--ckpt-dir", str(tmp_path / backend),
                                     "--device", "cpu", "--backend",
                                     backend])
        assert report.trainer.layout.islands == 1
    base = SMALL + ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    # dvd, which the JAX CLI does not offer either
    with pytest.raises(SystemExit):
        train_main(base + ["--strategy", "dvd"])


def test_train_cli_refuses_a_used_ckpt_dir(tmp_path):
    """The CLI resumes from a used ``--ckpt-dir`` now (it refused any
    before resume was ported): a checkpoint of another structure than the
    run's is refused by the restore's leaf-count check."""
    CheckpointManager(tmp_path).save(
        0, {"x": np.zeros(2, np.float32)}, {"size": 1, "fitness": None})
    with pytest.raises(ValueError, match="holds 1 leaves but the restore "
                       "template has"):
        train_main(SMALL + ["--ckpt-dir", str(tmp_path), "--device", "cpu"])
