"""Checkpoint resume on the port, held on the CPU: the trainer's restore
writes into its own tensors (an ``LMAgent``'s flat-buffer views, the
engine's buffers and env states, which a captured epoch holds as its
static inputs); the train CLI run twice on one ``--ckpt-dir`` resumes (TD3)
and equals the uninterrupted run bit for bit (the LM, ``--resume auto``);
a resume onto another population size raises; the overlapped engine's
import clears its pending slot. ``test_torch_checkpoint_resume.py`` holds
the manager, the crossing with JAX and the trainer-level bitwise resumes.
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import PopulationConfig
from repro_torch.envs import make
from repro_torch.launch.train import main as train_main
from repro_torch.pop import PopTrainer
from repro_torch.rl import get_algo, make_agent
from repro_torch.tree import leaves

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


def test_resume_writes_into_the_trainers_own_tensors(tmp_path):
    """Every leaf keeps its storage: the engine's buffers and env states
    and the population state (a captured epoch holds them as its static
    inputs)."""
    run = _trainer(tmp_path)
    run.run_env_loop(2, eval_every=1)
    run.save(blocking=True)
    again = _trainer(tmp_path)
    again.run_env_loop(1, eval_every=1)     # past the fresh, shared zeros
    before = [x.data_ptr() for x in leaves((again.state, again.hypers,
                                            again.rollout.export_state()))]
    again.resume()
    after = [x.data_ptr() for x in leaves((again.state, again.hypers,
                                           again.rollout.export_state()))]
    assert before == after
    assert _equal(run.state, again.state)


def test_lm_resume_keeps_the_flat_buffer_views(tmp_path):
    from repro_torch.configs import (HyperSpace, TrainConfig, get_config)
    from repro_torch.pop import LMAgent
    from repro_torch.tree import flat_buffer

    def lm_trainer():
        cfg = get_config("qwen2-0.5b").smoke().replace(num_layers=1)
        pcfg = PopulationConfig(size=2, pbt_interval=2, hyper_space=HyperSpace(
            log_uniform=(("lr_scale", 0.1, 10.0),)))
        return PopTrainer(LMAgent(cfg, TrainConfig(total_steps=4),
                                  device="cpu"), pcfg, seed=0,
                          checkpoint_dir=tmp_path)

    tokens = torch.randint(0, 512, (2, 2, 16), generator=torch.Generator()
                           .manual_seed(0))
    run = lm_trainer()
    run.run(2, lambda step: {"tokens": tokens})
    run.save(blocking=True)
    again = lm_trainer()
    buffer = flat_buffer(again.state.params)
    ptrs = [x.data_ptr() for x in leaves(again.state)]
    assert again.resume() == 1
    assert [x.data_ptr() for x in leaves(again.state)] == ptrs
    assert flat_buffer(again.state.params) is buffer
    assert _equal(run.state, again.state)


def test_lm_cli_resume_equals_the_uninterrupted_run(tmp_path, capsys):
    """4 steps with a checkpoint at step 2, against the same 4 steps
    resumed from that checkpoint through ``--resume auto``: the final
    checkpoints are equal bit for bit (the token stream resumes at step
    3)."""
    argv = ["--arch", "qwen2-0.5b", "--smoke", "--population", "2",
            "--steps", "4", "--pbt-interval", "2", "--batch", "2",
            "--seq-len", "16", "--ckpt-every", "2", "--device", "cpu"]
    train_main(argv + ["--ckpt-dir", str(tmp_path / "whole")])
    shutil.copytree(tmp_path / "whole" / f"step_{1:010d}",
                    tmp_path / "resumed" / f"step_{1:010d}")
    train_main(argv + ["--ckpt-dir", str(tmp_path / "resumed"),
                       "--resume", "auto"])
    assert "resumed from step 1" in capsys.readouterr().out
    whole, resumed = (CheckpointManager(tmp_path / d) for d in
                      ("whole", "resumed"))
    assert whole.latest() == resumed.latest() == 3
    for name in ("arrays", "aux_actors", "aux_hypers", "aux_rng"):
        with np.load(whole.dir / f"step_{3:010d}" / f"{name}.npz") as a, \
                np.load(resumed.dir / f"step_{3:010d}" / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])


def test_rl_cli_twice_on_one_ckpt_dir_resumes(tmp_path, capsys):
    argv = ["--algo", "td3", "--population", "3", "--steps", "2",
            "--pbt-interval", "2", "--eval-every", "1", "--num-envs", "2",
            "--collect-steps", "8", "--updates-per-iter", "2", "--batch",
            "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = train_main(argv)
    second = train_main(argv)
    assert "resumed at trainer step 2" in capsys.readouterr().out
    assert first.trainer.step_count == 2 and second.trainer.step_count == 4
    assert CheckpointManager(tmp_path).all_steps() == [1, 3]
    fresh = train_main(argv + ["--resume", "none"])
    assert fresh.trainer.step_count == 2


def test_resume_refuses_another_population_size(tmp_path):
    _trainer(tmp_path, n=3).save(blocking=True)
    with pytest.raises(ValueError, match=r"population of 3 .* size=4.*"
                       r"elastic resume"):
        _trainer(tmp_path, n=4).resume()


def test_overlap_import_state_clears_the_pending_slot(tmp_path):
    run = _trainer(tmp_path, policy_lag=1)
    run.run_env_loop(2, eval_every=1)
    assert run.rollout._pending is not None
    run.save(blocking=True)
    run.resume()
    assert run.rollout._pending is None
    state = run.rollout.export_state()
    with pytest.raises(ValueError, match="holds 3 members but the engine "
                       "was built for 4"):
        _trainer(tmp_path / "four", n=4).rollout.import_state(state)


def test_lag1_checkpoint_holds_the_pending_collects_env_states(tmp_path):
    """At lag 1 a save lands while the next collect is pending: the
    checkpoint's ``rollout`` tree holds that collect's env states, the ones
    the resumed engine acts from (on the card the copy waits for the
    collect's event)."""
    run = _trainer(tmp_path, policy_lag=1)
    run.run_env_loop(2, eval_every=1)
    assert run.rollout._pending is not None
    run.save()
    run.wait()
    mgr = CheckpointManager(tmp_path)
    saved = mgr.restore_aux("rollout", run.rollout.export_state())
    mine = run.rollout.export_state()
    assert all(np.array_equal(a, b.numpy())
               for a, b in zip(leaves(saved), leaves(mine)))
