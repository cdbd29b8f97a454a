"""The elastic resume through the port's train CLI, and the two examples
that came with it, on the CPU.

``--resize auto`` resumes a checkpoint written at another ``--population``
(TD3 smaller and larger; an LM population) and prints the lineage;
``--resize strict`` (the default) raises a message that names ``--resize
auto``, and ``PopTrainer.resume`` one that names ``restore_elastic``;
``--devices`` other than 0 or the world size and ``--model-axis``
beside another backend stay refused, and CEM over model-sharded members
passes the pre-group checks (the islands themselves are
``test_torch_islands*.py``'s). ``quickstart``
and ``pbt_td3`` (``repro_torch.examples``) run two iterations each.
Nothing here calls JAX. (Under 11 tests: ROADMAP §3 on xdist's file
queue.)
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.train import main as train_main
from repro_torch.tree import leaves

# one intra-op thread per process: the shapes here are small, and the
# suite's parallel workers would otherwise oversubscribe the cores
torch.set_num_threads(1)

RL = ["--algo", "td3", "--steps", "2", "--pbt-interval", "0",
      "--eval-every", "1", "--num-envs", "2", "--collect-steps", "8",
      "--updates-per-iter", "2", "--batch", "16", "--device", "cpu"]
LM = ["--arch", "rwkv6-test", "--smoke", "--pbt-interval", "2", "--batch",
      "2", "--seq-len", "32", "--ckpt-every", "2", "--device", "cpu"]


def _lineage(out):
    found = re.findall(r"elastic resume from step (\d+): population "
                       r"(\d+) -> (\d+), lineage=\[([\d, ]*)\]", out)
    assert len(found) == 1, out
    step, old, new, lineage = found[0]
    return int(step), int(old), int(new), [int(x) for x in
                                           lineage.split(",")]


def test_rl_cli_resize_auto_shrinks_and_grows(tmp_path, capsys):
    """TD3 at 4 members, then 3 and 6 on the same --ckpt-dir: each run
    resumes the last one's checkpoint by its fitness (no evolve, so the
    checkpoint carries the window's mean), prints the lineage and trains
    on."""
    train_main(RL + ["--population", "4", "--ckpt-dir", str(tmp_path)])
    capsys.readouterr()
    mgr = CheckpointManager(tmp_path)
    fitness = np.asarray(mgr.peek_extra()["fitness"])
    small = train_main(RL + ["--population", "3", "--ckpt-dir",
                             str(tmp_path), "--resize", "auto"])
    step, old, new, lineage = _lineage(capsys.readouterr().out)
    assert (step, old, new) == (1, 4, 3)
    assert lineage == sorted(np.argsort(fitness)[::-1][:3].tolist())
    assert small.trainer.n == 3 and small.trainer.step_count == 4
    assert leaves(small.trainer.actors)[0].shape[0] == 3
    fitness = np.asarray(mgr.peek_extra()["fitness"])
    large = train_main(RL + ["--population", "6", "--ckpt-dir",
                             str(tmp_path), "--resize", "auto"])
    step, old, new, lineage = _lineage(capsys.readouterr().out)
    rank = np.argsort(fitness)[::-1].tolist()
    assert (step, old, new) == (3, 3, 6)
    assert lineage == [0, 1, 2] + rank
    assert large.trainer.step_count == 6
    assert mgr.peek_extra()["size"] == 6


def test_rl_cli_resize_strict_raises_and_names_auto(tmp_path):
    train_main(RL + ["--population", "3", "--ckpt-dir", str(tmp_path)])
    for extra in ([], ["--resize", "strict"]):
        with pytest.raises(ValueError, match="--resize auto"):
            train_main(RL + ["--population", "4", "--ckpt-dir",
                             str(tmp_path)] + extra)
    with pytest.raises(ValueError, match="restore_elastic"):
        train_main(RL + ["--population", "2", "--ckpt-dir", str(tmp_path)])
    # the same size resumes as before, --resize auto or not
    again = train_main(RL + ["--population", "3", "--ckpt-dir",
                             str(tmp_path), "--resize", "auto"])
    assert again.trainer.step_count == 4


def test_lm_cli_resize_auto(tmp_path, capsys):
    """An LM population of 3, resumed at 2 and at 5: the lineage printed,
    the members' leaves still views of their flat buffers, the token
    stream resumed with the new population's batch."""
    train_main(LM + ["--population", "3", "--steps", "2", "--ckpt-dir",
                     str(tmp_path)])
    capsys.readouterr()
    small = train_main(LM + ["--population", "2", "--steps", "4",
                             "--ckpt-dir", str(tmp_path), "--resize",
                             "auto"])
    assert _lineage(capsys.readouterr().out)[:3] == (1, 3, 2)
    large = train_main(LM + ["--population", "5", "--steps", "6",
                             "--ckpt-dir", str(tmp_path), "--resize",
                             "auto"])
    step, old, new, lineage = _lineage(capsys.readouterr().out)
    assert (step, old, new) == (3, 2, 5) and lineage[:2] == [0, 1]
    for report, n in ((small, 2), (large, 5)):
        params = report.trainer.state.params
        assert leaves(params)[0]._base is not None
        assert leaves(params)[0]._base.shape[0] == n
        assert np.isfinite(report.final_loss)
    with pytest.raises(ValueError, match="--resize auto"):
        train_main(LM + ["--population", "4", "--steps", "8", "--ckpt-dir",
                         str(tmp_path)])


def test_multi_device_flags_stay_refused(monkeypatch):
    """Islands over several ranks and model-sharded members are ported
    (one rank per GPU under ``torch.distributed.run``): ``--devices`` must
    be 0 or the world size (one here), and ``--model-axis`` is taken by
    the islands backend only. An MoE config at model 2, under CEM (no
    longer refused over model-sharded members) as under PBT, passes every
    check on a world of 2 set through ``WORLD_SIZE``: its run stops only
    where the process group is joined, for want of a ``RANK``."""
    for flag, error, match in (
            (["--devices", "4"], ValueError, "--nproc-per-node 4"),
            (["--model-axis", "2"], ValueError,
             "taken by --backend islands only")):
        with pytest.raises(error, match=match):
            train_main(RL + ["--population", "2", "--ckpt-dir", "unused"]
                       + flag)
    monkeypatch.setenv("WORLD_SIZE", "2")
    moe = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--population", "2",
           "--ckpt-dir", "unused", "--device", "cpu", "--backend",
           "islands", "--model-axis", "2"]
    with pytest.raises(ValueError, match="RANK"):
        train_main(moe + ["--strategy", "cem"])
    with pytest.raises(ValueError, match="RANK"):
        train_main(moe)       # the group's rendezvous: no RANK set here


def test_quickstart_example_runs(capsys):
    from repro_torch.examples import quickstart
    trainer = quickstart.run(iters=2, device="cpu")
    out = capsys.readouterr().out
    assert "OK — 8 agents trained in one vectorized stream" in out
    assert "[rollout 1]" in out and trainer.step_count == 2
    assert all(torch.isfinite(x).all() for x in leaves(trainer.state)
               if x.is_floating_point())


def test_pbt_td3_example_runs(tmp_path, capsys):
    from repro_torch.examples import pbt_td3
    best = pbt_td3.run(population=3, iters=2, num_envs=2, collect_steps=8,
                       updates_per_iter=2, batch_size=16,
                       ckpt_dir=str(tmp_path), device="cpu")
    assert np.isfinite(best)
    out = capsys.readouterr().out
    assert "[engine]" in out and "[run_end]" in out
