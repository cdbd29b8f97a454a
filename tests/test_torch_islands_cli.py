"""The train CLI's multi-rank flags on the CPU.

``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
repro_torch.launch.train ... --device cpu --backend islands`` (two gloo
ranks) writes the checkpoint a one-rank run writes, bit for bit, and the
islands runs of both the RL and the LM workloads print their layout.
``--devices`` other than 0 or the world size, ``--model-axis`` above 1
beside another backend than islands, ``--fused-epoch`` (CEM beside it
too) and ``--policy-lag 1`` over more than one island, another backend on
a world of two, and a shared critic in a trainer over islands are refused
by name (the world is set through ``WORLD_SIZE`` in-process: the
refusals come before any group is joined); CEM and DvD in a trainer over
islands and over model-sharded members pass. The ``pbt_td3`` example
takes ``--backend islands``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.elastic import plan_layout
from repro_torch.launch.train import main as train_main
from repro_torch.pop import PopTrainer
from test_torch_islands import agent_td3

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RL = ["--algo", "td3", "--population", "4", "--steps", "4",
      "--pbt-interval", "2", "--eval-every", "1", "--num-envs", "2",
      "--collect-steps", "8", "--updates-per-iter", "2", "--batch", "16",
      "--device", "cpu"]


def _run(args, ranks, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks)] if ranks else [sys.executable])
    r = subprocess.run(launch + ["-m", "repro_torch.launch.train", *args],
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def _same_checkpoints(a, b):
    steps = sorted(p.name for p in a.iterdir())
    assert steps and steps == sorted(p.name for p in b.iterdir())
    for step in steps:
        for f in sorted((a / step).glob("*.npz")):
            x, y = np.load(f), np.load(b / step / f.name)
            assert x.files == y.files
            for key in x.files:
                np.testing.assert_array_equal(x[key], y[key])


def test_two_gloo_ranks_through_torch_distributed_run(tmp_path):
    one = _run(RL + ["--backend", "islands", "--ckpt-dir",
                     str(tmp_path / "one")], 0)
    two = _run(RL + ["--backend", "islands", "--ckpt-dir",
                     str(tmp_path / "two")], 2)
    assert "1 island," in one and "2 islands, rank 0 holds members 0..1" \
        in two
    # rank 0 prints: the same lines, once
    keep = lambda out: [line for line in out.splitlines()
                        if line.startswith("[train] iter")
                        or line.startswith("[train] evolve")]
    assert keep(one) == keep(two) and len(keep(two)) == 6
    _same_checkpoints(tmp_path / "one", tmp_path / "two")


def test_lm_islands_on_two_ranks(tmp_path):
    lm = ["--arch", "rwkv6-test", "--smoke", "--population", "4",
          "--steps", "4", "--pbt-interval", "2", "--batch", "2",
          "--seq-len", "32", "--device", "cpu", "--backend", "islands"]
    one = _run(lm + ["--ckpt-dir", str(tmp_path / "one")], 0)
    two = _run(lm + ["--ckpt-dir", str(tmp_path / "two")], 2)
    last = lambda out: [line for line in out.splitlines()
                        if "loss by member" in line or "evolve" in line]
    assert last(one) == last(two)
    _same_checkpoints(tmp_path / "one", tmp_path / "two")


_REFUSALS = (
    (["--devices", "4"], 2, ValueError, "--nproc-per-node 4"),
    (["--model-axis", "2", "--backend", "vectorized"], 1, ValueError,
     "taken by --backend islands only"),
    (["--fused-epoch"], 2, NotImplementedError, "--fused-epoch over more"),
    (["--policy-lag", "1"], 2, NotImplementedError, "--policy-lag 1 over"),
    # CEM runs over islands now; beside a fused epoch the epoch's refusal
    # stands
    (["--strategy", "cem", "--fused-epoch"], 2, NotImplementedError,
     "--fused-epoch over more"),
    (["--backend", "vectorized"], 2, ValueError, "runs on one rank"),
)


@pytest.mark.parametrize("flags, world, error, match", _REFUSALS,
                         ids=["devices", "model_axis", "fused_epoch",
                              "policy_lag", "cem", "one_rank_backend"])
def test_refusals_by_name(tmp_path, monkeypatch, flags, world, error, match):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    argv = RL + ["--backend", "islands", "--ckpt-dir", str(tmp_path)] + flags
    with pytest.raises(error, match=match):
        train_main(argv)
    assert not list(tmp_path.iterdir())      # refused before it ran


def test_trainer_refuses_cem_dvd_and_model_axis_over_islands(tmp_path):
    """CEM and DvD run over islands and over model-sharded members now:
    on the layout of 2 ranks (planned with JAX's halving warning) a TD3
    trainer under either, and an MoE member under CEM at model 2, pass
    every refusal and stop only at the ranks the layout needs. What still
    stands is the JAX package's: a shared critic is replicated, not split,
    so the islands backend refuses it by name before any state is made."""
    from repro_torch.pop import SharedCriticAgent
    for strategy in ("cem", "dvd"):
        pcfg = PopulationConfig(size=4, strategy=strategy, backend="islands")
        with pytest.raises(ValueError,
                           match="needs 2 ranks but the world has 1"):
            PopTrainer(agent_td3(), pcfg, layout=plan_layout(2, 4))
        with pytest.raises(ValueError, match="requires per-member agents"):
            PopTrainer(SharedCriticAgent(3, 1, device="cpu"), pcfg)
    pcfg = PopulationConfig(size=4, backend="islands")
    with pytest.warns(UserWarning, match="preferred_model=4"):
        layout = plan_layout(2, 4, preferred_model=4)
    assert layout.model == 2
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.pop import LMAgent
    moe = LMAgent(get_config("qwen3-moe-30b-a3b").smoke(), TrainConfig(),
                  device="cpu")
    cem = PopulationConfig(size=4, strategy="cem", backend="islands")
    for cfg in (cem, pcfg):
        with pytest.raises(ValueError,
                           match="needs 2 ranks but the world has 1"):
            PopTrainer(moe, cfg, layout=layout)


def test_pbt_td3_example_takes_islands(capsys):
    from repro_torch.examples import pbt_td3
    best = pbt_td3.main(["--population", "2", "--iters", "2", "--backend",
                         "islands", "--device", "cpu"])
    assert np.isfinite(best)
