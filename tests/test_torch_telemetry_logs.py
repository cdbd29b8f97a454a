"""The logs of the port's train CLI (TD3 under PBT, an LM with a
profile), serve CLI (RL and LM, with profiles) and the PBT-PPO example,
written on the CPU, pass ``tools/report.py --check``, and the report's
family tree, hyper trajectories and phase totals come out of them, equal
to what the runs returned. ``test_torch_telemetry.py`` holds the sinks
and ``RunTelemetry`` against the JAX package's.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))
import report  # noqa: E402

TD3 = ["--algo", "td3", "--population", "3", "--steps", "4",
       "--pbt-interval", "2", "--eval-every", "1", "--num-envs", "2",
       "--collect-steps", "8", "--updates-per-iter", "2", "--batch", "16",
       "--device", "cpu"]


def _check(log):
    out = subprocess.run([sys.executable, str(TOOLS / "report.py"),
                          str(log), "--check"], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    return report.load_rows(log)


def test_td3_pbt_log_reconstructs_lineage_and_hypers(tmp_path):
    run = train_main(TD3 + ["--ckpt-dir", str(tmp_path / "ck"),
                            "--log-dir", str(tmp_path / "log")])
    rows = _check(tmp_path / "log")
    kinds = {r["kind"] for r in rows}
    assert {"run", "engine", "iter", "members", "evolve", "ckpt",
            "run_end"} <= kinds
    evolves = report.by_kind(rows, "evolve")
    assert [r["step"] for r in evolves] == [2, 4]
    assert [r["parents"] for r in evolves] == [lin for _, lin in
                                               run.evolutions]
    roots, children, current = report.lineage_tree(rows)
    assert len(roots) == 3 and len(current) == 3
    traj = report.hyper_trajectories(rows)
    assert set(traj) == set(run.trainer.hypers)
    final = {k: v.tolist() for k, v in run.trainer.hypers.items()}
    assert {k: v[-1][1] for k, v in traj.items()} == pytest.approx(final)
    phases = report.phase_summary(rows)
    assert {"iterate", "eval", "evolve"} <= set(phases)
    ckpt = report.by_kind(rows, "ckpt")
    assert [r["step"] for r in ckpt] == [3] and ckpt[0]["blocking"] is False
    extra = json.loads((tmp_path / "ck" / f"step_{3:010d}" / "meta.json")
                       .read_text())["extra"]
    assert extra["run"]["run_id"] == rows[0]["run_id"]


def test_lm_log_passes_the_report_check(tmp_path):
    train_main(["--arch", "qwen2-0.5b", "--smoke", "--population", "2",
                "--steps", "4", "--pbt-interval", "2", "--batch", "2",
                "--seq-len", "16", "--ckpt-dir", str(tmp_path / "ck"),
                "--device", "cpu", "--log-dir", str(tmp_path / "log"),
                "--profile", str(tmp_path / "trace"), "--profile-iters",
                "1"])
    rows = _check(tmp_path / "log")
    iters = report.by_kind(rows, "iter")
    assert [r["step"] for r in iters] == [0, 1, 2, 3]
    assert all({"update", "data"} <= set(r["phases"]) for r in iters[1:])
    assert all(r["tokens_per_sec_per_member"] > 0 for r in iters[1:])
    assert len(iters[0]["metrics"]["loss"]) == 2
    assert [r["step"] for r in report.by_kind(rows, "evolve")] == [2, 4]
    assert report.hyper_trajectories(rows)
    actions = [r["action"] for r in report.by_kind(rows, "profile")]
    assert actions == ["start", "stop"]
    assert list((tmp_path / "trace").glob("*.trace.json"))
    assert report.by_kind(rows, "run_end")[0]["final_loss"] > 0


def test_serve_cli_logs_and_profiles_both_branches(tmp_path):
    ck = tmp_path / "ck"
    train_main(TD3 + ["--ckpt-dir", str(ck), "--steps", "2"])
    serve_main(["--algo", "td3", "--ckpt-dir", str(ck), "--batch", "8",
                "--requests", "10", "--poll-every", "4",
                "--telemetry-every", "4", "--device", "cpu",
                "--log-dir", str(tmp_path / "rl"), "--profile",
                str(tmp_path / "trace"), "--profile-iters", "2"])
    rows = _check(tmp_path / "rl")
    serve = report.by_kind(rows, "serve")
    assert [r["count"] for r in serve] == [4, 4, 3]   # 11 batches, warmup
    assert all(r["p50_ms"] > 0 for r in serve)        # excluded
    assert sorted(report.by_kind(rows, "promotion")[0]["members"]) == \
        [0, 1, 2]
    assert report.by_kind(rows, "run_end")[0]["requests"] == 80
    serve_main(["--arch", "rwkv6-test", "--smoke", "--batch", "1",
                "--prompt-len", "8", "--tokens", "2", "--device", "cpu",
                "--log-dir", str(tmp_path / "lm"), "--profile",
                str(tmp_path / "trace")])
    rows = _check(tmp_path / "lm")
    assert rows[0]["meta"]["workload"] == "serve-lm"
    assert report.by_kind(rows, "run_end")[0]["tokens"] == 2
    traces = list((tmp_path / "trace").glob("*.trace.json"))
    assert len(traces) == 2
    assert all(json.loads(t.read_text())["traceEvents"] for t in traces)


def test_pbt_ppo_example_log(tmp_path):
    from repro_torch.examples import pbt_ppo

    out = pbt_ppo.run(population=3, iters=10, num_envs=2, collect_steps=8,
                      batch_size=8, epochs=1, pbt_every=5, device="cpu",
                      ckpt_dir=tmp_path / "ck", log_dir=tmp_path / "log")
    rows = _check(tmp_path / "log")
    assert [r["step"] for r in report.by_kind(rows, "evolve")] == [5, 10]
    assert report.by_kind(rows, "run_end")[0]["best_fitness"] == \
        pytest.approx(out["best_fitness"])
    assert [r["step"] for r in report.by_kind(rows, "ckpt")] == [9]
