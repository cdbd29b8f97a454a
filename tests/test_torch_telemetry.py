"""The port's run telemetry, held on the CPU against the JAX package's.

The sinks write what the JAX package's write for the same rows, line for
line bar the stamped ``t`` (numpy values on both sides; the port's torch
tensors too), NaN stringified, strict close, CSV and console included. A
row's tensors are snapshotted when it is recorded, so an in-place write
after it does not reach the log, and concurrent writers lose no row. A
fused epoch's rows hold what the loop returned; ``block_every`` records
waits. ``test_torch_telemetry_logs.py`` holds the CLIs' and an example's
logs through ``tools/report.py``. (Each file stays under 11 tests: see
ROADMAP §3 on xdist's file queue.)
"""
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.telemetry import sink as jax_sink
from repro_torch.kernels.build import notify_compile
from repro_torch.launch.train import main as train_main
from repro_torch.telemetry import (ROW_KINDS, CSVSink, ConsoleSink,
                                   JSONLSink, MultiSink, NullSink,
                                   RunTelemetry, make_telemetry,
                                   validate_row)
from test_torch_jax_listeners import drop_leaked_jax_listeners  # noqa: F401

torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))
import report  # noqa: E402

TD3 = ["--algo", "td3", "--population", "3", "--steps", "4",
       "--pbt-interval", "2", "--eval-every", "1", "--num-envs", "2",
       "--collect-steps", "8", "--updates-per-iter", "2", "--batch", "16",
       "--device", "cpu"]


def _rows(t=1.5):
    """One row of every known kind, plus a user kind, with arrays,
    non-finite floats and nesting."""
    return [
        {"kind": "run", "t": t, "run_id": "r", "meta": {"a": 1}},
        {"kind": "iter", "t": t, "step": 3, "phases": {"update": 0.25},
         "metrics": {"loss": np.array([1.0, np.nan, np.inf], np.float32)}},
        {"kind": "members", "t": t, "step": 3,
         "fitness": np.array([-1.5, 2.0]), "hypers": {
             "lr": np.array([1e-3, 3e-4], np.float32)}},
        {"kind": "evolve", "t": t, "step": 4, "parents": np.array([0, 0]),
         "strategy": "PBT"},
        {"kind": "compile", "t": t, "event": "pop_matmul", "secs": 2.5,
         "label": "warmup"},
        {"kind": "ckpt", "t": t, "step": 4, "secs": 0.125,
         "blocking": False},
        {"kind": "serve", "t": t, "count": 3, "p50_ms": 1.0,
         "p99_ms": float("nan")},
        {"kind": "promotion", "t": t, "step": 4, "members": [1, 0]},
        {"kind": "engine", "t": t, "algo": "ModuleAgent"},
        {"kind": "profile", "t": t, "action": "start"},
        {"kind": "diversity", "t": t, "logdet": np.float32(-3.25)},
        {"kind": "scalar", "t": t, "x": np.int64(7), "y": 0.5, "z": None},
    ]


def _as_torch(row):
    """The row with its numpy arrays as CPU tensors."""
    def conv(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v
    return conv(row)


def test_jsonl_matches_the_jax_sink_line_for_line(tmp_path):
    rows = _rows()
    with jax_sink.JSONLSink(tmp_path / "jax.jsonl") as theirs:
        for row in rows:
            theirs.write(row)
    for name, conv in (("numpy", lambda r: r), ("torch", _as_torch)):
        with JSONLSink(tmp_path / f"{name}.jsonl") as ours:
            for row in rows:
                ours.write(conv(row))
        assert (tmp_path / f"{name}.jsonl").read_text() == \
            (tmp_path / "jax.jsonl").read_text()
    lines = (tmp_path / "jax.jsonl").read_text().splitlines()
    assert len(lines) == len(rows)
    assert json.loads(lines[1])["metrics"]["loss"] == [1.0, "nan", "inf"]


def test_missing_t_is_stamped_and_strict_close_raises_like_jax(tmp_path):
    bad = [{"kind": "iter", "t": 0.0, "step": 1}, {"t": 1.0},
           {"kind": "x"}]
    for mod, name in ((jax_sink, "jax"), (None, "port")):
        cls = jax_sink.JSONLSink if mod else JSONLSink
        strict = cls(tmp_path / f"{name}.jsonl", strict=True)
        for row in bad:
            strict.write(dict(row))
        with pytest.raises(ValueError, match="telemetry sink saw invalid"):
            strict.close()
        lax = cls(tmp_path / f"{name}_lax.jsonl")
        for row in bad:
            lax.write(dict(row))
        lax.close()
    for name in ("jax_lax", "port_lax"):
        rows = [json.loads(x) for x in
                (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        assert [r["kind"] for r in rows] == ["x"]
        assert isinstance(rows[0]["t"], float)     # stamped by the sink
    assert validate_row({"kind": "iter", "t": 0}) == \
        jax_sink.validate_row({"kind": "iter", "t": 0})
    # the schema the card's check applies is report.py --check's
    assert ROW_KINDS == jax_sink.ROW_KINDS


def test_csv_sink_matches_the_jax_sink(tmp_path):
    rows = _rows()
    with jax_sink.CSVSink(tmp_path / "jax" / "log.csv") as theirs, \
            CSVSink(tmp_path / "port" / "log.csv") as ours:
        for row in rows:
            theirs.write(row)
            ours.write(_as_torch(row))
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "log.iter.csv" in files
    for name in files:
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


def test_console_sink_matches_the_jax_sink(capsys):
    rows = _rows() * 3
    with jax_sink.ConsoleSink(every=2, prefix="> ") as theirs:
        for row in rows:
            theirs.write(row)
    said = capsys.readouterr().out
    with ConsoleSink(every=2, prefix="> ") as ours:
        for row in rows:
            ours.write(_as_torch(row))
    assert capsys.readouterr().out == said
    assert "[compile" not in said and said.count("[iter 3]") == 2


def test_multi_and_null_sinks(tmp_path):
    a, b = JSONLSink(tmp_path / "a.jsonl"), JSONLSink(tmp_path / "b.jsonl")
    with MultiSink([a, b]) as both:
        both.write({"kind": "x", "t": 0.0, "v": torch.tensor([1, 2])})
        both.flush()
        assert (tmp_path / "a.jsonl").read_text() == \
            (tmp_path / "b.jsonl").read_text() != ""
    NullSink().write({"kind": "x"})
    tel = RunTelemetry(None)
    assert not tel.enabled and tel.snapshot(torch.ones(2)) is None
    with tel.phase("update"):
        pass
    tel.record_members(0, hypers={"lr": torch.ones(2)})
    tel.record_iteration(0, metrics={"loss": torch.ones(2)})
    tel.close()


def test_rows_snapshot_tensors_when_recorded(tmp_path):
    """A population's tensors are stepped in place: the row holds the
    values at record time, not at write time."""
    tel = make_telemetry(tmp_path, console=False, device="cpu")
    hypers = {"lr": torch.tensor([1.0, 2.0])}
    metrics = {"loss": torch.tensor([0.5, 0.25])}
    tel.record_members(1, hypers=hypers, fitness=torch.tensor([3.0, 4.0]))
    tel.record_iteration(1, metrics=metrics, did_update=True)
    snap = tel.snapshot({"x": torch.arange(3)})
    tel.record("mine", part=snap.map(lambda t: t["x"][1:]))
    hypers["lr"].fill_(-1)
    metrics["loss"].fill_(-1)
    tel.close()
    rows = report.load_rows(tmp_path)
    assert rows[0]["kind"] == "run" and rows[0]["platform"] == "cpu"
    assert rows[0]["torch"] == torch.__version__
    assert rows[1]["hypers"] == {"lr": [1.0, 2.0]}
    assert rows[1]["fitness"] == [3.0, 4.0]
    assert rows[2]["metrics"] == {"loss": [0.5, 0.25]}
    assert rows[2]["did_update"] is True and rows[3]["part"] == [1, 2]


def test_concurrent_writers_lose_no_row(tmp_path):
    """Eight threads write rows holding parts of one shared snapshot, with
    the interpreter switching threads as often as it can: every row lands
    once, with its part's values (the snapshot's host copy is made once,
    under its lock)."""
    values = torch.arange(64, dtype=torch.float32)
    tel = make_telemetry(tmp_path, console=False, device="cpu")
    snap = tel.snapshot(values)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def writer(w):
            for i in range(100):
                tel.record("part", writer=w, i=i,
                           v=snap.map(lambda t, j=(w * 8 + i) % 64: t[j]))

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    tel.close()
    rows = report.by_kind(report.load_rows(tmp_path), "part")
    assert len(rows) == 800
    assert sorted((r["writer"], r["i"]) for r in rows) == \
        [(w, i) for w in range(8) for i in range(100)]
    assert all(r["v"] == float((r["writer"] * 8 + r["i"]) % 64)
               for r in rows)


def test_phases_blocks_and_compile_rows(tmp_path):
    tel = make_telemetry(tmp_path, console=False, device="cpu")
    with tel.phase("update"):
        pass
    tel.block("iterate", {"x": torch.ones(2)})
    notify_compile("pop_matmul", 1.25)           # before the first iter
    tel.record_iteration(0)
    with tel.compile_scope("promotion"):
        notify_compile("cuda_graph", 0.5)
    notify_compile("pop_adam", 0.25)
    tel.close()
    notify_compile("wkv6", 1.0)                  # unsubscribed by close
    rows = report.load_rows(tmp_path)
    it = report.by_kind(rows, "iter")[0]
    assert set(it["phases"]) == {"update"} and set(it["blocks"]) == \
        {"iterate"}
    compiles = [(r["event"], r["label"], r["count"])
                for r in report.by_kind(rows, "compile")]
    assert compiles == [("pop_matmul", "warmup", 1),
                        ("cuda_graph", "promotion", 2),
                        ("pop_adam", "steady", 3)]
    assert tel.compile_count == 3 and tel.compile_secs == 2.0


def test_fused_epoch_rows_equal_what_the_loop_returned(tmp_path):
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.envs import make
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import get_algo, make_agent

    tel = make_telemetry(tmp_path, console=False, device="cpu")
    trainer = PopTrainer(
        make_agent("td3", make("hopper2d").spec, device="cpu"),
        PopulationConfig(size=3, num_steps=2, pbt_interval=2,
                         hyper_space=get_algo("td3").hyper_space),
        seed=1, telemetry=tel)
    trainer.attach_rollout(make("hopper2d"), num_envs=2, collect_steps=4,
                           batch_size=16, buffer_capacity=256, eval_envs=2)
    seen = []
    trainer.run_env_loop(
        4, eval_every=1, fused=True,
        on_iter=lambda *a: seen.append(a))
    with pytest.raises(ValueError, match="block_every"):
        trainer.run_env_loop(2, eval_every=1, fused=True, block_every=1)
    tel.close()
    rows = report.load_rows(tmp_path)
    iters = report.by_kind(rows, "iter")
    assert [r["step"] for r in iters] == [0, 1, 2, 3]
    for row, (_, metrics, stats, fitness, _) in zip(iters, seen):
        assert set(row["phases"]) <= {"epoch"}
        if metrics is None:
            assert "metrics" not in row and row["did_update"] is False
            continue
        for k, v in metrics.items():
            assert row["metrics"][k] == v.tolist()
        for k, v in stats.items():
            assert row["stats"][k] == v.tolist()
    fits = [r["fitness"] for r in report.by_kind(rows, "members")
            if "fitness" in r]
    assert fits == [f.tolist() for *_, f, _ in seen]
    evolves = report.by_kind(rows, "evolve")
    assert [r["parents"] for r in evolves] == \
        [lin.tolist() for *_, lin in seen if lin is not None]


def test_eager_block_every_records_waits(tmp_path):
    run = train_main(TD3 + ["--ckpt-dir", str(tmp_path / "ck"),
                            "--steps", "2"])
    tel = make_telemetry(tmp_path / "log", console=False, device="cpu")
    run.trainer.telemetry = tel
    run.trainer.run_env_loop(2, eval_every=1, block_every=1)
    tel.close()
    iters = report.by_kind(report.load_rows(tmp_path / "log"), "iter")
    assert all(set(r["blocks"]) == {"iterate"} for r in iters)
