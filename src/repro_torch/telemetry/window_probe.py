"""How many of a profile window's kernels reach its Chrome trace when the
window opens minutes after the process's previous one.

    PYTHONPATH=src python -m repro_torch.telemetry.window_probe [--gap 230]

One process an arm, all side by side. Each profiles a window of
``--iters`` small products (3 launches each) at its start and another
one ``--gap`` seconds later (``--gap`` x 2 for ``spread_long``), and
prints one JSON line: ``{"arm", "early", "late", "gap_s"}``, ``early``
and ``late`` each window's counts. A trace that loses kernels has
``late["kernels"]`` below ``late["launches"]``. The arms:

``bare``
    a plain ``torch.profiler`` session, the window's launches right
    after its start: the fault.
``profiler``
    :meth:`RunTelemetry.start_profile` and ``stop_profile`` as they are,
    with their bursts of throwaway launches (:func:`repro_torch.
    telemetry.run.profiler_burst`) at each end of the session: the cure.
``settle``
    as ``bare``, with a wait of ``SETTLE_S`` between the window's start
    and its first launch.
``sync_after``
    as ``bare``, with ``torch.cuda.synchronize()`` between the window's
    start and its first launch.
``warmup``
    a ``torch.profiler`` schedule with one warm-up step (one small
    kernel) before the active step that holds the window.
``warmup_own``
    a ``schedule(wait=0, warmup=1, active=1)`` session whose warm-up step
    runs the window's own products once (on an H100 its late window kept
    none of its kernels, as ``bare``: not a cure).
``many``
    as ``bare``, with 64 products: whether the kernels lost are the
    first few launches or the first milliseconds.
``spread``, ``spread_long``
    as ``bare``, the window's products in bursts at ``SPREAD_S`` seconds
    after its start: which bursts the trace keeps says how long after the
    session starts kernels begin to be recorded.
Each window's counts (a ``profiler`` window's include its throwaway
launches): ``launches`` (the runtime's launch events in
the trace), ``kernels`` (kernel events), ``kept`` (for each launch in order,
whether its kernel is in the trace, by correlation id), ``first_kept_ms``
(the first kept launch's time after the window's first launch) and
``lag_us`` (the least of kernel start minus its launch's start over the
kept kernels; negative if the card's timestamps ran behind the host's).
Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ARMS = ("bare", "profiler", "settle", "sync_after", "warmup", "warmup_own",
        "many", "spread", "spread_long")
SETTLE_S = 0.5
SPREAD_S = (0.0, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.15, 0.2,
            0.3, 0.5, 1.0)


def _counts(trace_dir) -> dict:
    """Launch and kernel events of the traces under ``trace_dir``."""
    events = [e for path in Path(trace_dir).glob("*.json")
              for e in json.loads(path.read_text()).get("traceEvents", [])]
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])
    kernels = {e.get("args", {}).get("correlation"): e for e in events
               if e.get("cat") == "kernel"}
    kept = [e.get("args", {}).get("correlation") in kernels
            for e in launches]
    lags = [kernels[e["args"]["correlation"]]["ts"] - e["ts"]
            for e, k in zip(launches, kept) if k]
    first = next((e["ts"] for e, k in zip(launches, kept) if k), None)
    return {"launches": len(launches), "kernels": len(kernels),
            "kept": kept, "lag_us": min(lags) if lags else None,
            "first_kept_ms": (None if first is None
                              else (first - launches[0]["ts"]) / 1e3)}


def _products(x, iters: int):
    for _ in range(iters):
        torch.relu_(x @ x)


def window(arm: str, iters: int) -> dict:
    """Profile ``iters`` products on the card through ``arm``; the trace's
    counts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.telemetry.run import RunTelemetry

    x = torch.ones(256, 256, device="cuda")
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as d:
        if arm == "profiler":
            tel = RunTelemetry()
            tel.start_profile(d)
            _products(x, iters)
            torch.cuda.synchronize()
            tel.stop_profile()
            return _counts(d)
        if arm in ("warmup", "warmup_own"):
            prof = profile(activities=activities,
                           schedule=schedule(wait=0, warmup=1, active=1))
            prof.start()
            if arm == "warmup":
                x.add_(0)
            else:
                _products(x, iters)
            torch.cuda.synchronize()
            prof.step()
            _products(x, iters)
            torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(str(Path(d) / "w.trace.json"))
            return _counts(d)
        prof = profile(activities=activities)
        prof.__enter__()
        if arm == "settle":
            time.sleep(SETTLE_S)
        if arm == "sync_after":
            torch.cuda.synchronize()
        if arm.startswith("spread"):
            t0 = time.perf_counter()
            for at in SPREAD_S:
                time.sleep(max(0.0, at - (time.perf_counter() - t0)))
                _products(x, iters)
        else:
            _products(x, 64 if arm == "many" else iters)
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(Path(d) / "w.trace.json"))
        return _counts(d)


def run_arm(arm: str, gap: float, iters: int) -> dict:
    early = window(arm, iters)
    t0 = time.perf_counter()
    time.sleep(2 * gap if arm == "spread_long" else gap)
    late = window(arm, iters)
    return {"arm": arm, "early": early, "late": late,
            "gap_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gap", type=float, default=230.0,
                    help="seconds between a process's two windows")
    ap.add_argument("--iters", type=int, default=3,
                    help="products in a window (a burst, for spread)")
    ap.add_argument("--arm", choices=ARMS, action="append",
                    help="run this arm (repeatable; default: all, side by "
                    "side)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_probe needs the card", file=sys.stderr)
        return 2
    if args.arm and len(args.arm) == 1:
        print(json.dumps(run_arm(args.arm[0], args.gap, args.iters)),
              flush=True)
        return 0
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.telemetry.window_probe",
         "--arm", arm, "--gap", str(args.gap), "--iters", str(args.iters)])
        for arm in (args.arm or ARMS)]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
