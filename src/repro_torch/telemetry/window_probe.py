"""How many of a profile window's kernels reach its Chrome trace when the
window opens minutes after the process's previous one, through
:meth:`RunTelemetry.start_profile` as it is (arm ``profiler``) and after
a throwaway session that records one small kernel (arm ``throwaway``, a
candidate remedy).

    PYTHONPATH=src python -m repro_torch.telemetry.window_probe [--gap 230]

Two processes run side by side, one an arm. Each profiles a window of
``--iters`` small products at its start and another one ``--gap``
seconds later, and prints one JSON line: ``{"arm", "early", "late",
"gap_s"}``, ``early`` and ``late`` the kernels each window's trace
holds. A trace that loses kernels has ``late`` below ``early``. Needs
the card.
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

ARMS = ("profiler", "throwaway")


def _kernels(trace_dir) -> int:
    return sum(e.get("cat") == "kernel"
               for path in Path(trace_dir).glob("*.json")
               for e in json.loads(path.read_text()).get("traceEvents", []))


def window(arm: str, iters: int) -> int:
    """Profile ``iters`` products on the card through ``arm``; the
    kernels the trace holds."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.telemetry.run import RunTelemetry

    x = torch.ones(256, 256, device="cuda")
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        tel = RunTelemetry()
        if arm == "throwaway":
            one = torch.zeros(1, device="cuda")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                one.add_(1)
                torch.cuda.synchronize()
        tel.start_profile(d)
        for _ in range(iters):
            torch.relu_(x @ x)
        torch.cuda.synchronize()
        tel.stop_profile()
        return _kernels(d)


def run_arm(arm: str, gap: float, iters: int) -> dict:
    early = window(arm, iters)
    t0 = time.perf_counter()
    time.sleep(gap)
    late = window(arm, iters)
    return {"arm": arm, "early": early, "late": late,
            "gap_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gap", type=float, default=230.0,
                    help="seconds between a process's two windows")
    ap.add_argument("--iters", type=int, default=3,
                    help="products in a window")
    ap.add_argument("--arm", choices=ARMS,
                    help="run this arm alone (default: both, side by side)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("window_probe needs the card", file=sys.stderr)
        return 2
    if args.arm:
        print(json.dumps(run_arm(args.arm, args.gap, args.iters)),
              flush=True)
        return 0
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.telemetry.window_probe",
         "--arm", arm, "--gap", str(args.gap), "--iters", str(args.iters)])
        for arm in ARMS]
    return max(p.wait() for p in procs)


if __name__ == "__main__":
    sys.exit(main())
