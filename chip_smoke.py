#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card     — the device's name and power limit; TF32 off everywhere;
  2. build    — every CUDA kernel of the port, built from this checkout's
                sources (one nvcc per source, all started together);
  3. kernels  — each kernel against its plain PyTorch version on the card,
                over the serving path's shapes and more, then timed at the
                path's shapes beside its bound, its plain version and the
                PyTorch library call that computes the same function;
  4. serve    — a seeded population of 8 full-width TD3 actors is written
                in the checkpoint layout and served through the port's CLI
                entry point (``repro_torch.launch.serve.main``, ``--fused-
                linear --batch 256``) in the mean and best modes, with the
                kernel launch counts set to 0 just before each run and read
                just after; answers are checked against the plain ensemble
                on the same serving set and requests, then a newer
                checkpoint must promote and demote members as the
                selection rule says.

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON line with every kernel's numbers, and ``{"ok": true, "device": ...}``.
Without CUDA, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# fp32 sums taken in another order than the plain version's
TOL = dict(rtol=1e-5, atol=1e-5)
# the H100 SXM's published peaks (NVIDIA data sheet): HBM3 bytes/s and
# fp32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
SEED = 0
POPULATION = 8
ENSEMBLE = 4
BATCH = 256
REQUESTS = 64


def log(msg: str):
    print(f"[smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def graph_ms(fn, reps: int = 50, iters: int = 20) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured into one
    CUDA graph, replayed ``iters`` times between CUDA events. Host launch
    overhead is left out; inputs stay in L2, as the serving path's
    weights do between batches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters: int = 200) -> float:
    """Time of one eager ``fn()`` call, host launch overhead included."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def pop_matmul_bound(n, bsz, k, m, *, broadcast: bool):
    """Least time (ms) and what bounds it for one launch: each input read
    once (a broadcast x is one (B,K) block), the output written once, and
    2*N*B*K*M fp32 operations."""
    x_elems = (1 if broadcast else n) * bsz * k
    nbytes = 4 * (x_elems + n * k * m + n * m + n * bsz * m)
    flops = 2 * n * bsz * k * m
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------- phases
def phase_kernels():
    """pop_matmul against its plain version, then timed at the path's
    shapes. Returns (max_abs_err, per-layer timing rows)."""
    from repro_torch.kernels.pop_matmul import pop_matmul, pop_matmul_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst, cases = 0.0, 0
    for n in (1, 4, 8):
        for bsz in (1, 4, 256, 1000):
            for k, m in ((3, 256), (256, 256), (256, 1)):
                w = torch.randn((n, k, m), generator=gen,
                                device="cuda") / k ** 0.5
                b = torch.randn((n, m), generator=gen, device="cuda")
                xs = torch.randn((n, bsz, k), generator=gen, device="cuda")
                one = torch.randn((bsz, k), generator=gen, device="cuda")
                for x in (xs, one.unsqueeze(0).expand(n, bsz, k)):
                    for act in ("none", "relu", "tanh"):
                        y = pop_matmul(x, w, b, activation=act)
                        ref = pop_matmul_plain(x, w, b, activation=act)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(y, ref, **TOL)
                        worst = max(worst, (y - ref).abs().max().item())
                        cases += 1
    log(f"pop_matmul == plain on {cases} cases, max abs err {worst:.3g}")

    # the serving path's three launches: E=4 members, B=256 requests,
    # layer 0 reads the requests broadcast over members (stride 0)
    layers = (("layer_0", 3, 256, "relu", True),
              ("layer_1", 256, 256, "relu", False),
              ("layer_2", 256, 1, "tanh", False))
    acts = {"none": lambda t: t, "relu": torch.relu, "tanh": torch.tanh}
    rows = []
    for name, k, m, act, broadcast in layers:
        n = ENSEMBLE
        w = torch.randn((n, k, m), generator=gen, device="cuda") / k ** 0.5
        b = torch.randn((n, m), generator=gen, device="cuda")
        x = (torch.randn((BATCH, k), generator=gen, device="cuda")
             .unsqueeze(0).expand(n, BATCH, k) if broadcast else
             torch.randn((n, BATCH, k), generator=gen, device="cuda"))
        f = acts[act]

        def kernel():
            return pop_matmul(x, w, b, activation=act)

        def plain():
            return pop_matmul_plain(x, w, b, activation=act)

        def library():
            return f(torch.baddbmm(b[:, None, :], x, w))

        torch.testing.assert_close(library(), plain(), **TOL)
        bound, bound_by = pop_matmul_bound(n, BATCH, k, m,
                                           broadcast=broadcast)
        row = {"layer": name, "n": n, "b": BATCH, "k": k, "m": m,
               "act": act, "x_broadcast": broadcast,
               "ms": graph_ms(kernel),
               "plain_ms": graph_ms(plain),
               "library_ms": graph_ms(library),
               "eager_ms": eager_ms(kernel),
               "plain_eager_ms": eager_ms(plain),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        log(f"pop_matmul {name} (N={n},B={BATCH},K={k},M={m},{act}): "
            f"kernel {row['ms'] * 1e3:.3f} us/launch on the device "
            f"({row['eager_ms'] * 1e3:.3f} us eager with launch overhead), "
            f"plain {row['plain_ms'] * 1e3:.3f} us "
            f"({row['plain_eager_ms'] * 1e3:.3f} us eager), baddbmm "
            f"{row['library_ms'] * 1e3:.3f} us, bound "
            f"{bound * 1e3:.3f} us ({bound_by})")
    return worst, rows


def write_population(ckpt_dir, step, fitness):
    """A seeded TD3 population checkpoint in the layout a population
    trainer's save writes: main tree (population state, strategy state),
    the stacked actors as the "actors" aux tree, size/fitness extras."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.envs import make
    from repro_torch.rl import make_agent

    agent = make_agent("td3", make("pendulum").spec, device="cuda")
    state = agent.population_init(
        torch.Generator().manual_seed(SEED), POPULATION)
    CheckpointManager(ckpt_dir).save(
        step, (state, {}),
        {"size": POPULATION, "fitness": [float(f) for f in fitness]},
        aux={"actors": agent.actor_params(state)})


def check_answers(server, obs, actions):
    """Finite actions in [-1, 1] that equal the plain ensemble on the same
    serving set and requests. Returns the max abs difference."""
    from repro_torch.rl.networks import pop_actor_apply

    assert actions.shape == (len(obs), 1), actions.shape
    assert np.isfinite(actions).all(), "non-finite actions"
    assert np.abs(actions).max() <= 1.0, "actions outside [-1, 1]"
    params = server.set.params
    x = torch.from_numpy(obs).to("cuda")
    with torch.inference_mode():
        per = pop_actor_apply(
            params, x.unsqueeze(0).expand(server.set.size, *x.shape),
            fused=False)
        ref = per[server.set.best] if server.mode == "best" else per.mean(0)
    got = torch.from_numpy(actions).to("cuda")
    torch.testing.assert_close(got, ref, **TOL)
    return (got - ref).abs().max().item()


def phase_serve():
    from repro_torch.kernels.pop_matmul import pop_matmul
    from repro_torch.launch.serve import main as serve_main

    rng = np.random.default_rng(SEED)
    fitness = rng.permutation(POPULATION).astype(np.float64) * 10.0 - 35.0
    results = {}
    worst = 0.0
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_population(ckpt_dir, 0, fitness)
        for mode, weight in (("mean", "1.0"), ("best", "0.0")):
            argv = ["--algo", "td3", "--env", "pendulum",
                    "--ckpt-dir", ckpt_dir, "--ensemble", str(ENSEMBLE),
                    "--mode", mode, "--fused-linear",
                    "--batch", str(BATCH), "--requests", str(REQUESTS),
                    "--diversity-weight", weight, "--seed", str(SEED)]
            pop_matmul.launches = 0
            report = serve_main(argv)
            launches = pop_matmul.launches
            torch.cuda.synchronize()
            batches = REQUESTS + 2          # warm-up + first batch + timed
            if launches != 3 * batches:
                raise AssertionError(
                    f"serve {mode}: pop_matmul launched {launches} times "
                    f"for {batches} served batches (want 3 per batch)")
            server, watcher = report.server, report.watcher
            members = server.set.members.tolist()
            if members[0] != int(np.argmax(fitness)):
                raise AssertionError(f"serve {mode}: the fittest member "
                                     f"is not in slot 0: {members}")
            for obs, actions in report.batches:
                worst = max(worst, check_answers(server, obs, actions))
            results[mode] = {"req_per_s": report.req_per_s,
                             "p50_ms": report.p50_ms,
                             "p99_ms": report.p99_ms,
                             "launches": launches, "members": members}
            log(f"serve {mode}: {report.requests} requests, "
                f"{report.req_per_s:.1f} req/s, p50 {report.p50_ms:.4f} ms "
                f"p99 {report.p99_ms:.4f} ms per batch of {BATCH}, "
                f"{launches} pop_matmul launches, members {members}")

        # promotion: with diversity weight 0 the rule is the top-k by
        # fitness; a newer checkpoint with another order must move exactly
        # the members that enter and leave the top k
        top = lambda f: set(np.argsort(-f, kind="stable")[:ENSEMBLE].tolist())
        old = top(fitness)
        if set(members) != old:
            raise AssertionError(f"best run served {members}, top-"
                                 f"{ENSEMBLE} by fitness is {sorted(old)}")
        newer_fitness = -fitness
        write_population(ckpt_dir, 10, newer_fitness)
        newer = watcher.poll(server)
        new = top(newer_fitness)
        event = watcher.events[-1]
        if (newer is None or newer.step != 10 or server.set is not newer
                or set(newer.members.tolist()) != new
                or event["promoted"] != sorted(new - old)
                or event["demoted"] != sorted(old - new)):
            raise AssertionError(f"promotion event {event} does not match "
                                 f"the rule: promote {sorted(new - old)}, "
                                 f"demote {sorted(old - new)}")
        obs = np.asarray(rng.standard_normal((BATCH, 3)), np.float32)
        pop_matmul.launches = 0
        worst = max(worst, check_answers(server, obs, server.serve(obs)))
        if pop_matmul.launches != 3:
            raise AssertionError("promoted set did not serve through "
                                 "pop_matmul")
        log(f"promotion at step 10: +{event['promoted']} "
            f"-{event['demoted']}; serving {newer.members.tolist()}")
    log(f"served answers == plain ensemble, max abs err {worst:.3g}")
    return results, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}"
              f"; run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(SRC):
        print(f"chip_smoke: imported repro_torch from "
              f"{repro_torch.__file__}, not from this checkout",
              file=sys.stderr)
        return 2

    # 1. card
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build(["pop_matmul"])
    log(f"built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.2f}s")
    for src, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"{src}: {line.strip()}")

    # 3. kernels vs plain, timing
    kernel_err, rows = phase_kernels()

    # 4. serve through the port's entry point
    serve, serve_err = phase_serve()

    per_batch = lambda key: sum(r[key] for r in rows)
    bound_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] ==
                    "operations")
    kernels = [{
        "name": "pop_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pop_matmul.cu",
        "replaces": "src/repro/kernels/pop_matmul.py:83",
        "launches": serve["mean"]["launches"],
        "max_abs_err": max(kernel_err, serve_err),
        "work": f"the {len(rows)} launches of one served batch "
                f"(E={ENSEMBLE}, B={BATCH}); times are device times",
        "ms": per_batch("ms"),
        "plain_ms": per_batch("plain_ms"),
        "bound_ms": per_batch("bound_ms"),
        "bound_by": ("operations" if 2 * bound_ops >= per_batch("bound_ms")
                     else "bytes"),
        "library_ms": per_batch("library_ms"),
        "eager_ms": per_batch("eager_ms"),
        "plain_eager_ms": per_batch("plain_eager_ms"),
        "per_launch": rows,
    }]
    for mode, r in serve.items():
        log(f"serve {mode}: {r['req_per_s']:.1f} req/s, p50 "
            f"{r['p50_ms']:.4f} ms, p99 {r['p99_ms']:.4f} ms per batch")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
