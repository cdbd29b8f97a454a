"""Serving driver (``repro.launch.serve``), the RL ensemble branch.

``--algo <name>`` loads a checkpoint a trained population left behind,
promotes a fitness + diversity serving set
(:class:`repro_torch.serve.ContinuousEvaluator`), and answers batched
observation requests through :class:`repro_torch.serve.BatchServer`,
re-polling the checkpoint directory so a still-training population keeps
refreshing the ensemble it serves. With ``--fused-linear`` the ensemble
call runs every member's linear layers as one ``pop_matmul`` launch per
layer.

    python -m repro_torch.launch.serve --algo td3 --env pendulum \\
        --ckpt-dir DIR --ensemble 4 --mode mean --fused-linear --batch 256

Runs on the CUDA device; ``--device cpu`` runs on the CPU (the kernels'
plain versions). ``--arch`` (LM decode) is not ported yet.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclass
class ServeReport:
    """What one serving run did: throughput, per-batch latency, every
    timed request batch with its answers, and the live server/watcher."""
    req_per_s: float
    p50_ms: float
    p99_ms: float
    requests: int
    seconds: float
    server: object
    watcher: object
    batches: list = field(default_factory=list)   # [(obs, actions)] numpy


def _serve_rl(args) -> ServeReport:
    """RL branch: ensemble inference over a trained population. Requests
    are synthesized from env resets, drawn on the host from ``--seed``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.envs import make
    from repro_torch.rl import make_agent
    from repro_torch.serve import (BatchServer, ContinuousEvaluator,
                                   PolicyForward, probe_observations)

    device = resolve_device(args.device)
    env = make(args.env)
    agent = make_agent(args.algo, env.spec, device=device)
    forward = PolicyForward.fused_for_agent(agent) if args.fused_linear \
        else None
    mgr = CheckpointManager(args.ckpt_dir)
    if mgr.latest() is None:
        raise FileNotFoundError(
            f"no checkpoint in {args.ckpt_dir}: serving needs a population "
            f"checkpoint with an 'actors' aux tree")

    gen = torch.Generator().manual_seed(args.seed)
    watcher = ContinuousEvaluator(
        mgr, agent, size=args.ensemble,
        probe_obs=probe_observations(env, gen, args.probe, device),
        diversity_weight=args.diversity_weight, forward=forward)
    sset = watcher.poll()
    server = BatchServer(watcher.forward, env.spec, sset,
                         max_batch=args.batch, mode=args.mode)
    print(f"[serve] algo={args.algo} env={args.env} mode={args.mode} "
          f"batch={args.batch} device={device} {sset.describe()}")

    def _request_batch():
        _, obs = env.reset(gen, args.batch, "cpu")
        return obs.numpy()

    server.warmup()
    server.serve(_request_batch())

    lat, batches = [], []
    actions = None
    t0 = time.perf_counter()
    for i in range(args.requests):
        obs = _request_batch()
        t1 = time.perf_counter()
        actions = server.serve(obs)
        lat.append(time.perf_counter() - t1)
        batches.append((obs, actions))
        if args.poll_every and (i + 1) % args.poll_every == 0:
            newer = watcher.poll(server)
            if newer is not None:
                ev = watcher.events[-1]
                print(f"[serve] promoted step {newer.step}: "
                      f"+{ev['promoted']} -{ev['demoted']}")
    dt = time.perf_counter() - t0
    served = args.requests * args.batch
    lat_ms = 1e3 * np.asarray(lat)
    p50, p99 = (float(np.percentile(lat_ms, q)) for q in (50, 99))
    print(f"[serve] {served} requests in {dt:.2f}s "
          f"({served / dt:.0f} req/s, p50 {p50:.3f} ms p99 {p99:.3f} ms "
          f"per batch)")
    print(f"[serve] last actions[:2] = {np.asarray(actions)[:2].tolist()}")
    return ServeReport(req_per_s=served / dt, p50_ms=p50, p99_ms=p99,
                       requests=served, seconds=dt, server=server,
                       watcher=watcher, batches=batches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM config id (decode workload) — not ported yet")
    ap.add_argument("--algo", default=None,
                    help="RL algorithm whose population checkpoint to serve "
                    "as an ensemble")
    ap.add_argument("--env", default="pendulum",
                    help="env of the trained checkpoint")
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint dir a population trainer wrote")
    ap.add_argument("--ensemble", type=int, default=4,
                    help="serving-set size (fitness + DvD selection)")
    ap.add_argument("--mode", default="mean",
                    choices=["mean", "vote", "best"],
                    help="ensemble reduction")
    ap.add_argument("--requests", type=int, default=64,
                    help="request batches to serve in the demo loop")
    ap.add_argument("--poll-every", type=int, default=16,
                    help="re-poll the checkpoint dir every N batches "
                    "(0 = never): continuous promotion")
    ap.add_argument("--probe", type=int, default=32,
                    help="probe observations for behavioral embeddings")
    ap.add_argument("--diversity-weight", type=float, default=1.0)
    ap.add_argument("--fused-linear", action="store_true",
                    help="serve the ensemble through the population-"
                    "batched forward (one pop_matmul launch per layer) "
                    "instead of member by member")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed request batch (requests are padded to it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if (args.arch is None) == (args.algo is None):
        ap.error("pass exactly one of --arch (LM) or --algo (RL ensemble)")
    if args.arch is not None:
        raise NotImplementedError(
            "--arch (LM decode) is not ported yet: it comes with the LM "
            "slice, the last in ROADMAP.md's port queue")
    return _serve_rl(args)


if __name__ == "__main__":
    main()
