"""Serving entry point (``repro.launch.serve``): both inference workloads
behind one CLI.

``--arch <id>`` serves a language model: a model of that
config with random weights (drawn on the device from ``--seed``), a batch of
random prompts prefilled in ONE call of the serve step, then one decode
call per new token, sampling from the logits:

    python -m repro_torch.launch.serve --arch qwen3-8b --batch 4 \\
        --prompt-len 512 --tokens 32

On the card every GQA attention layer's prefill is one launch of the CUDA
``flash_attention`` kernel (at any prompt length), every RWKV6 layer's
one launch of ``wkv6`` and every
Mamba2 layer's one launch of ``ssd``; decode steps attend over the KV
cache and take the literal scans. MLA (deepseek) and the mixture-of-
experts layers compute in plain PyTorch, as the JAX package computes them
outside its kernels. The port runs every arch of the JAX package: the
dense ``qwen2-0.5b``, ``qwen2-1.5b``, ``qwen3-8b`` and ``gemma-7b``, the
MoE ``qwen3-moe-30b-a3b`` and ``deepseek-v2-lite-16b``, ``rwkv6-1.6b``,
``zamba2-7b``, ``rwkv6-test``, and the frontend archs ``musicgen-medium``
(fed zero audio-frame embeddings, as the JAX CLI feeds them) and
``pixtral-12b`` (fed no image patches, as the JAX CLI feeds none).

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
    python -m repro_torch.launch.serve --algo dqn --env cartpole \\
        --ckpt-dir DIR --ensemble 4 --mode vote --fused-linear --batch 256
    python -m repro_torch.launch.serve --algo ppo --env pendulum \\
        --ckpt-dir DIR --mode mean --fused-linear

The ensemble heads are td3's tanh actor, sac's tanh of the gaussian's
mean, dqn's greedy action and ppo's tanh mean (continuous) or the argmax
of its logits (discrete); ``vote`` needs a discrete env.

``--islands`` serves the ensemble over ranks, one process a GPU under
``torch.distributed.run`` (NCCL on the card, gloo with ``--device
cpu``): the layout is ``plan_layout(world, ensemble size)``, each rank
holds its island's block of the members and runs their forward, rank 0
alone draws the requests and its batch is broadcast, the reduction
across islands is the one collective of a batch, and rank 0 prints and
logs (the others answer silently). Every promotion is collective: rank 0
picks the members and every rank installs them, re-split over the
islands. A plain ``python`` run is a world of one, one island::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.serve --algo td3 --islands --fused-linear \
        --batch 256 --ckpt-dir DIR

``--islands`` is taken with ``--algo`` only: the LM branch has no
islands path (the JAX CLI's never reads the flag), so beside ``--arch``
it is refused.

``--log-dir DIR`` writes the run's telemetry as ``DIR/telemetry.jsonl``:
for ``--algo``, a ``serve`` row (latency p50/p99, batch fill, queue
depth) every ``--telemetry-every`` batches and the ``promotion`` rows of
the serving set; for both, the kernel builds and the ``run_end`` row.
``tools/report.py`` replays it. ``--profile DIR`` writes a
``torch.profiler`` Chrome trace into DIR: of ``--profile-iters`` request
batches after the first (``--algo``), or of the whole generation
(``--arch``).

Runs on the CUDA device; ``--device cpu`` runs on the CPU (the kernels'
plain versions).
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


@dataclass
class LMServeReport:
    """What one LM serving run did: the tokens (the first prompt token and
    the new ones, (B, 1+T)), the prefill's time and the decode time per
    new token (host clock, device synchronised), and the weights' size."""
    tokens: torch.Tensor
    prefill_ms: float
    decode_ms_per_token: float
    num_params: int
    weight_bytes: int


def generate(cfg, params, prompt_tokens, *, steps: int, max_len: int,
             greedy: bool = True, generator=None, times=None):
    """The JAX package's ``generate``, with the prompt prefilled in one call
    of the serve step (the JAX package steps it token by token through
    the same step): returns the first prompt token followed by ``steps``
    new tokens, (B, 1+steps). Greedy, or sampled from the logits with
    ``generator``. An ``audio_frames`` config is fed zero frame
    embeddings beside the tokens, as the JAX package's ``generate`` feeds
    them; a ``vision_patches`` one no patches (its serve step would ignore
    them). With a dict ``times``, the device is synchronised
    around the prefill and the decode loop and their seconds recorded as
    ``prefill_s`` and ``decode_s``."""
    from repro_torch.models import lm

    b, s0 = prompt_tokens.shape
    serve = lm.make_serve_step(cfg)
    state = lm.init_decode_state(cfg, b, max_len,
                                 device=prompt_tokens.device)

    inputs = lambda tokens: lm.frontend_inputs(cfg, tokens, patches=False)

    def pick(logits):
        if greedy:
            return logits.argmax(-1, keepdim=True)
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)

    def clock():
        if prompt_tokens.is_cuda:
            torch.cuda.synchronize(prompt_tokens.device)
        return time.perf_counter()

    t0 = clock()
    logits, state = serve(params, inputs(prompt_tokens), state, 0)
    out = [prompt_tokens[:, :1], pick(logits[:, -1])]
    t1 = clock()
    for t in range(steps - 1):
        logits, state = serve(params, inputs(out[-1]), state, s0 + t)
        out.append(pick(logits[:, -1]))
    t2 = clock()
    if times is not None:
        times.update(prefill_s=t1 - t0, decode_s=t2 - t1)
    return torch.cat(out, dim=1)


def _serve_lm(args) -> LMServeReport:
    """LM branch: random weights and prompts from ``--seed``, drawn on the
    device, then :func:`generate`, sampling."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.telemetry import make_telemetry
    from repro_torch.tree import leaves

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    telemetry = make_telemetry(
        args.log_dir, console=False, device=device,
        meta={"workload": "serve-lm", "arch": cfg.name,
              "batch": args.batch, "tokens": args.tokens})
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init_params(gen, cfg, dtype=lm.compute_dtype(cfg))
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    times = {}
    if args.profile:
        telemetry.start_profile(args.profile)
    out = generate(cfg, params, prompts, steps=args.tokens,
                   max_len=args.prompt_len + args.tokens + 1, greedy=False,
                   generator=gen, times=times)
    telemetry.stop_profile()
    prefill_ms = 1e3 * times["prefill_s"]
    per_token = 1e3 * times["decode_s"] / max(args.tokens - 1, 1)
    secs = times["prefill_s"] + times["decode_s"]
    telemetry.record("run_end", tokens=args.batch * args.tokens,
                     secs=round(secs, 4), prefill_ms=round(prefill_ms, 4),
                     decode_ms_per_token=round(per_token, 4),
                     compiles=telemetry.compile_count,
                     compile_secs=round(telemetry.compile_secs, 4))
    telemetry.close()
    weights = leaves(params)
    num_params = sum(t.numel() for t in weights)
    weight_bytes = sum(t.numel() * t.element_size() for t in weights)
    print(f"[serve] arch={cfg.name} device={device} batch={args.batch} "
          f"prompt={args.prompt_len}: {num_params} parameters "
          f"({weight_bytes} bytes); generated {tuple(out.shape)}, prefill "
          f"{prefill_ms:.2f} ms, {per_token:.3f} ms per decode step")
    print(f"[serve] tokens[:2] = {out[:2].tolist()}")
    return LMServeReport(tokens=out, prefill_ms=prefill_ms,
                         decode_ms_per_token=per_token,
                         num_params=num_params, weight_bytes=weight_bytes)


def _islands_layout(size: int, ensemble: int):
    """The serving layout over the world's ranks (the JAX CLI's
    ``plan_layout(len(jax.devices()), sset.size)``), and its line."""
    import torch.distributed as dist

    from repro_torch.elastic import plan_layout
    layout = plan_layout(size, ensemble)
    per = ensemble // layout.islands
    group = (f"process group {dist.get_backend()} over {size} rank"
             f"{'s' if size > 1 else ''}" if dist.is_initialized()
             else "no process group")
    return layout, (f"[serve] islands {layout}: {layout.islands} island"
                    f"{'s' if layout.islands > 1 else ''}, rank 0 serves "
                    f"slots 0..{per - 1} of the set, {group}")


def _serve_rl(args) -> ServeReport:
    """RL branch: ensemble inference over a trained population. Requests
    are synthesized from env resets, drawn on the host from ``--seed``
    (by rank 0 alone over ranks)."""
    import torch.distributed as dist

    from repro_torch.core.distributed import world

    device = resolve_device(args.device)
    joined = False
    if args.islands:
        from repro_torch.launch.mesh import init_distributed
        joined = not dist.is_initialized()
        device = init_distributed(device)
        joined = joined and dist.is_initialized()
    rank, size = world() if args.islands else (0, 1)
    root = rank == 0
    say = print if root else (lambda *a, **k: None)
    if not root:                   # rank 0 logs and traces the run
        args.log_dir = args.profile = None
    try:
        return _serve_rl_on(args, device, rank, size, say)
    finally:
        if joined:
            from repro_torch.launch.mesh import leave_distributed
            leave_distributed()


def _serve_rl_on(args, device, rank, size, say) -> ServeReport:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.envs import make
    from repro_torch.rl import make_agent
    from repro_torch.serve import (BatchServer, ContinuousEvaluator,
                                   PolicyForward, probe_observations)
    from repro_torch.telemetry import make_telemetry

    env = make(args.env)
    agent = make_agent(args.algo, env.spec, device=device)
    forward = PolicyForward.fused_for_agent(agent) if args.fused_linear \
        else None
    mgr = CheckpointManager(args.ckpt_dir)
    if mgr.latest() is None:
        raise FileNotFoundError(
            f"no checkpoint in {args.ckpt_dir}: serving needs a population "
            f"checkpoint with an 'actors' aux tree")

    telemetry = make_telemetry(
        args.log_dir, console=False, device=device,
        meta={"workload": "serve-rl", "algo": args.algo, "env": args.env,
              "mode": args.mode, "ensemble": args.ensemble,
              "batch": args.batch})
    tel = telemetry if telemetry.enabled else None
    if size > 1 and device.type == "cuda" and args.fused_linear:
        import torch.distributed as dist
        if rank == 0:          # built once before any rank loads it
            from repro_torch.kernels.build import build
            build(("pop_matmul",))
        dist.barrier()
    gen = torch.Generator().manual_seed(args.seed)
    watcher = ContinuousEvaluator(
        mgr, agent, size=args.ensemble,
        probe_obs=probe_observations(env, gen, args.probe, device),
        diversity_weight=args.diversity_weight, forward=forward,
        telemetry=tel, collective=size > 1)
    sset = watcher.poll()
    layout = None
    if args.islands:
        layout, line = _islands_layout(size, sset.size)
        say(line)
    server = BatchServer(watcher.forward, env.spec, sset,
                         max_batch=args.batch, mode=args.mode, telemetry=tel,
                         telemetry_every=args.telemetry_every, layout=layout)
    say(f"[serve] algo={args.algo} env={args.env} mode={args.mode} "
        f"batch={args.batch} device={device} {sset.describe()}")

    def _request_batch():
        if rank != 0:         # rank 0's requests are served
            return None
        _, obs = env.reset(gen, args.batch, "cpu")
        return obs.numpy()

    server.warmup()
    server.serve(_request_batch())

    lat, batches = [], []
    actions = None
    t0 = time.perf_counter()
    for i in range(args.requests):
        telemetry.tick_profile(i, args.profile, iters=args.profile_iters)
        obs = _request_batch()
        t1 = time.perf_counter()
        actions = server.serve(obs)
        lat.append(time.perf_counter() - t1)
        batches.append((obs, actions))
        if args.poll_every and (i + 1) % args.poll_every == 0:
            with telemetry.compile_scope("promotion"):
                newer = watcher.poll(server)
            if newer is not None:
                ev = watcher.events[-1]
                say(f"[serve] promoted step {newer.step}: "
                    f"+{ev['promoted']} -{ev['demoted']}")
    dt = time.perf_counter() - t0
    served = args.requests * args.batch
    lat_ms = 1e3 * np.asarray(lat)
    p50, p99 = (float(np.percentile(lat_ms, q)) for q in (50, 99))
    say(f"[serve] {served} requests in {dt:.2f}s "
        f"({served / dt:.0f} req/s, p50 {p50:.3f} ms p99 {p99:.3f} ms "
        f"per batch)")
    say(f"[serve] last actions[:2] = {np.asarray(actions)[:2].tolist()}")
    server.report_telemetry()            # the partial tail window
    telemetry.record("run_end", requests=served, secs=round(dt, 4),
                     req_per_s=round(served / dt, 2),
                     compiles=telemetry.compile_count,
                     compile_secs=round(telemetry.compile_secs, 4))
    telemetry.close()
    return ServeReport(req_per_s=served / dt, p50_ms=p50, p99_ms=p99,
                       requests=served, seconds=dt, server=server,
                       watcher=watcher, batches=batches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM config id: qwen2-0.5b, qwen2-1.5b, qwen3-8b, "
                    "gemma-7b, qwen3-moe-30b-a3b, deepseek-v2-lite-16b, "
                    "rwkv6-1.6b, zamba2-7b, rwkv6-test, musicgen-medium "
                    "or pixtral-12b")
    ap.add_argument("--algo", default=None,
                    help="RL algorithm whose population checkpoint to serve "
                    "as an ensemble (td3, sac, dqn, ppo)")
    ap.add_argument("--env", default="pendulum",
                    help="env of the trained checkpoint")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir a population trainer wrote "
                    "(with --algo)")
    ap.add_argument("--ensemble", type=int, default=4,
                    help="serving-set size (fitness + DvD selection)")
    ap.add_argument("--mode", default="mean",
                    choices=["mean", "vote", "best"],
                    help="ensemble reduction: mean (continuous; plurality "
                    "for a discrete env), vote (discrete), best")
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
    ap.add_argument("--islands", action="store_true",
                    help="with --algo: serve the ensemble over the ranks "
                    "torch.distributed.run launches, each rank its "
                    "island's block of the members (a plain run is one "
                    "island)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the config's reduced smoke version")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed request batch (requests are padded to it); "
                    "with --arch, the number of prompts")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16,
                    help="new tokens to generate per prompt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", default=None, metavar="DIR",
                    help="write the run's telemetry (latency windows, "
                    "promotions, kernel builds) as DIR/telemetry.jsonl; "
                    "inspect with tools/report.py")
    ap.add_argument("--telemetry-every", type=int, default=16,
                    help="summarize the serving latency window into one "
                    "telemetry row every N served batches")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace into DIR: of "
                    "a few request batches (--algo) or of the generation "
                    "(--arch)")
    ap.add_argument("--profile-iters", type=int, default=3,
                    help="request batches the --profile window spans")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if (args.arch is None) == (args.algo is None):
        ap.error("pass exactly one of --arch (LM) or --algo (RL ensemble)")
    if args.arch is not None:
        if args.islands:
            ap.error("--islands serves an --algo ensemble over ranks; the "
                     "--arch branch has no islands path (it would ignore "
                     "the flag)")
        return _serve_lm(args)
    if args.ckpt_dir is None:
        ap.error("--algo needs --ckpt-dir")
    return _serve_rl(args)


if __name__ == "__main__":
    main()
