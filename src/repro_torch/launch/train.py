"""Training entry point (``repro.launch.train``): two workloads behind one
CLI and one ``PopTrainer``.

``--arch <id>`` trains a population of a language model on the synthetic
token stream (``repro_torch.data.lm_pipeline``): each step every member
takes ``--batch`` sequences of ``--seq-len`` tokens, PBT perturbs
``lr_scale``, ``weight_decay`` and ``warmup_frac`` and evolves every
``--pbt-interval`` steps on the members' losses. ``--backend vectorized``
updates the whole population with one ``pop_adam`` launch a step on the
card; ``--backend sequential`` steps one member at a time with the stock
AdamW and launches no kernel. ``--smoke`` takes the config's reduced
same-family form. Every LM config of the registry trains, the MoE ones
(``qwen3-moe-30b-a3b``, ``deepseek-v2-lite-16b``) with their auxiliary
load-balancing loss in the members' loss, and the frontend ones as the
JAX CLI feeds them: ``musicgen-medium`` zero audio-frame embeddings in
place of the tokens' embeddings, ``pixtral-12b`` zero patch embeddings
over the first 256 positions, whose labels the loss masks (so its
``--seq-len`` must cover them). ``--strategy cem`` evolves every
parameter of the members by CEM instead of PBT: the distribution is
refit on the fittest members and every member redrawn from it, in place
in the population's flat parameter buffer (the Adam moments and steps
stay). ``--num-layers`` cuts the config's depth at its full width: a
population of pixtral-12b at full depth would need some 465 GB. A
checkpoint of a full-width population is large (about 36 GB for 4
members of qwen2-0.5b under CEM); ``--ckpt-every 0`` writes none.

    python -m repro_torch.launch.train --arch qwen2-0.5b --population 4 \\
        --steps 100 --pbt-interval 10 --batch 4 --seq-len 512 --ckpt-dir DIR
    python -m repro_torch.launch.train --arch pixtral-12b --num-layers 1 \\
        --population 2 --steps 4 --pbt-interval 2 --batch 1 --seq-len 512 \\
        --ckpt-every 0 --ckpt-dir DIR
    python -m repro_torch.launch.train --arch qwen2-0.5b --strategy cem \\
        --population 4 --steps 4 --pbt-interval 2 --batch 4 --seq-len 512 \\
        --ckpt-every 0 --ckpt-dir DIR

``--algo <name>`` (td3, sac, dqn or ppo) trains a population of the
registered algorithm on an env (pendulum, reacher, mountain_car and the
rigid-body hopper2d continuous, cartpole and acrobot discrete) through
``PopTrainer.attach_rollout`` / ``run_env_loop``. An off-policy algorithm
collects, inserts into the population's replay buffers, samples, and
takes ``--updates-per-iter`` chained population-level updates per
iteration; ppo collects a rollout of ``--collect-steps`` x ``--num-envs``
per member, computes GAE on the device and takes ``--epochs`` x
(rollout / ``--batch``) chained minibatch updates. PBT evolves every
``--pbt-interval`` iterations on the evaluator's fitness (or, with
``--strategy cem``, CEM refits a gaussian over the policies' parameters,
ppo's whole ``{actor, critic, log_std}`` tree, and redraws every member;
lineage ``-1``).
On the card every population-batched linear (forward and under autograd)
is one ``pop_matmul`` launch, every Adam step one ``pop_adam`` launch
for the whole population and every hopper2d control step one ``hopper2d``
launch; ``--fused-adam`` and ``--fused-linear`` are taken so that the JAX
CLI's command lines run, and change nothing.

``--fused-epoch`` runs whole train-evolve epochs (``--pbt-interval``
iterations, their evaluations and the evolve) as one captured CUDA graph
each on the card, eagerly on the CPU, with the eager loop's results; it
needs ``--steps`` a multiple of ``--pbt-interval`` and ``--eval-every``
dividing it, and takes its checkpoints at epoch ends (one due mid-epoch
waits for the epoch's end). ``--policy-lag 0|1`` selects the overlapped
engine (1: collect on a second stream, acting one update behind; refused
beside ``--fused-epoch``). ``--chunk-steps`` collects in chunks folded into the
store one at a time (it must divide ``--collect-steps``; the results are
unchanged).

    python -m repro_torch.launch.train --algo td3 --env pendulum \\
        --population 8 --steps 20 --pbt-interval 10 --eval-every 2 \\
        --num-envs 8 --collect-steps 32 --updates-per-iter 32 --batch 256 \\
        --fused-adam --fused-linear --ckpt-dir DIR
    python -m repro_torch.launch.train --algo sac --env pendulum ...
    python -m repro_torch.launch.train --algo dqn --env cartpole ...
    python -m repro_torch.launch.train --algo ppo --env pendulum \\
        --population 8 --steps 40 --pbt-interval 5 --num-envs 8 \\
        --collect-steps 64 --batch 128 --epochs 4 --fused-adam \\
        --fused-linear --ckpt-dir DIR
    python -m repro_torch.launch.train --algo td3 --env hopper2d \\
        --population 8 --steps 8 --pbt-interval 4 --eval-every 2 \\
        --num-envs 256 --collect-steps 4 --updates-per-iter 2 --batch 64 \\
        --fused-epoch --ckpt-dir DIR

The RL checkpoint is served by ``repro_torch.launch.serve``. Both run on
the CUDA device; ``--device cpu`` runs on the CPU (the kernels' plain
versions). Pass exactly one of ``--arch`` and ``--algo``.

``--resume auto`` (the default, as in the JAX CLI) continues from the
latest checkpoint in ``--ckpt-dir``: the population, hypers, strategy
state, the engine's buffers and env states and the generator's state, so
the run goes on as if it had not stopped. RL then runs ``--steps`` more
iterations; LM runs up to step ``--steps``, its token stream resumed at
the next step. A checkpoint of another population size raises under
``--resize strict`` (the default); ``--resize auto`` resumes it through
``repro_torch.elastic.restore_elastic``: a shrink keeps the fittest
members, a grow clones the fittest into the new slots, and the hypers,
replay buffers and env states follow the same member map (the LM's token
stream resumes with the new population's batch). Under ``--fused-epoch``
a checkpoint that is not at an epoch's end raises. Checkpoints are
written asynchronously. ``--resume none`` starts afresh (and its
checkpoints replace the old ones as they come). ``--log-dir DIR``
writes the run's telemetry as ``DIR/telemetry.jsonl`` (phase timers,
per-member fitness and hypers, lineage, kernel builds and graph
captures, checkpoint times), which ``tools/report.py`` replays;
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of
``--profile-iters`` iterations after the first into DIR. Flags of the JAX training CLI whose subsystems are
not ported are refused, not accepted as no-ops.

``--backend islands`` (the paper's §5.1 islands) and ``--backend sharded``
run one process per GPU under ``torch.distributed.run``: each rank holds
its island's members (their envs, buffers and update), PBT exchanges the
rows it copies across ranks, rank 0 writes the checkpoints and the
telemetry, and the run computes what one rank computes. The group is
NCCL on the card and gloo with ``--device cpu``; a plain ``python`` run
is a world of one::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --algo td3 --env hopper2d \
        --population 80 --backend islands --ckpt-dir DIR

``--model-axis N`` (``--backend islands``) plans the layout with a model
axis of N ranks inside each island (``plan_layout(...,
preferred_model=N)``: halved, with a warning, until it divides the
world). An ``--arch`` member is then sharded over its island's model
ranks by the rules of ``repro_torch.models.sharding`` (tensor-parallel
attention, MLP, RWKV6 and vocabulary; a rank's Adam step is one
``pop_adam`` launch over its parts), so a member larger than one card
trains; the checkpoint holds whole leaves and resumes at any model width.
An ``--algo`` member stays whole on every model rank, as in the JAX
package. Every LM family shards: the dense attention, RWKV6, MoE (experts
over the model axis), MLA (the latent and heads split) and Mamba2 (the
SSD heads split) configs::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen2-0.5b --population 2 \
        --backend islands --model-axis 2 --ckpt-dir DIR

``--strategy cem`` runs over islands and over model-sharded members:
member 0 and each evolve's elites are broadcast by the ranks that hold
them, a column chunk at a time, every rank refits and redraws its rows
and columns with the one-rank run's draws, and rank 0 checkpoints the
whole distribution, so the run writes what one rank writes::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --algo td3 --strategy cem \
        --backend islands --fused-linear --ckpt-dir DIR
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen2-0.5b --num-layers 2 \
        --population 4 --strategy cem --backend islands --model-axis 2 \
        --ckpt-dir DIR2

``--devices`` is 0 or the world size (the ranks are the devices; any
other value raises, naming ``--nproc-per-node``); ``--model-axis`` above
1 beside another backend, and ``--fused-epoch`` and ``--policy-lag 1``
over more than one island (their collectives would sit inside a captured
graph or on a second stream) are refused by name before any group is
joined. Any other backend refuses a world of more than one rank.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field

from repro_torch.device import DEFAULT_DEVICE, resolve_device

# --epochs when an on-policy algorithm is run without it (the JAX CLI's)
DEFAULT_EPOCHS = 4
# flag -> why it is refused
_REFUSED = {
    "compile_cache": "the port compiles no programs to cache",
}
# the backends that run one process per GPU
_MULTI_RANK = ("islands", "sharded")


@dataclass
class TrainReport:
    """What one training run did."""
    best_fitness: float
    seconds: float
    trainer: object
    evolutions: list = field(default_factory=list)  # [(iter, lineage)]
    metrics: dict | None = None                     # last update's metrics
    final_loss: float | None = None                 # LM: the members' mean


def _rank() -> int:
    from repro_torch.core.distributed import world
    return world()[0]


def say(*parts):
    """Print a ``[train]`` line, from rank 0 only."""
    if _rank() == 0:
        print(*parts, flush=True)


def _device(args):
    """This rank's device: joined to the process group that
    ``torch.distributed.run`` describes under a multi-rank backend."""
    if args.backend in _MULTI_RANK:
        from repro_torch.launch.mesh import init_distributed
        device = init_distributed(args.device)
        if _rank() != 0:          # rank 0 traces and logs the run
            args.profile = None
        return device
    return resolve_device(args.device)


def _say_layout(trainer):
    """The layout line: the islands, rank 0's members and the group."""
    import torch.distributed as dist
    if trainer.layout is None:
        return
    rows = trainer.rows
    group = (f", process group {dist.get_backend()} over "
             f"{dist.get_world_size()} rank"
             f"{'s' if dist.get_world_size() > 1 else ''}"
             if dist.is_initialized() else ", no process group")
    model = trainer.layout.model
    axis = ("" if model == 1 else
            f", model axis {model}: each member sharded over {model} ranks"
            if trainer.shard is not None else
            f", model axis {model}: members whole on each model rank")
    say(f"[train] layout {trainer.layout}: {trainer.layout.islands} "
        f"island{'s' if trainer.layout.islands > 1 else ''}, rank 0 "
        f"holds members {rows.lo}..{rows.hi - 1}{axis}{group}")


def _telemetry(args, device, **meta):
    """One telemetry object a run: JSONL into ``--log-dir`` when given,
    written by rank 0. The ``[train]`` lines are this CLI's console, so
    no console sink."""
    from repro_torch.telemetry import make_telemetry
    log_dir = args.log_dir if _rank() == 0 else None
    return make_telemetry(log_dir, console=False, device=device,
                          meta=dict(meta, seed=args.seed,
                                    population=args.population,
                                    strategy=args.strategy,
                                    backend=args.backend))


def _finish(args, trainer, telemetry, **fields):
    """Wait for the last checkpoint write, record the ``run_end`` row and
    close the telemetry (which writes a trace still open)."""
    trainer.wait()
    telemetry.record("run_end", **fields, compiles=telemetry.compile_count,
                     compile_secs=round(telemetry.compile_secs, 3))
    telemetry.close()


def _resume(args, trainer):
    """``--resume auto``: the latest checkpoint, through
    ``restore_elastic`` when ``--resize auto`` and its population size
    differs from ``--population``, else ``trainer.resume()`` (which
    raises on another size). Prints what it did; returns the restored
    step or None."""
    meta = trainer._mgr.peek_extra()
    if args.resize == "auto" and meta is not None and \
            meta["size"] != trainer.n:
        from repro_torch.elastic import restore_elastic
        resumed, lineage = restore_elastic(trainer)
        say(f"[train] elastic resume from step {resumed}: population "
            f"{meta['size']} -> {trainer.n}, lineage={lineage.tolist()}")
        return resumed
    resumed = trainer.resume()
    if resumed is not None:
        say(f"[train] resumed from step {resumed}" if args.arch else
            f"[train] resumed at trainer step {trainer.step_count}")
    return resumed


def _run_lm(args) -> TrainReport:
    import torch

    from repro_torch.configs import (HyperSpace, PopulationConfig,
                                     TrainConfig, get_config)
    from repro_torch.data.lm_pipeline import host_batches
    from repro_torch.models.lm import frontend_inputs
    from repro_torch.pop import LMAgent, PopTrainer

    device = _device(args)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if args.num_layers:
        cfg = cfg.replace(num_layers=args.num_layers)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 1), seed=args.seed)
    n = args.population
    say(f"[train] arch={cfg.name} pop={n} strategy={args.strategy} "
        f"backend={args.backend} device={device}")
    pcfg = PopulationConfig(
        size=n, strategy=args.strategy, backend=args.backend,
        pbt_interval=args.pbt_interval,
        hyper_space=HyperSpace(
            log_uniform=(("lr_scale", 0.1, 10.0),
                         ("weight_decay", 1e-3, 0.3)),
            uniform=(("warmup_frac", 0.01, 0.25),)))
    telemetry = _telemetry(args, device, workload="lm", arch=cfg.name)
    trainer = PopTrainer(LMAgent(cfg, tcfg, device=device), pcfg,
                         seed=args.seed, checkpoint_dir=args.ckpt_dir,
                         telemetry=telemetry, layout=args.layout)
    _say_layout(trainer)
    trainer.tokens_per_step = args.batch * args.seq_len
    start_step = 0
    if args.resume == "auto":
        resumed = _resume(args, trainer)
        if resumed is not None:
            start_step = resumed + 1
    stream = host_batches(cfg.vocab_size, args.batch * n, args.seq_len,
                          seed=args.seed, start_step=start_step)

    def next_batch(step):
        with telemetry.phase("data"):
            tokens = torch.from_numpy(next(stream)).to(device)
        return {k: x.reshape((n, args.batch) + x.shape[1:])
                for k, x in frontend_inputs(cfg, tokens).items()}

    t0 = time.time()
    report = TrainReport(best_fitness=float("-inf"), seconds=0.0,
                         trainer=trainer)

    def on_step(step, metrics, lineage):
        telemetry.tick_profile(step - start_step, args.profile,
                               iters=args.profile_iters)
        report.metrics = metrics
        if lineage is not None:
            report.evolutions.append((step + 1, lineage.tolist()))
            say(f"[train] evolve at step {step + 1}: "
                f"lineage={lineage.tolist()} strategy="
                f"{type(trainer.strategy).__name__}")
        due = args.ckpt_every and (step + 1) % args.ckpt_every == 0
        if due or step == args.steps - 1:
            loss = trainer.all_members(metrics["loss"])
            report.final_loss = float(loss.mean())
            say(f"[train] step {step + 1}: loss by member "
                f"{[round(x, 4) for x in loss.tolist()]}")
            if args.ckpt_every:
                trainer.save({"loss": report.final_loss})

    trainer.run(args.steps, next_batch, on_step=on_step)
    _finish(args, trainer, telemetry, final_loss=report.final_loss)
    report.seconds = time.time() - t0
    if report.metrics is not None:
        report.best_fitness = float(trainer.all_members(
            trainer.agent.fitness_from_metrics(report.metrics)).max())
    loss = float("nan") if report.final_loss is None else report.final_loss
    say(f"[train] done in {report.seconds:.1f}s, final loss {loss:.4f}")
    return report


def _run_rl(args) -> TrainReport:
    from repro_torch.configs.base import PopulationConfig
    from repro_torch.envs import make
    from repro_torch.pop import PopTrainer
    from repro_torch.rl import get_algo, make_agent

    device = _device(args)
    algo = get_algo(args.algo)
    env = make(args.env)
    agent = make_agent(args.algo, env.spec, device=device)
    n = args.population
    say(f"[train] algo={algo.name} env={args.env} pop={n} "
        f"strategy={args.strategy} backend={args.backend} "
        f"experience={algo.experience_kind} device={device}")

    pcfg = PopulationConfig(
        size=n, strategy=args.strategy, backend=args.backend,
        num_steps=args.updates_per_iter, pbt_interval=args.pbt_interval,
        hyper_space=algo.hyper_space)
    telemetry = _telemetry(args, device, workload="rl", algo=algo.name,
                           env=args.env)
    trainer = PopTrainer(agent, pcfg, seed=args.seed,
                         checkpoint_dir=args.ckpt_dir, telemetry=telemetry,
                         layout=args.layout)
    _say_layout(trainer)
    trainer.attach_rollout(env, num_envs=args.num_envs,
                           collect_steps=args.collect_steps,
                           batch_size=args.batch,
                           epochs=(DEFAULT_EPOCHS if args.epochs is None
                                   else args.epochs),
                           policy_lag=args.policy_lag,
                           chunk_steps=args.chunk_steps)
    if args.resume == "auto":
        _resume(args, trainer)
    start = trainer.step_count

    t0 = time.time()
    report = TrainReport(best_fitness=float("-inf"), seconds=0.0,
                         trainer=trainer)

    def on_iter(it, metrics, stats, fitness, lineage):
        telemetry.tick_profile(it, args.profile, iters=args.profile_iters)
        if metrics is not None:
            report.metrics = metrics
        if fitness is not None:
            best = float(fitness.max())
            report.best_fitness = max(report.best_fitness, best)
            say(f"[train] iter {it + 1}: eval best {best:+.2f}")
        if lineage is not None:
            report.evolutions.append((it + 1, lineage.tolist()))
            say(f"[train] evolve at iter {it + 1}: "
                f"lineage={lineage.tolist()} strategy="
                f"{type(trainer.strategy).__name__}")
        if args.ckpt_every and ((it + 1) % args.ckpt_every == 0
                                or it == args.steps - 1):
            due.append(it)
        # a fused epoch reports its iterations after running them all, so
        # a checkpoint due mid-epoch is taken at the epoch's end, where the
        # trainer's state is that of the iteration reported
        if due and start + it + 1 == trainer.step_count:
            trainer.save()
            due.clear()

    due = []
    trainer.run_env_loop(args.steps, eval_every=args.eval_every,
                         on_iter=on_iter, fused=args.fused_epoch)
    _finish(args, trainer, telemetry, best_fitness=report.best_fitness)
    report.seconds = time.time() - t0
    say(f"[train] done in {report.seconds:.1f}s, "
        f"best fitness {report.best_fitness:+.2f}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM config from the repro_torch.configs registry "
                    "(e.g. qwen2-0.5b, rwkv6-test)")
    ap.add_argument("--algo", default=None,
                    help="RL algorithm from the repro_torch.rl.ALGOS "
                    "registry (td3, sac, dqn, ppo)")
    ap.add_argument("--env", default="pendulum",
                    help="env name for the --algo workload: pendulum, "
                    "reacher, mountain_car, hopper2d (continuous: td3, sac, "
                    "ppo), cartpole, acrobot (discrete: dqn, ppo)")
    ap.add_argument("--population", type=int, default=1)
    ap.add_argument("--strategy", default="pbt",
                    choices=["pbt", "cem", "none"],
                    help="evolution strategy; cem evolves the actors' "
                    "parameters (--algo) or every parameter (--arch)")
    ap.add_argument("--backend", default="vectorized",
                    choices=["vectorized", "sequential", "sharded",
                             "islands"],
                    help="update backend: vectorized (the population at "
                    "once), sequential (member by member), islands or "
                    "sharded (one rank per GPU under torch.distributed.run, "
                    "each holding its island's members)")
    ap.add_argument("--devices", type=int, default=0,
                    help="the ranks the islands span: 0 (the world) or the "
                    "world size; launch more with --nproc-per-node")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="--backend islands: the preferred model-parallel "
                    "width inside each island (halved until it divides the "
                    "world); an --arch member is sharded over it by the "
                    "models/sharding rules, an --algo member stays whole")
    ap.add_argument("--num-envs", type=int, default=8)
    ap.add_argument("--collect-steps", type=int, default=32)
    ap.add_argument("--policy-lag", type=int, default=None, choices=[0, 1],
                    help="the overlapped acting engine: 0 = collect then "
                    "update (equal to the serial engine); 1 = collect on a "
                    "second stream, acting one update behind; default: the "
                    "serial engine (refused beside --fused-epoch at 1)")
    ap.add_argument("--chunk-steps", type=int, default=None,
                    help="collect in chunks of this many acting steps, "
                    "each folded into the experience store before the next "
                    "(must divide --collect-steps; the results are "
                    "unchanged)")
    ap.add_argument("--updates-per-iter", type=int, default=32,
                    help="chained off-policy updates per iteration")
    ap.add_argument("--epochs", type=int, default=None,
                    help="on-policy (ppo) epochs over each rollout per "
                    f"iteration (default {DEFAULT_EPOCHS}); refused beside "
                    "an off-policy --algo or an --arch")
    ap.add_argument("--batch", type=int, default=8,
                    help="RL: transitions per member-update; LM: sequences "
                    "per member and step")
    ap.add_argument("--seq-len", type=int, default=128,
                    help="LM: tokens per sequence")
    ap.add_argument("--smoke", action="store_true",
                    help="LM: the reduced same-family config (CPU-sized)")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="LM: cut the config to this many layers, at its "
                    "full width (a population of a large model at full "
                    "depth does not fit one card)")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="LM: the base learning rate")
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--steps", type=int, default=200,
                    help="train iterations (RL) or steps (LM)")
    ap.add_argument("--pbt-interval", type=int, default=50)
    ap.add_argument("--fused-adam", action="store_true",
                    help="taken for the JAX CLI's command lines: every Adam "
                    "step runs the pop_adam kernel on the card anyway")
    ap.add_argument("--fused-linear", action="store_true",
                    help="taken for the JAX CLI's command lines: every "
                    "population-batched linear runs the pop_matmul kernel "
                    "on the card anyway")
    ap.add_argument("--fused-epoch", action="store_true",
                    help="run whole train-evolve epochs (pbt_interval "
                    "iterations + evaluations + evolve) as one captured "
                    "CUDA graph each (eagerly on the CPU); needs --steps a "
                    "multiple of --pbt-interval and --eval-every dividing "
                    "it; the eager loop's results (checkpoints at epoch ends)")
    ap.add_argument("--ckpt-dir", required=True,
                    help="directory of the population checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every N iterations and at the last "
                    "(0: never, for a population too large to write "
                    "out); under --fused-epoch one due mid-epoch is taken "
                    "at that epoch's end")
    ap.add_argument("--resume", default="auto", choices=["auto", "none"],
                    help="auto: continue from the latest checkpoint in "
                    "--ckpt-dir (another population size needs --resize "
                    "auto; under --fused-epoch one at an epoch's end); "
                    "none: start afresh")
    ap.add_argument("--resize", default="strict",
                    choices=["strict", "auto"],
                    help="auto: resume a checkpoint whose population size "
                    "differs from --population (the worst members "
                    "dropped, or clones of the fittest refill); strict: "
                    "such a checkpoint raises")
    ap.add_argument("--log-dir", default=None, metavar="DIR",
                    help="write the run's telemetry (phase timers, "
                    "per-member fitness and hypers, lineage, kernel builds "
                    "and graph captures, checkpoint times) as "
                    "DIR/telemetry.jsonl, which tools/report.py replays")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of a bounded "
                    "window (from the second iteration) into DIR")
    ap.add_argument("--profile-iters", type=int, default=3,
                    help="iterations the --profile window spans")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    for flag in _REFUSED:
        ap.add_argument("--" + flag.replace("_", "-"), nargs="?",
                        const=True, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    for flag, why in _REFUSED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not supported by the port: "
                f"{why}")
    if (args.arch is None) == (args.algo is None):
        ap.error("pass exactly one of --arch (LM) or --algo (RL)")
    _check_layout(args)
    if args.arch is not None and (args.fused_epoch or args.policy_lag
                                  is not None or args.chunk_steps):
        raise ValueError("--fused-epoch, --policy-lag and --chunk-steps "
                         "drive the acting engine: they are taken with "
                         "--algo only")
    if args.algo is not None and args.num_layers is not None:
        raise ValueError("--num-layers cuts a language model's depth: it "
                         "is taken with --arch only")
    if args.epochs is not None:
        from repro_torch.rl import ALGOS
        on_policy = sorted(name for name, a in ALGOS.items()
                           if a.experience_kind == "trajectory")
        if args.algo not in on_policy:
            raise ValueError(
                f"--epochs is taken by the on-policy algorithms only "
                f"({', '.join(on_policy)}); "
                f"{'--arch' if args.algo is None else '--algo ' + args.algo}"
                f" would ignore it")
    try:
        if args.arch is not None:
            return _run_lm(args)
        return _run_rl(args)
    finally:
        if args.backend in _MULTI_RANK:
            from repro_torch.launch.mesh import leave_distributed
            leave_distributed()


def _check_layout(args):
    """The refusals of the multi-rank flags, before any group is joined:
    ``--devices`` other than 0 or the world size, ``--model-axis`` above 1
    beside another backend than islands, another backend on a world of
    several ranks, and the fused epoch and lag 1 over more than one
    island."""
    from repro_torch.elastic.layout import plan_layout, sharded_layout
    args.layout = None
    size = int(os.environ.get("WORLD_SIZE", 1))
    if args.devices not in (0, size):
        raise ValueError(
            f"--devices {args.devices} is neither 0 nor the world size "
            f"{size}: the port runs one rank per GPU, so launch with "
            f"python -m torch.distributed.run --nproc-per-node "
            f"{args.devices} -m repro_torch.launch.train ...")
    if args.model_axis > 1 and args.backend != "islands":
        raise ValueError(
            f"--model-axis {args.model_axis} is taken by --backend islands "
            f"only: it plans each island's model axis (--backend "
            f"{args.backend} has none)")
    if args.backend not in _MULTI_RANK:
        if size > 1:
            raise ValueError(
                f"--backend {args.backend} runs on one rank; the world has "
                f"{size}: pass --backend islands or sharded")
        return
    layout = sharded_layout(size, args.population)
    if args.backend == "islands":
        # --model-axis is the preferred width: JAX's warning and halving
        # when it does not divide the world
        import warnings
        with warnings.catch_warnings():
            if int(os.environ.get("RANK", 0)) != 0:
                warnings.simplefilter("ignore")
            layout = args.layout = plan_layout(
                size, args.population, preferred_model=args.model_axis)
    islands = layout.islands
    if islands == 1:
        return
    refused = {"--fused-epoch": args.fused_epoch,
               "--policy-lag 1": args.policy_lag == 1}
    for flag, given in refused.items():
        if given:
            raise NotImplementedError(
                f"{flag} over more than one island ({islands} here) is not "
                f"ported yet: it would need the islands' NCCL collectives "
                f"inside a captured CUDA graph (the fused epoch) or on a "
                f"second stream (lag 1), which needs one card a rank to "
                f"run")


if __name__ == "__main__":
    main()
