"""End-to-end PBT case study (paper §5.1) on the port
(``examples/pbt_td3.py``).

Trains a population of TD3 agents on the pendulum env with the full loop:
``PopTrainer`` owns the update and evolve side and the acting engine
(``repro_torch.rollout``) the acting side: per-member batched envs,
the population's replay buffers, and the collect -> insert -> sample ->
update iteration, all on the device. On the card every
population-batched linear is one ``pop_matmul`` launch and every Adam
step one ``pop_adam`` launch for the whole population. Per-member
exploration noise comes from each member's PBT-tuned ``explore_noise``
hyperparameter; fitness comes from the deterministic evaluator. The
same script trains a single-seed baseline with ``--population 1``; no
separate code path. Checkpoints are written every 10 iterations when
``--ckpt-dir`` is given (asynchronous saves). ``--backend islands`` (or
``sharded``) splits the population over the ranks that
``torch.distributed.run`` starts, one per GPU, as the paper's §5.1 islands
(a plain run is a world of one); rank 0 logs.

    python -m repro_torch.examples.pbt_td3 [--population 8] [--iters 30] \\
        [--device cuda]
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.examples.pbt_td3 --population 80 --backend islands
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.base import HyperSpace, PopulationConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.envs import make
from repro_torch.pop import ModuleAgent, PopTrainer
from repro_torch.rl import td3
from repro_torch.telemetry import make_telemetry

# "noise" is TD3's target-policy-smoothing sigma (update side);
# "explore_noise" drives the collector's acting-time gaussian: separate
# hypers so PBT can anneal exploration without touching the critic targets
SPACE = HyperSpace(
    log_uniform=(("actor_lr", 3e-5, 3e-3), ("critic_lr", 3e-5, 3e-3)),
    uniform=(("policy_freq", 0.2, 1.0), ("noise", 0.0, 1.0),
             ("explore_noise", 0.0, 1.0), ("discount", 0.9, 1.0)))


def run(population=8, iters=30, num_envs=4, collect_steps=32,
        updates_per_iter=64, batch_size=128, pbt_every=10,
        backend="vectorized", ckpt_dir=None, seed=0, log_dir=None,
        device=DEFAULT_DEVICE):
    """Train for ``iters`` iterations; returns the best member's fitness
    at the last evaluation."""
    if backend in ("islands", "sharded"):
        from repro_torch.core.distributed import world
        from repro_torch.launch.mesh import init_distributed
        device = init_distributed(device)
        if world()[0] != 0:          # rank 0 logs the run
            log_dir = None
    env = make("pendulum")
    n = population
    pcfg = PopulationConfig(
        size=n, strategy="pbt", backend=backend, num_steps=updates_per_iter,
        pbt_interval=pbt_every, exploit_frac=0.3, hyper_space=SPACE,
        fitness_window=5)
    agent = ModuleAgent(td3, env.spec.obs_dim, env.spec.act_dim,
                        device=device)
    # evolve / members / ckpt rows print through the one console
    # formatting path; --log-dir also writes the JSONL record
    # tools/report.py replays into the full family tree
    telemetry = make_telemetry(log_dir, console_every=5, device=agent.device,
                               meta={"example": "pbt_td3", "population": n,
                                     "backend": backend})
    trainer = PopTrainer(agent, pcfg, seed=seed, checkpoint_dir=ckpt_dir,
                         telemetry=telemetry)
    trainer.attach_rollout(env, num_envs=num_envs,
                           collect_steps=collect_steps,
                           batch_size=batch_size, buffer_capacity=20_000,
                           eval_envs=2)

    t0 = time.time()
    last = {"fitness": None}

    def on_iter(it, metrics, stats, fitness, lineage):
        if fitness is not None:
            last["fitness"] = fitness
        if ckpt_dir is not None and (it + 1) % 10 == 0:
            trainer.save()

    # eval_every=2 with fitness_window=5 and pbt_interval=10: exactly the
    # five evaluations PBT will consume land in the window each cycle
    trainer.run_env_loop(iters, eval_every=2, on_iter=on_iter)
    trainer.wait()
    if last["fitness"] is None:  # iters < eval_every: score the pop now
        last["fitness"] = trainer.evaluate_fitness()
    best = float(last["fitness"].max())
    telemetry.record("run_end", best_fitness=best,
                     secs=round(time.time() - t0, 2),
                     compiles=telemetry.compile_count)
    telemetry.close()
    return best


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, default=8)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--backend", default="vectorized",
                    choices=["vectorized", "sequential", "sharded",
                             "islands"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="write a checkpoint every 10 iterations into DIR")
    ap.add_argument("--log-dir", default=None,
                    help="also write DIR/telemetry.jsonl (tools/report.py)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(population=args.population, iters=args.iters,
               backend=args.backend, ckpt_dir=args.ckpt_dir,
               log_dir=args.log_dir, device=args.device)


if __name__ == "__main__":
    main()
