"""CEM-RL case study (paper §5.2), vectorized per §4.2, on the port
(``examples/cemrl.py``).

CEM keeps a gaussian over policy parameters. Each iteration the
population drawn from it trains HALF its members with TD3 against ONE
shared critic (``train_frac=0.5``, CEM-RL Algorithm 1); the paper's
change averages the critic loss over the trainees, so the whole update is
one population-level call (on the card: ``pop_matmul`` for the policies'
forwards, one ``pop_adam`` step for their Adam). Then every member is
evaluated and ``CEM.evolve`` refits the distribution on the elite half
and redraws the members. Algorithm 1's train -> evaluate -> refit order
is ``run_env_loop`` with ``pbt_interval=1``. ``--backend sequential``
runs the original CEM-RL ordering (the paper's baseline arm);
``--strategy pbt`` turns the same loop into PBT over the shared-critic
population.

    python -m repro_torch.examples.cemrl [--population 10] [--iters 20] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.base import PopulationConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.envs import make
from repro_torch.pop import PopTrainer, SharedCriticAgent
from repro_torch.telemetry import make_telemetry


def run(population=10, iters=20, rl_steps=64, collect_steps=100,
        strategy="cem", backend="vectorized", seed=0,
        device=DEFAULT_DEVICE, log_dir=None):
    """Train for ``iters`` iterations; returns ``{"mean_fitness", "iters",
    "trainer"}``, ``iters`` one row an iteration (seconds, fitness,
    lineage, losses, and for CEM the distribution's mean variance and
    noise after the evolve)."""
    env = make("pendulum")
    n = population
    # pbt_interval=1: the evolve fires every iteration, AFTER the
    # evaluation (Algorithm 1: sample -> train half -> evaluate all ->
    # refit on what was evaluated)
    pcfg = PopulationConfig(size=n, strategy=strategy, backend=backend,
                            num_steps=rl_steps, pbt_interval=1,
                            elite_frac=0.5, sigma_init=1e-2,
                            fitness_window=1)
    agent = SharedCriticAgent(env.spec.obs_dim, env.spec.act_dim,
                              train_frac=0.5, device=device)
    telemetry = make_telemetry(log_dir, console=False, device=agent.device,
                               meta={"example": "cemrl", "population": n,
                                     "strategy": strategy})
    trainer = PopTrainer(agent, pcfg, seed=seed, telemetry=telemetry)
    trainer.attach_rollout(env, num_envs=2, collect_steps=collect_steps,
                           batch_size=128, buffer_capacity=50_000,
                           eval_envs=2)
    rows = []
    clock = [time.perf_counter()]

    def on_iter(it, metrics, stats, fitness, lineage):
        row = {"iter": it + 1, "fitness": fitness.tolist(),
               "mean_fitness": float(fitness.mean()),
               "lineage": None if lineage is None else lineage.tolist()}
        if metrics is not None:
            row.update({k: float(v.mean()) for k, v in metrics.items()})
        cem = getattr(trainer.strategy, "cem_state", None)
        if cem is not None:
            # the distribution's contraction: CEM's own health signal
            row["sigma"] = float(cem.var.mean())
            row["cem_noise"] = float(cem.noise)
            telemetry.record("cem", step=it + 1, sigma=row["sigma"])
        now = time.perf_counter()
        row["seconds"] = now - clock[0]
        clock[0] = now
        rows.append(row)
        print(f"[cemrl] iter {it + 1}: mean fitness "
              f"{row['mean_fitness']:+.2f} ({row['seconds']:.2f}s)"
              + (f", sigma {row['sigma']:.3g}" if "sigma" in row else ""),
              flush=True)

    t0 = time.perf_counter()
    trainer.run_env_loop(iters, eval_every=1, on_iter=on_iter)
    telemetry.record("run_end", mean_fitness=rows[-1]["mean_fitness"],
                     secs=round(time.perf_counter() - t0, 2))
    telemetry.close()
    return {"mean_fitness": rows[-1]["mean_fitness"], "iters": rows,
            "trainer": trainer}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, default=10)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--strategy", default="cem",
                    choices=["cem", "pbt", "none"])
    ap.add_argument("--backend", default="vectorized",
                    choices=["vectorized", "sequential"])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--log-dir", default=None,
                    help="also write DIR/telemetry.jsonl (tools/report.py)")
    args = ap.parse_args(argv)
    return run(population=args.population, iters=args.iters,
               strategy=args.strategy, backend=args.backend,
               device=args.device, log_dir=args.log_dir)


if __name__ == "__main__":
    main()
