"""DvD case study (paper §5.3) on the port (``examples/dvd.py``):
population TD3 with a shared critic plus the determinant diversity term.

``strategy="dvd"`` installs the §B.2 coefficient schedule on the
shared-critic agent: the selection pressure is the joint -logdet (RBF
kernel) term inside the actor loss, so the evolve step is the identity.
The coefficient is 0 for the first ``dvd_period // 2`` update steps and
0.5 for the next as many. After each iteration the behaviour of every
member on a probe of 20 states from the engine's replay buffer gives the
population's volume, ``logdet`` (the §5.3 diagnostic). ``--strategy
pbt`` trades the diversity loss for exploit/explore selection over the
same population.

    python -m repro_torch.examples.dvd [--population 5] [--iters 20] \\
        [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.core.dvd import dvd_loss, pop_behavior_embedding
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.envs import make
from repro_torch.pop import PopTrainer, SharedCriticAgent
from repro_torch.telemetry import make_telemetry

PROBE = 20


def run(population=5, iters=20, collect_steps=100, updates_per_iter=32,
        strategy="dvd", seed=0, device=DEFAULT_DEVICE, log_dir=None):
    """Train for ``iters`` iterations; returns ``{"best_fitness", "iters",
    "trainer"}``, ``iters`` one row an iteration (seconds, fitness, the
    update steps taken, the probe's logdet)."""
    env = make("reacher")  # multi-goal: diversity matters
    n = population
    pcfg = PopulationConfig(size=n, strategy=strategy, dvd_period=400,
                            num_steps=updates_per_iter, pbt_interval=1,
                            exploit_frac=0.2, fitness_window=1)
    agent = SharedCriticAgent(env.spec.obs_dim, env.spec.act_dim,
                              device=device)
    telemetry = make_telemetry(log_dir, console=False, device=agent.device,
                               meta={"example": "dvd", "population": n,
                                     "strategy": strategy})
    trainer = PopTrainer(agent, pcfg, seed=seed, telemetry=telemetry)
    engine = trainer.attach_rollout(env, num_envs=2,
                                    collect_steps=collect_steps,
                                    batch_size=128, buffer_capacity=50_000,
                                    eval_envs=2)
    probe_gen = torch.Generator(device=agent.device).manual_seed(seed + 1)
    rows = []
    clock = [time.perf_counter()]

    def on_iter(it, metrics, stats, fitness, lineage):
        with torch.no_grad():
            emb = pop_behavior_embedding(trainer.actors,
                                         engine.probe_obs(probe_gen, PROBE))
            logdet = float(-dvd_loss(emb))
        telemetry.record("diversity", step=it + 1, logdet=logdet)
        row = {"iter": it + 1, "fitness": fitness.tolist(),
               "best_fitness": float(fitness.max()),
               "update_steps": int(trainer.state.step), "logdet": logdet}
        if metrics is not None:
            row.update({k: float(v.mean()) for k, v in metrics.items()})
        now = time.perf_counter()
        row["seconds"] = now - clock[0]
        clock[0] = now
        rows.append(row)
        print(f"[dvd] iter {it + 1}: best fitness "
              f"{row['best_fitness']:+.2f}, probe logdet {logdet:.4g}, "
              f"{row['update_steps']} update steps ({row['seconds']:.2f}s)",
              flush=True)

    t0 = time.perf_counter()
    trainer.run_env_loop(iters, eval_every=1, on_iter=on_iter)
    telemetry.record("run_end", best_fitness=rows[-1]["best_fitness"],
                     secs=round(time.perf_counter() - t0, 2))
    telemetry.close()
    return {"best_fitness": rows[-1]["best_fitness"], "iters": rows,
            "trainer": trainer}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--strategy", default="dvd",
                    choices=["dvd", "pbt", "none"])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--log-dir", default=None,
                    help="also write DIR/telemetry.jsonl (tools/report.py)")
    args = ap.parse_args(argv)
    return run(population=args.population, iters=args.iters,
               strategy=args.strategy, device=args.device,
               log_dir=args.log_dir)


if __name__ == "__main__":
    main()
