"""Quickstart: the paper's protocol through the unified API, on the port
(``examples/quickstart.py``).

Train a population of 8 TD3 agents with per-member hyperparameters using
ONE population-wide update step, on data collected from the pendulum env
for every member at once. On the card every population-batched linear is
one ``pop_matmul`` launch and every Adam step one ``pop_adam`` launch for
the whole population. Swapping the update backend or the evolution
strategy is a one-line change to ``PopulationConfig``
(``backend="sequential"`` runs the paper's baseline arm;
``strategy="cem"`` evolves policy parameters instead of hyperparameters).

    python -m repro_torch.examples.quickstart [--iters 10] [--device cuda]
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import HyperSpace, PopulationConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.envs import make
from repro_torch.pop import ModuleAgent, PopTrainer
from repro_torch.rl import td3
from repro_torch.rollout.collector import Collector, exploration_policy
from repro_torch.rollout.vecenv import VecEnv
from repro_torch.telemetry import ConsoleSink, RunTelemetry

N = 8
STEPS = 256


def run(iters: int = 10, device=DEFAULT_DEVICE):
    """``iters`` iterations of collect-then-update; returns the trainer."""
    env = make("pendulum")

    # 1. one config names the whole setup: size, strategy, backend, hyper
    #    priors
    pcfg = PopulationConfig(
        size=N, strategy="pbt", backend="vectorized", pbt_interval=5,
        hyper_space=HyperSpace(log_uniform=(("actor_lr", 3e-5, 3e-3),
                                            ("critic_lr", 3e-5, 3e-3))))

    # 2. the trainer stacks the population, samples per-member hypers, and
    #    runs ONE update for every member (the paper's Fig. 1, right);
    #    telemetry formats every iteration: the loop below never calls
    #    float() on device values, the sink's thread fetches them
    agent = ModuleAgent(td3, env.spec.obs_dim, env.spec.act_dim,
                        device=device)
    telemetry = RunTelemetry(ConsoleSink(every=1), device=agent.device,
                             meta={"example": "quickstart"})
    trainer = PopTrainer(agent, pcfg, seed=0, telemetry=telemetry)

    # 3. data collection is population-batched too: one env a member,
    #    reset each iteration, STEPS steps
    collector = Collector(VecEnv(env, 1), exploration_policy(td3))
    for it in range(iters):
        vstate = collector.init(trainer.generator, N, agent.device)
        _, traj = collector.collect(trainer.actors, vstate,
                                    trainer.generator, STEPS)
        returns = traj["reward"].sum(-1)
        trainer.step(traj, fitness=returns)
        telemetry.record("rollout", step=it,
                         mean_reward=traj["reward"].mean())
    telemetry.close()
    print(f"OK — {N} agents trained in one vectorized stream")
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(iters=args.iters, device=args.device)


if __name__ == "__main__":
    main()
