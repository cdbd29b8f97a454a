"""PBT over population-vectorized PPO, the on-policy end of the pipeline,
on the port (``examples/pbt_ppo.py``).

The scenario population-based training first served (Jaderberg et al.
tuned PPO): the same ``PopTrainer.attach_rollout`` call site as the
off-policy algorithms, but ``PPOAgent`` declares
``experience_kind="trajectory"``, so each iteration collects a rollout
(recording every member's log_prob and value extras), computes GAE on the
device and takes shuffled epoch minibatch updates: on the card, every
population-batched linear one ``pop_matmul`` launch and every Adam step
one ``pop_adam`` launch for the whole population.

PBT tunes the per-member ``lr``, ``clip_eps`` and ``entropy_coef`` (the
update side) and ``gae_lambda`` (the advantage side). Checkpoints are
written every 10 iterations when ``ckpt_dir`` is given (asynchronously:
``trainer.save()`` returns once the state is on the host, and the run
waits for the last write before it returns), and ``--log-dir`` writes the
run's telemetry, as in the JAX example.

    python -m repro_torch.examples.pbt_ppo [--population 8] [--iters 40] \\
        [--env pendulum] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.base import HyperSpace, PopulationConfig
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.envs import make
from repro_torch.pop import PopTrainer, PPOAgent
from repro_torch.telemetry import make_telemetry

SPACE = HyperSpace(
    log_uniform=(("lr", 1e-5, 1e-3),),
    uniform=(("clip_eps", 0.1, 0.3), ("entropy_coef", 0.0, 0.03),
             ("gae_lambda", 0.9, 1.0)))


def run(population=8, iters=40, num_envs=8, collect_steps=64,
        epochs=4, batch_size=128, pbt_every=5, backend="vectorized",
        env_name="pendulum", ckpt_dir=None, seed=0,
        device=DEFAULT_DEVICE, log_dir=None):
    """Train for ``iters`` iterations; returns ``{"best_fitness",
    "seconds", "trainer"}``: the best member's fitness at the last
    evaluation, the run's seconds and the trainer."""
    env = make(env_name)
    n = population
    pcfg = PopulationConfig(
        size=n, strategy="pbt", backend=backend, pbt_interval=pbt_every,
        exploit_frac=0.3, hyper_space=SPACE, fitness_window=5)
    agent = PPOAgent(env.spec.obs_dim, env.spec.act_dim,
                     discrete=env.spec.discrete, device=device)
    telemetry = make_telemetry(log_dir, console=False, device=agent.device,
                               meta={"example": "pbt_ppo", "population": n,
                                     "env": env_name, "backend": backend})
    trainer = PopTrainer(agent, pcfg, seed=seed, checkpoint_dir=ckpt_dir,
                         telemetry=telemetry)
    # on-policy knobs: each iteration consumes the whole fresh rollout of
    # collect_steps x num_envs transitions as epochs x minibatches
    trainer.attach_rollout(env, num_envs=num_envs,
                           collect_steps=collect_steps,
                           batch_size=batch_size, epochs=epochs, eval_envs=2)

    t0 = time.perf_counter()
    last = {"fitness": None}

    def on_iter(it, metrics, stats, fitness, lineage):
        last["fitness"] = fitness
        if (it + 1) % 10 == 0:
            print(f"[pbt_ppo] iter {it + 1}: best fitness "
                  f"{float(fitness.max()):+.2f}, approx_kl "
                  f"{float(metrics['approx_kl'].mean()):.4f}", flush=True)
            if ckpt_dir is not None:
                trainer.save()

    trainer.run_env_loop(iters, eval_every=1, on_iter=on_iter)
    trainer.wait()
    best = float(last["fitness"].max())
    seconds = time.perf_counter() - t0
    telemetry.record("run_end", best_fitness=best, secs=round(seconds, 2),
                     compiles=telemetry.compile_count)
    telemetry.close()
    return {"best_fitness": best, "seconds": seconds, "trainer": trainer}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, default=8)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--env", default="pendulum",
                    choices=["pendulum", "reacher", "cartpole",
                             "mountain_car", "acrobot"])
    ap.add_argument("--backend", default="vectorized",
                    choices=["vectorized", "sequential"])
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--log-dir", default=None,
                    help="also write DIR/telemetry.jsonl (tools/report.py)")
    args = ap.parse_args(argv)
    return run(population=args.population, iters=args.iters,
               env_name=args.env, backend=args.backend, device=args.device,
               log_dir=args.log_dir)


if __name__ == "__main__":
    main()
