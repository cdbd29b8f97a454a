"""``PopTrainer`` — the loop of population training
(``repro.pop.trainer``).

Composes an agent, an ``EvolutionStrategy`` and the update backend from
one ``PopulationConfig``; population size 1 is ``NoEvolution`` over a
1-member stack. An RL agent trains through the acting engine, with its
fitness from evaluation episodes::

    agent = ModuleAgent(td3, obs_dim, act_dim, device="cuda")
    pcfg = PopulationConfig(size=8, strategy="pbt", num_steps=32,
                            hyper_space=space, pbt_interval=10)
    trainer = PopTrainer(agent, pcfg, seed=0, checkpoint_dir=DIR)
    trainer.attach_rollout(env, num_envs=8, collect_steps=32,
                           batch_size=256)
    trainer.run_env_loop(20, eval_every=2)
    trainer.save()

An LM agent trains on token batches, with its fitness from the update's
own metrics (``agent.fitness_from_metrics``: -loss)::

    agent = LMAgent(get_config("qwen2-0.5b"), TrainConfig(), device="cuda")
    trainer = PopTrainer(agent, PopulationConfig(size=4, pbt_interval=2,
                                                 hyper_space=space))
    trainer.run(steps, lambda step: {"tokens": tokens_of(step)})

Randomness: parameters are drawn from a CPU generator seeded with
``seed`` (RL agents draw on it, as :mod:`repro_torch.nn.basic` does, so a
seed gives the same parameters on every device; ``LMAgent`` seeds a
generator of its own device from it); every later draw (hypers, env resets,
exploration, replay indices, target-policy noise, PBT) comes from ONE
generator on the agent's device, so on the card no draw crosses from the
host.

The fitness window stays on the device. ``save`` is blocking and writes
the main tree ``(state, strategy.export_state())``, the ``actors`` and
``hypers`` aux trees, and the ``size`` and ``fitness`` extras, in the
layout of :mod:`repro_torch.checkpoint` (which the JAX package's
``repro.serve.load_actor_stack`` reads). The port's main tree has no
per-member ``key`` leaf. ``save_async``, ``resume``, the ``rollout`` aux
tree and telemetry come with later slices.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.pop.backend import make_update
from repro_torch.pop.strategy import make_strategy


class PopTrainer:
    def __init__(self, agent, pcfg: PopulationConfig | None = None, *,
                 seed: int = 0, checkpoint_dir=None, keep: int = 2):
        self.agent = agent
        self.pcfg = pcfg = pcfg if pcfg is not None else PopulationConfig()
        self.n = pcfg.size
        self.generator = torch.Generator(device=agent.device).manual_seed(
            seed)
        self.strategy = make_strategy(pcfg)

        self.state = agent.population_init(
            torch.Generator().manual_seed(seed), self.n)
        self.strategy.configure_agent(agent)
        self.state = self.strategy.bind(self.generator, agent, self.state)
        self.hypers = self.strategy.init_hypers(self.generator, self.n)
        # ``pcfg.num_steps`` chained update steps per call, shared with the
        # acting engine
        self.update = make_update(agent, pcfg.backend,
                                  num_steps=max(1, pcfg.num_steps))

        self._window: deque = deque(maxlen=pcfg.fitness_window)
        self.last_fitness = None  # the (N,) fitness used at the last evolve
        self.step_count = 0
        self._rollout = None
        self._mgr = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointManager
            self._mgr = CheckpointManager(checkpoint_dir, keep=keep)

    # ------------------------------------------------------------------ run
    def step(self, batch, fitness=None):
        """One update call (``pcfg.num_steps`` chained member-steps), then,
        on cadence, one evolve. Fitness is ``fitness`` when given, else the
        agent's from the update's metrics (None for an RL agent). Returns
        ``(metrics, lineage)``; lineage is None unless evolution ran."""
        self.state, metrics = self.update(self.state, batch, self.hypers,
                                          self.generator)
        self.step_count += 1
        fit = (fitness if fitness is not None
               else self.agent.fitness_from_metrics(metrics))
        if fit is not None:
            self.report_fitness(fit)
        return metrics, self._maybe_evolve()

    def run(self, steps: int, batch_fn, *, on_step=None):
        """Drive update calls up to trainer step ``steps``;
        ``batch_fn(step) -> batch``, ``on_step(step, metrics, lineage)``.
        Fitness comes from the agent's metrics; loops with another fitness
        call ``step(batch, fitness=...)`` themselves."""
        metrics = None
        for step in range(self.step_count, steps):
            metrics, lineage = self.step(batch_fn(step))
            if on_step is not None:
                on_step(step, metrics, lineage)
        return metrics

    # ----------------------------------------------------------- env loop
    def attach_rollout(self, env, **engine_kwargs):
        """Attach the acting engine (``repro_torch.rollout.RolloutEngine``):
        batched envs per member, the population's replay buffers, the
        evaluator and the collect -> insert -> sample -> ``pcfg.num_steps``
        updates iteration. Returns the engine."""
        from repro_torch.rollout.engine import RolloutEngine
        if engine_kwargs.pop("policy_lag", None) is not None:
            raise NotImplementedError(
                "policy_lag (the overlapped engine) is not ported yet")
        self._rollout = RolloutEngine(self.agent, self.pcfg, env,
                                      update=self.update,
                                      generator=self.generator,
                                      init_state=self.state,
                                      **engine_kwargs)
        return self._rollout

    @property
    def rollout(self):
        if self._rollout is None:
            raise ValueError("no acting engine: call "
                             "trainer.attach_rollout(env, ...) first")
        return self._rollout

    def env_iteration(self):
        """One train iteration (collect + insert + sample + ``num_steps``
        updates). Counts as one trainer step for the evolve cadence.
        Returns ``(metrics, episode_stats, did_update)``."""
        self.state, metrics, stats, did = self.rollout.iterate(
            self.state, self.hypers, self.generator)
        self.step_count += 1
        return metrics, stats, did

    def evaluate_fitness(self):
        """Per-member fitness from deterministic evaluation episodes, an
        (N,) device tensor; does not touch the fitness window."""
        return self.rollout.evaluator.evaluate(self.actors, self.generator)

    def run_env_loop(self, iters: int, *, eval_every: int = 1, on_iter=None,
                     fused: bool = False):
        """Drive ``iters`` iterations. Every ``eval_every`` iterations the
        evaluator scores the population into the fitness window, and the
        strategy evolves every ``pcfg.pbt_interval`` trainer steps.
        ``on_iter(it, metrics, stats, fitness, lineage)`` is the logging
        hook. Returns the last (metrics, stats). Eager only: ``fused=True``
        (whole train-evolve epochs as one program) is not ported yet."""
        if fused:
            raise NotImplementedError(
                "run_env_loop(fused=True) is not ported yet: the port runs "
                "the eager loop")
        metrics = stats = None
        for it in range(iters):
            metrics, stats, _ = self.env_iteration()
            fitness = None
            if eval_every and (it + 1) % eval_every == 0:
                fitness = self.evaluate_fitness()
                self.report_fitness(fitness)
            lineage = self._maybe_evolve()
            if on_iter is not None:
                on_iter(it, metrics, stats, fitness, lineage)
        return metrics, stats

    # ---------------------------------------------------------------- evolve
    def report_fitness(self, fitness):
        """Feed a per-member fitness row into the window (kept on the
        device)."""
        self._window.append(torch.as_tensor(fitness))

    def fitness(self):
        """Windowed-mean per-member fitness, (N,), a device tensor."""
        if not self._window:
            return None
        return torch.stack(list(self._window)).mean(0)

    def _maybe_evolve(self):
        """Evolve iff on cadence (every ``pcfg.pbt_interval`` trainer
        steps, non-null strategy, non-empty fitness window)."""
        if (not self.strategy.null and self.pcfg.pbt_interval
                and self.step_count % self.pcfg.pbt_interval == 0
                and self._window):
            return self.evolve()
        return None

    def evolve(self):
        """One evolve step. The lineage it returns is for reporting only:
        CEM's -1 (a fresh draw) would index the last member."""
        self.last_fitness = self.fitness()
        self.state, self.hypers, lineage = self.strategy.evolve(
            self.generator, self.state, self.hypers, self.last_fitness)
        # pre-evolve fitness describes states that may just have been
        # replaced; start the next window fresh
        self._window.clear()
        return lineage

    # ------------------------------------------------------------ checkpoint
    @property
    def actors(self):
        """Stacked per-member policy params (for rollout and serving)."""
        return self.agent.actor_params(self.state)

    def save(self, extra: dict | None = None):
        """Blocking checkpoint at step ``step_count - 1``: main tree
        (population state, strategy internals), ``actors`` and ``hypers``
        aux trees, ``size`` and ``fitness`` (the live window's mean, or
        None right after an evolve) in the extras."""
        if self._mgr is None:
            raise ValueError("PopTrainer built without checkpoint_dir")
        fit = self.fitness()
        meta = dict(extra or {}, size=self.n,
                    fitness=None if fit is None else
                    fit.cpu().numpy().astype(np.float64).tolist())
        aux = {"actors": self.actors}
        if self.hypers is not None:
            aux["hypers"] = self.hypers
        self._mgr.save(self.step_count - 1,
                       (self.state, self.strategy.export_state()), meta,
                       aux=aux)
