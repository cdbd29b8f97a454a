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

``run_env_loop(fused=True)`` runs whole train-evolve epochs
(``RolloutEngine.build_epoch``): eagerly on the CPU, and on the card as
one CUDA graph per epoch shape, captured at first use and replayed
(:mod:`repro_torch.rollout.graph`); the results equal the eager loop's.
``attach_rollout(policy_lag=0|1)`` selects the overlapped engine
(:class:`repro_torch.rollout.OverlapEngine`).
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.pop.backend import make_update
from repro_torch.pop.strategy import make_strategy
from repro_torch.tree import tree_map


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
        self._epochs = {}
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
        updates iteration; ``policy_lag`` (0 or 1) selects the overlapped
        engine, ``chunk_steps`` chunked collection. Returns the engine."""
        from repro_torch.rollout.engine import RolloutEngine
        from repro_torch.rollout.overlap import OverlapEngine
        engine = OverlapEngine
        if engine_kwargs.get("policy_lag") is None:
            engine_kwargs.pop("policy_lag", None)
            engine = RolloutEngine
        self._rollout = engine(self.agent, self.pcfg, env,
                               update=self.update, generator=self.generator,
                               init_state=self.state, **engine_kwargs)
        self._epochs = {}
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
        hook. Returns the last (metrics, stats).

        ``fused=True`` runs the same loop as whole train-evolve epochs
        (``RolloutEngine.build_epoch``): ``pcfg.pbt_interval`` iterations,
        their evaluations and the evolve, as one CUDA graph replay an
        epoch on the card (eagerly on the CPU), equal to the eager loop.
        It needs (and checks) ``iters`` a multiple of the epoch length,
        ``eval_every`` dividing it, the epoch's evaluations within
        ``fitness_window``, an epoch-aligned ``step_count`` and an empty
        fitness window when evolution is on."""
        if fused:
            return self._run_env_loop_fused(iters, eval_every, on_iter)
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

    def _fused_epoch(self, epoch_len: int, eval_every: int, evolving: bool):
        """The epoch function from the engine's next iteration, cached by
        ``(epoch_len, eval_every, evolving, gate pattern)``: on the card a
        :class:`CapturedFunction` (captured at its first call, then
        replayed), on the CPU the eager function."""
        r = self.rollout
        gates = r.gates(r.iterations, epoch_len)
        key = (epoch_len, eval_every, evolving, gates)
        fn = self._epochs.get(key)
        if fn is None:
            epoch = r.build_epoch(
                epoch_len=epoch_len, eval_every=eval_every,
                evolve_fn=self.strategy.evolve_fn() if evolving else None,
                start=r.iterations)
            if self.generator.device.type == "cuda":
                from repro_torch.kernels import launch_counts
                from repro_torch.rollout.graph import CapturedFunction
                fn = CapturedFunction(epoch, self.generator, carried=5,
                                      counts=launch_counts)
            else:
                fn = lambda *trees: epoch(*trees, self.generator)
            self._epochs[key] = fn
        return fn, gates

    def _run_env_loop_fused(self, iters: int, eval_every: int, on_iter):
        r = self.rollout
        pbt = self.pcfg.pbt_interval
        evolving = bool(not self.strategy.null and pbt and iters >= pbt)
        if evolving:
            epoch_len = pbt
            if iters % epoch_len:
                raise ValueError(
                    f"fused train-evolve epochs need iters ({iters}) to be "
                    f"a multiple of pbt_interval ({epoch_len})")
            if not eval_every or epoch_len % eval_every:
                raise ValueError(
                    f"fused train-evolve epochs need eval_every "
                    f"({eval_every}) to divide pbt_interval ({epoch_len}) "
                    f"so every epoch scores the population before evolving")
            if epoch_len // eval_every > self.pcfg.fitness_window:
                raise ValueError(
                    f"{epoch_len // eval_every} evaluations per epoch "
                    f"overflow fitness_window={self.pcfg.fitness_window}: "
                    f"the eager loop would drop early rows and diverge")
            if self.step_count % epoch_len:
                raise ValueError(
                    f"step_count={self.step_count} is not epoch-aligned "
                    f"(pbt_interval={epoch_len}); the eager cadence would "
                    f"evolve mid-epoch")
            if self._window:
                raise ValueError(
                    "fitness window is non-empty at fused-epoch entry; the "
                    "eager loop would mix pre-epoch rows into the evolve "
                    "fitness")
        else:
            epoch_len = iters
            if (not self.strategy.null and pbt and eval_every
                    and (self.step_count + iters) // pbt
                    > self.step_count // pbt):
                raise ValueError(
                    f"iters={iters} from step {self.step_count} crosses an "
                    f"evolve boundary (pbt_interval={pbt}) mid-epoch; run "
                    f"a multiple of pbt_interval instead")
        n_evals = (epoch_len // eval_every) if eval_every else 0
        metrics = stats = None
        start = self.step_count
        for _ in range(iters // epoch_len if epoch_len else 0):
            fn, gates = self._fused_epoch(epoch_len, eval_every, evolving)
            base = self.step_count
            (self.state, r.bufs, r.vstate, hypers, strat_state, m_stack,
             s_stack, _, evals, fitness, lineage) = fn(
                self.state, r.bufs, r.vstate, self.hypers,
                self.strategy.export_state())
            self.step_count += epoch_len
            r.iterations += epoch_len
            metrics, stats = self._fused_epoch_bookkeeping(
                base, start, epoch_len, eval_every, n_evals, evolving, gates,
                hypers, strat_state, m_stack, s_stack, evals, fitness,
                lineage, on_iter)
        return metrics, stats

    def _fused_epoch_bookkeeping(self, base, start, epoch_len, eval_every,
                                 n_evals, evolving, gates, hypers,
                                 strat_state, m_stack, s_stack, evals,
                                 fitness, lineage, on_iter):
        """Re-emit the eager loop's per-iteration side effects (the fitness
        window, the evolve's ``last_fitness``, hypers and strategy state,
        ``on_iter``) from one epoch's stacked outputs, reading nothing back
        from the device. What the trainer keeps of them is cloned: a
        replay of the epoch's graph overwrites its outputs. Returns the
        last iteration's (metrics, stats)."""
        keep = lambda tree: tree_map(torch.clone, tree)
        m_stack, s_stack = keep(m_stack), keep(s_stack)
        self.hypers = hypers
        metrics = stats = None
        for i in range(epoch_len):
            metrics = None if not gates[i] else tree_map(
                lambda x: x[i], m_stack)
            stats = tree_map(lambda x: x[i], s_stack)
            fit_i = None
            if n_evals and (i + 1) % eval_every == 0:
                fit_i = evals[(i + 1) // eval_every - 1].clone()
                if not evolving:
                    self.report_fitness(fit_i)
            lin_i = None
            if evolving and i == epoch_len - 1:
                if strat_state is not None:
                    self.strategy.import_state(strat_state)
                self.last_fitness = fitness.clone()
                self._window.clear()
                lin_i = lineage.clone()
            if on_iter is not None:
                on_iter(base + i - start, metrics, stats, fit_i, lin_i)
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
