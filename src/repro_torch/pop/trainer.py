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

The fitness window stays on the device. ``save`` writes the main tree
``(state, strategy.checkpoint_state())``, the ``actors``, ``hypers``,
``rollout`` (the engine's buffers and env states) and ``rng`` (the
trainer's generator state) aux trees, and the ``size`` and ``fitness``
extras, in the layout of :mod:`repro_torch.checkpoint` (which the JAX
package's ``repro.serve.load_actor_stack`` reads); by default it returns
once the state is on the host and writes on a thread (``wait`` joins it).
The port's main tree has no per-member ``key`` leaf: the ``rng`` aux tree
is its counterpart, so a resumed run draws the numbers the uninterrupted
run would have, and equals it bit for bit from an evolve boundary (the
fitness window, which a checkpoint does not carry, is empty there).
``resume`` writes every restored leaf into the trainer's own tensors
(``tree.copy_into``): an ``LMAgent``'s leaves stay views of its flat
buffers, and a captured epoch's static inputs stay its inputs. It is
refused once an epoch has been captured (the graph holds the generator's
registration; restoring under it is not done). A checkpoint of another
population size resumes through :func:`repro_torch.elastic.restore_elastic`
(the worst members dropped, or the fittest cloned).

``telemetry`` (a :class:`repro_torch.telemetry.RunTelemetry`; a disabled
one by default) gets the phases ``update``, ``iterate``, ``eval``,
``evolve``, ``epoch`` and ``ckpt`` and the ``iter``, ``members``,
``evolve`` and ``ckpt`` rows where the JAX trainer records them; their
tensors are snapshotted once an iteration (once an epoch in fused
epochs), never read on this thread.

Over several processes (``backend="islands"`` or ``"sharded"``, one rank
per GPU under ``torch.distributed.run``), the trainer holds its island's
rows of the population (``layout``, an
:class:`repro_torch.elastic.IslandLayout`, planned from the world's size
unless given; ``mesh`` its ``DeviceMesh``): the state, the engine's envs
and buffers, and the update over them. Hypers and the fitness window stay
whole ``(N,)`` on every rank (each rank scores its members and one
collective puts the rows in member order), so PBT's ranking, parent picks
and explore draws come out the same everywhere; its member copy is the
cross-rank :class:`repro_torch.core.distributed.MemberExchange`. The
generator is a :func:`~repro_torch.core.distributed.member_generator`,
whose member-axis draws are made at the whole population's shape, so a
run on K ranks computes what a run on one computes. Rank 0 gathers the
rows of every island and writes the checkpoints (in the one-rank format);
every rank reads them and takes its rows. CEM runs over the islands too
(:class:`~repro_torch.pop.strategy.CEM` bound over the trainer's
:class:`~repro_torch.pop.strategy.Spread`: its rows, its model parts and
its ``pop`` group): member 0 and the elites are broadcast by their
owners, every draw is made at the whole population's and the whole
member's shape, and rank 0 checkpoints the whole distribution, so the run
is the one-rank run bit for bit. DvD's evolve is the identity on any
layout (a shared-critic agent is refused by the backend, as in the JAX
package). A fused epoch and ``policy_lag=1`` over more than one island
are refused by name: they would need the islands' collectives inside a
captured graph or on a second stream.

On an islands layout whose model axis is above 1, an LM agent's members
are model-sharded (``shard``, this rank's
:class:`~repro_torch.models.sharding.ModelShard`): each rank holds its
parts of its island's members, cut by the rules of
:mod:`repro_torch.models.sharding`, and updates them with one
``pop_adam`` launch a step; PBT's exchange moves each part to the rank at
the same model coordinate of the destination island; rank 0 gathers every
leaf whole along its sharded dimension, so a checkpoint has the one-rank
format and resumes at any model width. An RL agent's members stay whole
on every model rank. Every LM family shards, under PBT, CEM (each rank
refits and redraws its columns of the members, through the agent's
:class:`~repro_torch.models.sharding.PartMap`) and DvD.

``run_env_loop(fused=True)`` runs whole train-evolve epochs
(``RolloutEngine.build_epoch``): eagerly on the CPU, and on the card as
one CUDA graph per epoch shape, captured at first use and replayed
(:mod:`repro_torch.rollout.graph`); the results equal the eager loop's.
``attach_rollout(policy_lag=0|1)`` selects the overlapped engine
(:class:`repro_torch.rollout.OverlapEngine`).
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.core.distributed import (MemberExchange, Rows, all_members,
                                          gather_to_root, member_generator,
                                          take_rows, world)
from repro_torch.models.sharding import local_tree
from repro_torch.pop.backend import make_update
from repro_torch.pop.strategy import Spread, make_strategy
from repro_torch.telemetry import RunTelemetry
from repro_torch.tree import copy_into, leaves, tree_map


def _part(snap, key):
    """The ``key`` entry of a snapshot of a dict (None when disabled)."""
    return None if snap is None else snap.map(lambda tree: tree[key])


# sources the RL path launches; rank 0 builds them before the others
# load them
_PATH_SOURCES = ("pop_matmul", "hopper2d")


class PopTrainer:
    def __init__(self, agent, pcfg: PopulationConfig | None = None, *,
                 seed: int = 0, checkpoint_dir=None, keep: int = 2,
                 telemetry: RunTelemetry | None = None, layout=None,
                 mesh=None):
        self.agent = agent
        self.telemetry = telemetry if telemetry is not None \
            else RunTelemetry(None)
        self.pcfg = pcfg = pcfg if pcfg is not None else PopulationConfig()
        self.n = pcfg.size
        self.strategy = make_strategy(pcfg)
        self.layout, self.mesh = self._plan(layout, mesh)
        self.rows = (self.layout.rows() if self.layout is not None
                     else Rows(0, self.n, self.n))
        self.shard = None
        if getattr(agent, "model_sharded_params", False):
            from repro_torch.launch.mesh import model_shard
            self.shard = model_shard(self.mesh)
        self.generator = member_generator(agent.device,
                                          self.rows).manual_seed(seed)
        self.strategy.configure_agent(agent)
        # ``pcfg.num_steps`` chained update steps per call, shared with the
        # acting engine (built first: a backend refuses an agent it cannot
        # split before any state is made)
        self.update = make_update(agent, pcfg.backend,
                                  num_steps=max(1, pcfg.num_steps),
                                  mesh=self.mesh)
        self._host_group = None
        self._log_rows = False
        if self.distributed:
            self._join_ranks()

        init_gen = torch.Generator().manual_seed(seed)
        where = {}
        if self.split:
            where["rows"] = self.rows
        if self.shard is not None:
            where["shard"] = self.shard
        self.state = agent.population_init(init_gen, self.n, **where)
        self.state = self.strategy.bind(self.generator, agent, self.state,
                                        over=self._spread())
        if self.split and hasattr(self.strategy, "gather"):
            self.strategy.gather = MemberExchange(self.strategy.gather,
                                                  self.layout)
        self.hypers = self.strategy.init_hypers(self.generator, self.n)

        self._window: deque = deque(maxlen=pcfg.fitness_window)
        self.last_fitness = None  # the (N,) fitness used at the last evolve
        self.step_count = 0
        # an LM run sets the tokens one member consumes a step; the iter
        # rows then carry a dispatch-rate tokens_per_sec_per_member
        self.tokens_per_step = None
        self._iter_t = None
        self._rollout = None
        self._epochs = {}
        self._mgr = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointManager
            run_meta = ({"run_id": self.telemetry.run_id}
                        if self.telemetry.enabled else None)
            self._mgr = CheckpointManager(checkpoint_dir, keep=keep,
                                          run_meta=run_meta)
        # the step-0 snapshot anchors the hyper trajectories
        self.telemetry.record_members(0, hypers=self.hypers)

    # ------------------------------------------------------------ placement
    def _plan(self, layout, mesh):
        """``(layout, mesh)`` of the backend: the islands layout planned
        over the world's ranks (or given), the sharded backend's layout
        (:func:`repro_torch.elastic.layout.sharded_layout`), else none."""
        backend = self.pcfg.backend
        if backend not in ("islands", "sharded"):
            return None, mesh
        from repro_torch.elastic.layout import plan_layout, sharded_layout
        _, size = world()
        if backend == "islands":
            layout = layout if layout is not None else plan_layout(size,
                                                                   self.n)
        else:
            from repro_torch.launch.mesh import make_host_mesh, mesh_size
            if mesh is None and size > 1:
                mesh = make_host_mesh(model=1)
            if mesh_size(mesh, "model") > 1 or (layout is not None
                                                and layout.model > 1):
                raise NotImplementedError(
                    "the sharded backend splits the population only: "
                    "model-sharded members run on the islands backend "
                    "(backend='islands' with a layout whose model axis is "
                    "above 1)")
            layout = layout if layout is not None else sharded_layout(
                size, self.n)
        if layout.population != self.n:
            raise ValueError(f"{layout} is planned for another population "
                             f"than size={self.n}")
        if mesh is None and backend == "islands":
            mesh = layout.mesh
        return layout, mesh

    def _spread(self):
        """The :class:`~repro_torch.pop.strategy.Spread` the strategy binds
        over: None when this rank holds every member whole."""
        if not self.split and self.shard is None:
            return None
        parts = (self.agent.part_map(self.shard)
                 if self.shard is not None else None)
        return Spread(self.layout, self.rows, self._pop_group,
                      self._host_group, parts)

    @property
    def split(self) -> bool:
        """Whether this rank holds only some members (more than one
        island)."""
        return self.layout is not None and self.layout.islands > 1

    @property
    def distributed(self) -> bool:
        return world()[1] > 1 and self.layout is not None

    @property
    def _pop_group(self):
        """The group of one rank per island in this rank's column."""
        if self.mesh is None:
            return None
        name = "pop" if "pop" in self.mesh.mesh_dim_names else "data"
        return self.mesh.get_group(name)

    def _join_ranks(self):
        """Collective set-up: a gloo group for the host traffic
        (checkpoints) beside an NCCL one, whether any rank logs (then
        every rank gathers the rows its telemetry rows need), and the
        kernels built by rank 0 before any rank launches one."""
        import torch.distributed as dist
        if dist.get_backend() != "gloo":
            self._host_group = dist.new_group(backend="gloo")
        flag = torch.tensor([int(self.telemetry.enabled)])
        dist.all_reduce(flag, group=self._host_group)
        self._log_rows = bool(flag.item())
        if self.agent.device.type == "cuda":
            if world()[0] == 0:
                from repro_torch.kernels.build import build
                build(_PATH_SOURCES)
            dist.barrier(group=self._host_group)

    def local(self, tree):
        """This rank's rows of a whole-population tree (the hypers)."""
        return tree if tree is None else take_rows(tree, self.rows)

    def model_part(self, tree):
        """This rank's parts of a tree of whole members (leaves narrowed
        along the dimension the rules shard; views); the tree itself
        unless the members are model-sharded."""
        if self.shard is None:
            return tree
        return local_tree(tree, self.agent.shard_dims(tree, self.shard),
                          self.shard)

    def _placement(self):
        """How this trainer places a whole-population host tree (a
        restored checkpoint): its rows and, model-sharded, its parts of
        them, the same choice ``__init__`` made for the fresh state
        (``repro.pop.trainer``'s ``_placement``)."""
        return lambda tree: self.model_part(self.local(tree))

    def all_members(self, tree):
        """Every member's rows of a tree of this rank's rows (metrics,
        episode stats, fitness): a collective that every rank calls; the
        tree itself when the rank holds every member."""
        if tree is None or not self.split:
            return tree
        return all_members(tree, self.rows, self._pop_group)

    def _all_rows(self, tree):
        """:meth:`all_members` for the telemetry rows: the tree itself
        when no rank logs."""
        return self.all_members(tree) if self._log_rows else tree

    def _batch_rows(self, batch):
        """This rank's rows of a whole-population batch (leaves (N, ...),
        or (num_steps, N, ...))."""
        if not self.split:
            return batch
        axis = 0 if max(1, self.pcfg.num_steps) == 1 else 1
        lo, hi = self.rows.lo, self.rows.hi
        return tree_map(lambda x: x.narrow(axis, lo, hi - lo)
                        if x.shape[axis] == self.n else x, batch)

    # ------------------------------------------------------------------ run
    def step(self, batch, fitness=None):
        """One update call (``pcfg.num_steps`` chained member-steps), then,
        on cadence, one evolve. Fitness is ``fitness`` when given, else the
        agent's from the update's metrics (None for an RL agent). Returns
        ``(metrics, lineage)``; lineage is None unless evolution ran."""
        with self.telemetry.phase("update"):
            self.state, metrics = self.update(
                self.state, self._batch_rows(batch), self.local(self.hypers),
                self.generator)
        self.step_count += 1
        fit = (fitness if fitness is not None
               else self.agent.fitness_from_metrics(metrics))
        if fit is not None:
            self.report_fitness(fit)
        lineage = self._maybe_evolve()
        extra = {}
        if self.tokens_per_step:
            now = time.perf_counter()
            if self._iter_t is not None and now > self._iter_t:
                extra["tokens_per_sec_per_member"] = \
                    self.tokens_per_step / (now - self._iter_t)
            self._iter_t = now
        self.telemetry.record_iteration(self.step_count - 1,
                                        metrics=self._all_rows(metrics),
                                        **extra)
        return metrics, lineage

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
        if self.split and engine_kwargs.get("policy_lag") == 1:
            raise NotImplementedError(
                "policy_lag=1 over more than one island is not ported yet: "
                "its second stream would hold the islands' collectives")
        if engine_kwargs.get("policy_lag") is None:
            engine_kwargs.pop("policy_lag", None)
            engine = RolloutEngine
        engine_kwargs.setdefault("telemetry", self.telemetry)
        self._rollout = engine(self.agent, self.pcfg, env,
                               update=self.update, generator=self.generator,
                               init_state=self.state, mesh=self.mesh,
                               **engine_kwargs)
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
        with self.telemetry.phase("iterate"):
            self.state, metrics, stats, did = self.rollout.iterate(
                self.state, self.local(self.hypers), self.generator)
        self.step_count += 1
        return metrics, stats, did

    def evaluate_fitness(self):
        """Per-member fitness from deterministic evaluation episodes, an
        (N,) device tensor of every member (each rank scores its own);
        does not touch the fitness window."""
        with self.telemetry.phase("eval"):
            return self._all_fitness(self.rollout.evaluator.evaluate(
                self.actors, self.generator))

    def run_env_loop(self, iters: int, *, eval_every: int = 1, on_iter=None,
                     fused: bool = False, block_every: int = 0):
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
        fitness window when evolution is on.

        ``block_every=N`` (the eager loop only) waits for the iteration's
        results every N iterations under ``telemetry.block``, splitting the
        iter rows into dispatch time (``phases``) and wait (``blocks``)."""
        if fused:
            if self.split:
                raise NotImplementedError(
                    "a fused epoch over more than one island is not ported "
                    "yet: its captured graph would hold the PBT exchange's "
                    "collectives")
            if block_every:
                raise ValueError("block_every instruments the eager loop; "
                                 "a fused epoch is one device program")
            return self._run_env_loop_fused(iters, eval_every, on_iter)
        tel = self.telemetry
        metrics = stats = None
        for it in range(iters):
            metrics, stats, did = self.env_iteration()
            if block_every and (it + 1) % block_every == 0:
                tel.block("iterate", (metrics, stats))
            fitness = None
            if eval_every and (it + 1) % eval_every == 0:
                fitness = self.evaluate_fitness()
                self.report_fitness(fitness)
            # one snapshot an iteration, before the evolve replaces hypers
            snap = tel.snapshot({"metrics": self._all_rows(metrics),
                                 "stats": self._all_rows(stats),
                                 "fitness": fitness, "hypers": self.hypers})
            if fitness is not None:
                tel.record_members(self.step_count,
                                   fitness=_part(snap, "fitness"),
                                   hypers=_part(snap, "hypers"))
            lineage = self._maybe_evolve()
            tel.record_iteration(
                self.step_count - 1,
                metrics=None if metrics is None else _part(snap, "metrics"),
                stats=_part(snap, "stats"), did_update=did)
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
            # the replay overwrites the hypers in place: the eval rows'
            # hypers are those the epoch started with
            hypers_before = self.telemetry.snapshot(self.hypers)
            with self.telemetry.phase("epoch"):
                (self.state, r.bufs, r.vstate, hypers, strat_state, m_stack,
                 s_stack, _, evals, fitness, lineage) = fn(
                    self.state, r.bufs, r.vstate, self.hypers,
                    self.strategy.export_state())
            self.step_count += epoch_len
            r.iterations += epoch_len
            metrics, stats = self._fused_epoch_bookkeeping(
                base, start, epoch_len, eval_every, n_evals, evolving, gates,
                hypers, hypers_before, strat_state, m_stack, s_stack, evals,
                fitness, lineage, on_iter)
        return metrics, stats

    def _fused_epoch_bookkeeping(self, base, start, epoch_len, eval_every,
                                 n_evals, evolving, gates, hypers,
                                 hypers_before, strat_state, m_stack,
                                 s_stack, evals, fitness, lineage, on_iter):
        """Re-emit the eager loop's per-iteration side effects (the fitness
        window, the evolve's ``last_fitness``, hypers and strategy state,
        the telemetry rows, ``on_iter``) from one epoch's stacked outputs,
        reading nothing back from the device. What the trainer keeps of
        them is cloned once (a replay of the epoch's graph overwrites its
        outputs), and the rows read slices of one snapshot of those
        clones. Returns the last iteration's (metrics, stats)."""
        tel = self.telemetry
        keep = lambda tree: tree_map(torch.clone, tree)
        m_stack, s_stack, evals, fitness, lineage = keep(
            (m_stack, s_stack, evals, fitness, lineage))
        self.hypers = hypers
        snap = None if not tel.enabled else tel.snapshot(
            {"m": m_stack, "s": s_stack, "evals": evals, "fitness": fitness,
             "lineage": lineage, "hypers": keep(hypers)}, clone=False)
        metrics = stats = None
        for i in range(epoch_len):
            metrics = None if not gates[i] else tree_map(
                lambda x: x[i], m_stack)
            stats = tree_map(lambda x: x[i], s_stack)
            fit_i = None
            if n_evals and (i + 1) % eval_every == 0:
                row = (i + 1) // eval_every - 1
                fit_i = evals[row]
                if not evolving:
                    self.report_fitness(fit_i)
                tel.record_members(
                    base + i + 1, hypers=hypers_before,
                    fitness=None if snap is None else snap.map(
                        lambda t, row=row: t["evals"][row]))
            lin_i = None
            if evolving and i == epoch_len - 1:
                if strat_state is not None:
                    self.strategy.import_state(strat_state)
                self.last_fitness = fitness
                self._window.clear()
                lin_i = lineage
                tel.record_evolve(base + epoch_len, _part(snap, "lineage"),
                                  fitness=_part(snap, "fitness"),
                                  strategy=type(self.strategy).__name__)
                tel.record_members(base + epoch_len,
                                   hypers=_part(snap, "hypers"))
            if snap is not None:
                pick = lambda name, i=i: snap.map(
                    lambda t: tree_map(lambda x: x[i], t[name]))
                tel.record_iteration(
                    base + i, metrics=pick("m") if gates[i] else None,
                    stats=pick("s"), did_update=gates[i])
            if on_iter is not None:
                on_iter(base + i - start, metrics, stats, fit_i, lin_i)
        return metrics, stats

    # ---------------------------------------------------------------- evolve
    def _all_fitness(self, fitness):
        """The (N,) fitness of every member from this rank's rows (the
        whole tensor when it already holds N)."""
        fitness = torch.as_tensor(fitness)
        if fitness.shape[0] != self.n:
            return self.all_members(fitness)
        return fitness

    def report_fitness(self, fitness):
        """Feed a per-member fitness row into the window (kept on the
        device): every member's, or this rank's rows of it, which every
        rank then puts together."""
        self._window.append(self._all_fitness(fitness))

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
        tel = self.telemetry
        with tel.phase("evolve"), tel.compile_scope("evolve"):
            self.state, self.hypers, lineage = self.strategy.evolve(
                self.generator, self.state, self.hypers, self.last_fitness)
        # pre-evolve fitness describes states that may just have been
        # replaced; start the next window fresh
        self._window.clear()
        snap = tel.snapshot({"lineage": lineage, "fitness": self.last_fitness,
                             "hypers": self.hypers})
        tel.record_evolve(self.step_count, _part(snap, "lineage"),
                          fitness=_part(snap, "fitness"),
                          strategy=type(self.strategy).__name__)
        # post-evolve: the hypers the children train with
        tel.record_members(self.step_count, hypers=_part(snap, "hypers"))
        return lineage

    # ------------------------------------------------------------ checkpoint
    @property
    def actors(self):
        """Stacked per-member policy params (for rollout and serving)."""
        return self.agent.actor_params(self.state)

    def save(self, extra: dict | None = None, *,
             blocking: bool = False) -> float:
        """Checkpoint at step ``step_count - 1``: the main tree (population
        state, strategy internals), the ``actors``, ``hypers``,
        ``rollout`` and ``rng`` aux trees, ``size`` and ``fitness`` (the
        live window's mean, or None right after an evolve) in the extras.
        ``blocking=False`` returns once every leaf is on the host and
        writes on a thread. Returns the seconds the caller was blocked
        (also the ``ckpt`` row's ``secs``)."""
        if self._mgr is None:
            raise ValueError("PopTrainer built without checkpoint_dir")
        whole = not self.split and self.shard is None
        if self.distributed and world()[0] != 0 and whole:
            # every rank holds every member: rank 0's copy is written
            if blocking:
                self._barrier()
            return 0.0
        t0 = time.perf_counter()
        fit = self.fitness()
        meta = dict(extra or {}, size=self.n,
                    fitness=None if fit is None else
                    fit.cpu().numpy().astype(np.float64).tolist())
        members = {"state": self.state, "actors": self.actors}
        if self._rollout is not None:
            members["rollout"] = self._rollout.export_state()
        with self.telemetry.phase("ckpt"):
            # rank 0 writes every island's rows, whole, and the strategy's
            # whole state
            strat_state = self.strategy.checkpoint_state()
            if not whole:
                members = gather_to_root(
                    members, self.layout, self._host_group,
                    dims=None if self.shard is None else
                    self.agent.shard_dims(members, self.shard))
            if members is not None:
                aux = {"actors": members["actors"],
                       "rng": self.generator.get_state()}
                if self.hypers is not None:
                    aux["hypers"] = self.hypers
                if "rollout" in members:
                    aux["rollout"] = members["rollout"]
                save = self._mgr.save if blocking else self._mgr.save_async
                save(self.step_count - 1, (members["state"], strat_state),
                     meta, aux=aux)
            if blocking:
                self._barrier()
        secs = time.perf_counter() - t0
        self.telemetry.record_ckpt(self.step_count - 1, secs,
                                   blocking=blocking)
        return secs

    def refuse_after_capture(self, what: str):
        """Raise once a fused epoch was captured as a CUDA graph: the graph
        holds the generator's registration, and restoring under it is not
        done."""
        if any(getattr(fn, "graph", None) is not None
               for fn in self._epochs.values()):
            raise RuntimeError(
                f"{what} after a fused epoch was captured as a CUDA graph: "
                f"the graph holds the generator's registration, and "
                f"restoring under it is not supported; restore before the "
                f"first fused epoch")

    def restore_generator(self, mgr, step=None):
        """Set the generator to the checkpoint's ``rng`` aux tree, when it
        has one."""
        mine = self.generator.get_state()
        rng = mgr.restore_aux("rng", mine, step)
        if rng is not None:
            if rng.shape != tuple(mine.shape):
                raise ValueError(
                    f"the checkpoint's generator state has {rng.shape[0]} "
                    f"bytes, this trainer's {mine.shape[0]}: it was written "
                    f"on another device type")
            self.generator.set_state(torch.from_numpy(rng))

    def resume(self):
        """Restore the latest checkpoint, if there is one: population
        state, hypers, strategy internals, the engine's buffers and env
        states (when an engine is attached and the checkpoint has them),
        the generator's state and the step; every leaf written into the
        trainer's own tensors. Returns the restored step (the one ``save``
        recorded) or None. The population size must be the checkpoint's:
        a resume at another size goes through
        :func:`repro_torch.elastic.restore_elastic`."""
        if self._mgr is None or self._mgr.latest() is None:
            return None
        self.refuse_after_capture("resume")
        (state, strat_state), extra = self._mgr.restore(
            (self.state, self.strategy.export_state()))
        restored_n = leaves(self.agent.actor_params(state))[0].shape[0]
        if restored_n != self.n:
            raise ValueError(
                f"checkpoint holds a population of {restored_n} but the "
                f"config says size={self.n}; resume with the original "
                f"size, or take the elastic resume: "
                f"repro_torch.elastic.restore_elastic (launch.train: "
                f"--resize auto)")
        place = self._placement()
        copy_into(self.state, place(state))
        del state
        if self.hypers is not None:
            hypers = self._mgr.restore_aux("hypers", self.hypers)
            if hypers is not None:
                copy_into(self.hypers, hypers)
        if strat_state is not None:      # this rank's columns of it
            self.strategy.import_state(strat_state)
        if self._rollout is not None:
            rstate = self._mgr.restore_aux("rollout",
                                           self._rollout.export_state())
            if rstate is not None:
                self._rollout.import_state(place(rstate))
                # an RL trainer step is one engine iteration
                self._rollout.iterations = extra["step"] + 1
        self.restore_generator(self._mgr)
        self._window.clear()
        self.step_count = extra["step"] + 1
        return extra["step"]

    def _barrier(self):
        if self.distributed:
            import torch.distributed as dist
            dist.barrier(group=self._host_group)

    def wait(self):
        """Wait for the checkpoint write in flight; over several ranks
        every rank calls it and returns once rank 0's write is done."""
        if self._mgr is not None:
            self._mgr.wait()
            self._barrier()
