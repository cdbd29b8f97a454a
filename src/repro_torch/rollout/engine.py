"""The population's train iteration (``repro.rollout.engine``). What the
iteration does with experience depends on the agent's declared
``experience_kind`` (the :mod:`repro_torch.data.experience` protocol):

  replay (off-policy: td3, sac, dqn, the shared critic)
      collect -> insert into the population's replay rings -> sample
      -> ``pcfg.num_steps`` chained updates. The JAX package gates the
      updates on ``buffer_can_sample`` with a ``lax.cond``; here the gate
      is decided on the host: every member inserts ``collect_steps *
      num_envs`` transitions per iteration, so after iteration i every
      buffer holds ``(i + 1) * collect_steps * num_envs`` and the
      iteration reads nothing back from the device.

  trajectory (on-policy: ppo)
      collect (time-major, recording the policy's log_prob and value
      extras) -> store the fixed-length rollout -> GAE on the device
      (per-member discount and gae_lambda; ``V(next_obs)`` from one
      population-level ``pop_value`` call) -> ``epochs`` x shuffled
      minibatches, chained through the same backend call
      (``repro_torch.pop.make_update``) as everything else. There is no
      warm-up gate: a full rollout is always consumable.

The engine owns the mutable device state that is not part of the
population state: the experience buffers and the env states with their
episode accounting. ``chunk_steps`` collects in chunks folded into the
store one at a time (:meth:`Collector.collect_into`), bounding memory at
thousands of envs a member with the same results.

:meth:`RolloutEngine.build_epoch` returns a whole train-evolve epoch as
one function: ``epoch_len`` iterations, an evaluation every
``eval_every``, then the strategy's pure evolve on the epoch-mean
fitness. The trainer runs it eagerly on the CPU, and on the card captures
it once as a CUDA graph (:mod:`repro_torch.rollout.graph`) and replays
it: the port's counterpart of the JAX package's one jitted epoch. Every
step of it stays on the device; the only host decision inside, the
can-sample gate, is known on the host before the epoch starts.

:meth:`RolloutEngine.export_state` and :meth:`~RolloutEngine.import_state`
carry the buffers and env states through a checkpoint (the trainer's
``rollout`` aux tree), every leaf population-first; the import writes
into the engine's own tensors, which a captured epoch holds as its static
inputs; a state of another population size is resized before the import
(:func:`repro_torch.elastic.restore_elastic`). Given an enabled
``telemetry``, the engine records its shape once as an ``engine`` row.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.data.experience import (compute_gae, experience_ops,
                                         traj_add, traj_reset)
from repro_torch.data.replay_buffer import buffer_sample
from repro_torch.rollout.collector import Collector, default_exploration
from repro_torch.rollout.evaluator import Evaluator
from repro_torch.rollout.vecenv import VecEnv, episode_stats
from repro_torch.tree import copy_into, distinct, leaves, tree_map

# the rollout fields an on-policy update consumes, besides GAE's two
_ONPOLICY_FIELDS = ("obs", "action", "log_prob", "value")


class RolloutEngine:
    """Owns the env states, the population's experience buffers and the
    iteration. ``update`` is the trainer's chained update
    (``repro_torch.pop.make_update``: ``pcfg.num_steps`` chained steps per
    call), which the replay kind runs; the trajectory kind builds its own
    with ``epochs * minibatches`` chained steps on the same backend."""

    def __init__(self, agent, pcfg, env, *, update, generator, init_state,
                 num_envs: int = 8, collect_steps: int = 32,
                 batch_size: int = 128, buffer_capacity: int = 100_000,
                 epochs: int = 4, eval_envs: int = 4,
                 eval_steps: int | None = None,
                 chunk_steps: int | None = None, telemetry=None,
                 mesh=None):
        if chunk_steps is not None and collect_steps % chunk_steps:
            raise ValueError(f"chunk_steps={chunk_steps} must divide "
                             f"collect_steps={collect_steps}")
        self.chunk_steps = chunk_steps
        self.agent = agent
        self.kind = agent.experience_kind
        self.exp = experience_ops(self.kind)
        # the members this rank holds: the whole population, or one
        # island's rows of it (the trainer's layout)
        self.n = leaves(agent.actor_params(init_state))[0].shape[0]
        self.num_envs = num_envs
        self.collect_steps = collect_steps
        self.batch_size = batch_size
        device = leaves(init_state)[0].device

        if self.kind == "trajectory":
            if agent.population_level:
                raise ValueError("trajectory experience requires per-member "
                                 "agents (population-level updates consume "
                                 "replay batches)")
            rollout = collect_steps * num_envs
            if batch_size > rollout or rollout % batch_size:
                raise ValueError(
                    f"on-policy minibatch size {batch_size} must divide the "
                    f"rollout of collect_steps*num_envs = {rollout} "
                    f"transitions per member")
            self.epochs = max(1, epochs)
            self.minibatches = rollout // batch_size
            self.num_steps = self.epochs * self.minibatches
            defaults = agent.default_hypers
            self._gae_defaults = {
                "discount": defaults.get("discount", 0.99),
                "gae_lambda": defaults.get("gae_lambda", 0.95)}
            from repro_torch.pop.backend import make_update
            update = make_update(agent, pcfg.backend,
                                 num_steps=self.num_steps, mesh=mesh)
        else:
            self.num_steps = max(1, pcfg.num_steps)
        self.update = update

        self.venv = VecEnv(env, num_envs)
        self.collector = Collector(self.venv, default_exploration(agent))
        module = agent.exploration_module
        self.evaluator = Evaluator(
            env, lambda actors, obs: module.pop_policy(actors, obs),
            num_envs=eval_envs, num_steps=eval_steps)

        self.vstate = self.collector.init(generator, self.n, device)
        self.bufs = self.exp.init(
            env.spec, self.n, device, capacity=buffer_capacity,
            num_steps=collect_steps, num_envs=num_envs,
            extras=getattr(agent, "experience_extras",
                           ("log_prob", "value")))
        self.iterations = 0
        if telemetry is not None and telemetry.enabled:
            # the acting side's shape, once, so a log describes itself
            telemetry.record(
                "engine", algo=type(agent).__name__, experience=self.kind,
                env=env.spec.name, population=pcfg.size, num_envs=num_envs,
                collect_steps=collect_steps, batch_size=batch_size,
                num_steps=self.num_steps, chunk_steps=chunk_steps,
                policy_lag=getattr(self, "policy_lag", None),
                env_steps_per_iteration=self.env_steps_per_iteration)

    def filled(self, iterations: int | None = None) -> int:
        """Transitions each member has inserted after ``iterations``
        iterations (default: so far), counted on the host."""
        done = self.iterations if iterations is None else iterations
        return done * self.collect_steps * self.num_envs

    def can_sample(self, iterations: int | None = None) -> bool:
        """The replay kind's can-sample gate after ``iterations``
        iterations, decided on the host: every buffer holds a batch."""
        return self.filled(iterations) >= self.batch_size

    def gates(self, start: int, count: int) -> tuple:
        """Whether each of iterations ``start .. start + count - 1``
        updates: the host-known gate pattern (an on-policy iteration always
        updates)."""
        if self.kind == "trajectory":
            return (True,) * count
        return tuple(self.can_sample(start + i + 1) for i in range(count))

    def collect_insert(self, actors, bufs, vstate, hypers, generator):
        """Collect one iteration's experience and store it; with
        ``chunk_steps`` chunk by chunk (an on-policy store is reset once,
        then appended to). Returns ``(bufs, vstate)``."""
        flat = self.kind == "replay"
        if self.chunk_steps is not None:
            if flat:
                add = self.exp.add
            else:
                bufs, add = traj_reset(bufs), traj_add
            vstate, bufs = self.collector.collect_into(
                actors, vstate, bufs, add, generator, self.collect_steps,
                self.chunk_steps, hypers, flat=flat)
            return bufs, vstate
        vstate, traj = self.collector.collect(
            actors, vstate, generator, self.collect_steps, hypers, flat=flat)
        return self.exp.add(bufs, traj), vstate

    def update_from(self, state, bufs, actors, hypers, generator,
                    done: int):
        """The update half of an iteration on stored experience, after
        ``done`` iterations have inserted theirs: ``(state, metrics,
        did_update)``, ``metrics`` None while the replay gate is shut."""
        if self.kind == "trajectory":
            batches = self.population_batches(bufs, actors, hypers,
                                              generator)
        elif not self.can_sample(done):
            return state, None, False
        else:
            batches = buffer_sample(bufs, generator, self.batch_size,
                                    self.num_steps, filled=self.filled(done))
            if self.num_steps == 1:
                batches = tree_map(lambda x: x[0], batches)
        state, metrics = self.update(state, batches, hypers, generator)
        return state, metrics, True

    def iteration(self, state, bufs, vstate, hypers, generator, done: int):
        """One iteration as a function of its inputs, ``done`` iterations
        in: ``(state, bufs, vstate, metrics, episode_stats, did_update)``.
        It changes nothing on the engine, so :meth:`build_epoch` chains
        it."""
        actors = self.agent.actor_params(state)
        bufs, vstate = self.collect_insert(actors, bufs, vstate, hypers,
                                           generator)
        state, metrics, did = self.update_from(state, bufs, actors, hypers,
                                               generator, done + 1)
        return state, bufs, vstate, metrics, episode_stats(vstate), did

    def iterate(self, state, hypers, generator):
        """One train iteration. Returns ``(state, metrics, episode_stats,
        did_update)``; until a replay ring can serve a batch the iteration
        only collects, and ``metrics`` is None. An on-policy iteration
        always updates."""
        state, self.bufs, self.vstate, metrics, stats, did = self.iteration(
            state, self.bufs, self.vstate, hypers, generator,
            self.iterations)
        self.iterations += 1
        return state, metrics, stats, did

    # ------------------------------------------------- fused train-evolve
    def build_epoch(self, *, epoch_len: int, eval_every: int = 0,
                    evolve_fn=None, start: int = 0):
        """A whole train-evolve epoch as one function of its inputs, from
        iteration ``start``:

            epoch(state, bufs, vstate, hypers, strat_state, generator) ->
                (state, bufs, vstate, hypers, strat_state, metrics_stack,
                 stats_stack, did_stack, evals, fitness, lineage)

        ``epoch_len`` iterations; every ``eval_every``-th one also scores
        the population into row ``(i + 1) // eval_every - 1`` of
        ``evals`` (``(num_evals, N)``; ``eval_every=0`` disables); then
        ``evolve_fn`` (a strategy's ``evolve_fn()``) runs on the mean of
        those rows, which is the trainer's windowed fitness. The stacks
        carry a leading ``(epoch_len,)`` axis: the metrics hold zeros where
        the gate was shut (None when no iteration of the epoch updates),
        ``did_stack`` is the gate pattern as a device bool vector, and
        lineage is the identity without an evolve. The generator's draws
        come in the eager loop's order (each iteration, its evaluation,
        then the evolve), so the epoch equals that loop bit for bit.
        Nothing in it reads the device or copies from the host."""
        n = self.n
        n_evals = (epoch_len // eval_every) if eval_every else 0
        evaluator, agent = self.evaluator, self.agent

        def epoch(state, bufs, vstate, hypers, strat_state, generator):
            device = leaves(state)[0].device
            evals = torch.zeros((max(n_evals, 1), n), device=device)
            dids = torch.zeros((epoch_len,), dtype=torch.bool, device=device)
            rows, stats = [], []
            for i in range(epoch_len):
                state, bufs, vstate, metrics, st, did = self.iteration(
                    state, bufs, vstate, hypers, generator, start + i)
                if did:
                    dids[i].fill_(True)
                rows.append(metrics)
                stats.append(st)
                if n_evals and (i + 1) % eval_every == 0:
                    evals[(i + 1) // eval_every - 1] = evaluator.evaluate(
                        agent.actor_params(state), generator)
            fitness = evals.mean(0) if n_evals else torch.zeros(
                (n,), device=device)
            if evolve_fn is not None:
                state, hypers, lineage, strat_state = evolve_fn(
                    generator, state, hypers, fitness, strat_state)
            else:
                lineage = torch.arange(n, device=device)
            real = next((m for m in rows if m is not None), None)
            metrics = None if real is None else tree_map(
                lambda *xs: torch.stack(xs), *(
                    m if m is not None else tree_map(torch.zeros_like, real)
                    for m in rows))
            return (state, bufs, vstate, hypers, strat_state, metrics,
                    tree_map(lambda *xs: torch.stack(xs), *stats), dids,
                    evals, fitness, lineage)

        return epoch

    # ------------------------------------------------------ on-policy side
    def advantages(self, bufs, actors, hypers=None):
        """GAE over the stored rollouts: ``(advantages, returns)``, each
        (N, T, E). ``V(next_obs)`` is one population-level value call on
        the stored pre-reset next observations, so a truncated step still
        bootstraps while ``done`` zeroes true terminals; ``ep_end`` cuts the
        lambda chain at either."""
        d = bufs.data
        n, t, e = d["reward"].shape
        h = dict(self._gae_defaults)
        if hypers:
            h.update({k: hypers[k] for k in h if k in hypers})
        with torch.no_grad():
            next_v = self.agent.pop_value(
                actors, d["next_obs"].flatten(1, 2)).reshape(n, t, e)
        ep_end = torch.maximum(d["done"], d["truncated"])
        return compute_gae(d["reward"], d["value"], next_v, d["done"],
                           ep_end, h["discount"], h["gae_lambda"])

    def population_batches(self, bufs, actors, hypers, generator, *,
                           perms=None):
        """The whole population's update batches in the chained layout
        ``(K, N, B, ...)`` (``(N, B, ...)`` when K == 1), K = epochs *
        minibatches. Each member's rollout of D = T*E transitions is
        shuffled by one permutation an epoch, ``perms`` (N, epochs, D),
        drawn from ``generator`` unless given, and cut into minibatches of
        B, epoch-major."""
        adv, ret = self.advantages(bufs, actors, hypers)
        flat = {k: bufs.data[k] for k in _ONPOLICY_FIELDS}
        flat.update(advantage=adv, **{"return": ret})
        flat = {k: v.flatten(1, 2) for k, v in flat.items()}  # (N, D, ...)
        n, d = adv.shape[0], adv.shape[1] * adv.shape[2]
        if perms is None:
            perms = member_draw(torch.rand, (n, self.epochs, d),
                                generator).argsort(-1)
        device = adv.device
        idx = perms.to(device).reshape(n, self.num_steps,
                                       self.batch_size).transpose(0, 1)
        rows = torch.arange(n, device=device)[None, :, None]
        batches = {k: v[rows, idx] for k, v in flat.items()}  # (K, N, B, ..)
        if self.num_steps == 1:
            batches = {k: v[0] for k, v in batches.items()}
        return batches

    def probe_obs(self, generator, size: int):
        """``size`` observations sampled from member 0's replay buffer
        (DvD's behaviour probes and similar diagnostics): (size, obs)."""
        buf0 = tree_map(lambda x: x[:1], self.bufs)
        return buffer_sample(buf0, generator, size,
                             filled=self.filled())["obs"][0, 0]

    # ------------------------------------------------------- checkpoints
    def export_state(self):
        """The engine's mutable device state, the population's experience
        buffers and the env states with their episode accounting, as one
        tree whose every leaf carries the leading population axis."""
        return {"bufs": self.bufs, "vstate": self.vstate}

    def import_state(self, state):
        """Write what :meth:`export_state` produced (numpy leaves from a
        checkpoint, or tensors) into the engine's own tensors; a leaf that
        shares its storage with another (fresh env states share their
        zeros) gets its own first."""
        n = leaves(state["bufs"])[0].shape[0]
        if n != self.n:
            raise ValueError(f"rollout state holds {n} members but the "
                             f"engine was built for {self.n}; resize it "
                             f"first (repro_torch.elastic.restore_elastic "
                             f"does)")
        self.bufs, self.vstate = distinct((self.bufs, self.vstate))
        copy_into(self.export_state(), state)

    @property
    def env_steps_per_iteration(self) -> int:
        return self.collect_steps * self.num_envs * self.n
