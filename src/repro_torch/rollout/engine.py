"""The population's train iteration (``repro.rollout.engine``), replay
kind: collect -> insert -> sample -> K chained updates.

The JAX package compiles the iteration into one jitted program and gates
the updates on ``buffer_can_sample`` with a ``lax.cond``. PyTorch runs
eagerly, and the gate is decided on the host instead: every member
inserts ``collect_steps * num_envs`` transitions per iteration, so after
iteration i every buffer holds ``(i + 1) * collect_steps * num_envs`` and
the iteration reads nothing back from the device.

The engine owns the mutable device state that is not part of the
population state: the replay buffers and the env states with their
episode accounting. The trajectory kind (PPO), ``build_epoch`` (fused
train-evolve epochs) and ``chunk_steps`` come with later slices.
"""
from __future__ import annotations

from repro_torch.data.experience import transition_spec
from repro_torch.data.replay_buffer import (buffer_add, buffer_init,
                                            buffer_sample)
from repro_torch.rollout.collector import Collector, default_exploration
from repro_torch.rollout.evaluator import Evaluator
from repro_torch.rollout.vecenv import VecEnv, episode_stats
from repro_torch.tree import leaves, tree_map


class RolloutEngine:
    """Owns the env states, the population's replay buffers and the
    iteration. ``update`` is the trainer's chained update
    (``repro_torch.pop.make_update``: ``pcfg.num_steps`` chained steps per
    call)."""

    def __init__(self, agent, pcfg, env, *, update, generator, init_state,
                 num_envs: int = 8, collect_steps: int = 32,
                 batch_size: int = 128, buffer_capacity: int = 100_000,
                 eval_envs: int = 4):
        if agent.experience_kind != "replay":
            raise NotImplementedError(
                f"experience kind {agent.experience_kind!r} is not ported "
                f"yet (ported: replay)")
        self.agent = agent
        self.n = pcfg.size
        self.num_envs = num_envs
        self.collect_steps = collect_steps
        self.batch_size = batch_size
        device = leaves(init_state)[0].device

        self.venv = VecEnv(env, num_envs)
        self.collector = Collector(self.venv, default_exploration(agent))
        module = agent.exploration_module
        self.evaluator = Evaluator(
            env, lambda actors, obs: module.pop_policy(actors, obs),
            num_envs=eval_envs)

        self.vstate = self.collector.init(generator, self.n, device)
        self.bufs = buffer_init(self.n, buffer_capacity,
                                transition_spec(env.spec), device)
        self.num_steps = max(1, pcfg.num_steps)
        self.update = update
        self.iterations = 0

    def filled(self, iterations: int | None = None) -> int:
        """Transitions each member has inserted after ``iterations``
        iterations (default: so far), counted on the host."""
        done = self.iterations if iterations is None else iterations
        return done * self.collect_steps * self.num_envs

    def can_sample(self, iterations: int | None = None) -> bool:
        """The can-sample gate after ``iterations`` iterations, decided on
        the host: every buffer holds a batch."""
        return self.filled(iterations) >= self.batch_size

    def iterate(self, state, hypers, generator):
        """One train iteration. Returns ``(state, metrics, episode_stats,
        did_update)``; until the buffers can serve a batch the iteration
        only collects, and ``metrics`` is None."""
        actors = self.agent.actor_params(state)
        self.vstate, traj = self.collector.collect(
            actors, self.vstate, generator, self.collect_steps, hypers)
        self.bufs = buffer_add(self.bufs, traj)
        self.iterations += 1
        if not self.can_sample():
            return state, None, episode_stats(self.vstate), False
        batches = buffer_sample(self.bufs, generator, self.batch_size,
                                self.num_steps, filled=self.filled())
        if self.num_steps == 1:
            batches = tree_map(lambda x: x[0], batches)
        state, metrics = self.update(state, batches, hypers, generator)
        return state, metrics, episode_stats(self.vstate), True

    def probe_obs(self, generator, size: int):
        """``size`` observations sampled from member 0's replay buffer
        (DvD's behaviour probes and similar diagnostics): (size, obs)."""
        buf0 = tree_map(lambda x: x[:1], self.bufs)
        return buffer_sample(buf0, generator, size,
                             filled=self.filled())["obs"][0, 0]

    @property
    def env_steps_per_iteration(self) -> int:
        return self.collect_steps * self.num_envs * self.n
