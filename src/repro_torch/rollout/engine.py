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
episode accounting. ``build_epoch`` (fused train-evolve epochs) and
``chunk_steps`` come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.data.experience import compute_gae, experience_ops
from repro_torch.data.replay_buffer import buffer_sample
from repro_torch.rollout.collector import Collector, default_exploration
from repro_torch.rollout.evaluator import Evaluator
from repro_torch.rollout.vecenv import VecEnv, episode_stats
from repro_torch.tree import leaves, tree_map

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
                 epochs: int = 4, eval_envs: int = 4):
        self.agent = agent
        self.kind = agent.experience_kind
        self.exp = experience_ops(self.kind)
        self.n = pcfg.size
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
                                 num_steps=self.num_steps)
        else:
            self.num_steps = max(1, pcfg.num_steps)
        self.update = update

        self.venv = VecEnv(env, num_envs)
        self.collector = Collector(self.venv, default_exploration(agent))
        module = agent.exploration_module
        self.evaluator = Evaluator(
            env, lambda actors, obs: module.pop_policy(actors, obs),
            num_envs=eval_envs)

        self.vstate = self.collector.init(generator, self.n, device)
        self.bufs = self.exp.init(
            env.spec, self.n, device, capacity=buffer_capacity,
            num_steps=collect_steps, num_envs=num_envs,
            extras=getattr(agent, "experience_extras",
                           ("log_prob", "value")))
        self.iterations = 0

    def filled(self, iterations: int | None = None) -> int:
        """Transitions each member has inserted after ``iterations``
        iterations (default: so far), counted on the host."""
        done = self.iterations if iterations is None else iterations
        return done * self.collect_steps * self.num_envs

    def can_sample(self, iterations: int | None = None) -> bool:
        """The replay kind's can-sample gate after ``iterations``
        iterations, decided on the host: every buffer holds a batch."""
        return self.filled(iterations) >= self.batch_size

    def iterate(self, state, hypers, generator):
        """One train iteration. Returns ``(state, metrics, episode_stats,
        did_update)``; until a replay ring can serve a batch the iteration
        only collects, and ``metrics`` is None. An on-policy iteration
        always updates."""
        actors = self.agent.actor_params(state)
        self.vstate, traj = self.collector.collect(
            actors, self.vstate, generator, self.collect_steps, hypers,
            flat=self.kind == "replay")
        self.bufs = self.exp.add(self.bufs, traj)
        self.iterations += 1
        if self.kind == "trajectory":
            batches = self.population_batches(self.bufs, actors, hypers,
                                              generator)
        elif not self.can_sample():
            return state, None, episode_stats(self.vstate), False
        else:
            batches = buffer_sample(self.bufs, generator, self.batch_size,
                                    self.num_steps, filled=self.filled())
            if self.num_steps == 1:
                batches = tree_map(lambda x: x[0], batches)
        state, metrics = self.update(state, batches, hypers, generator)
        return state, metrics, episode_stats(self.vstate), True

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
            perms = torch.rand((n, self.epochs, d), generator=generator,
                               device=generator.device).argsort(-1)
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

    @property
    def env_steps_per_iteration(self) -> int:
        return self.collect_steps * self.num_envs * self.n
