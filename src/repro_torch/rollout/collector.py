"""``Collector`` — the population's acting step (``repro.rollout.
collector``): each member drives its own ``num_envs`` environments with
its own exploration, whose knob comes from that member's hypers.

Per acting step the member-batched policy forward is ONE population-level
call (the module's ``pop_policy``, or ``pop_explore``: one ``pop_matmul``
per layer), so the kernel runs on the card. Trajectories come back
flattened to ``(N, num_steps * num_envs, ...)`` time-major per env, ready
for the FIFO insert, or time-major ``(N, num_steps, num_envs, ...)`` with
``flat=False`` (the on-policy shape: GAE needs the time axis); a discrete
env's actions are integers ``(N, E)``. :meth:`Collector.collect_into`
acts in chunks of ``chunk_steps`` and folds each chunk into the
experience store, so memory holds one chunk per member at a time (the
GPU-sim env counts), with the same results as one whole collect and one
insert.

The exploration policy contract is ``policy_fn(actors, obs, generator,
hypers) -> actions`` or ``-> (actions, extras)`` over member-stacked
actors and (N, E, obs) observations; ``extras`` is a dict of (N, E)
tensors (PPO's ``log_prob`` and ``value``) that the collector records
beside the transition, because an on-policy update must see the exact
statistics of the distribution that sampled each action.
"""
from __future__ import annotations

import torch

from repro_torch.rollout.vecenv import VecEnv
from repro_torch.tree import leaves, tree_map


def exploration_policy(module):
    """Exploration policy of a functional RL module, driven by per-member
    hypers. A module exposing ``pop_explore(actors, obs, generator,
    hypers)`` (the extras-emitting on-policy contract: ppo) is used
    verbatim; otherwise td3-style modules add gaussian
    ``exploration_noise`` whose scale is the member's ``explore_noise``
    hyper, else its ``noise`` hyper, else the module's default ``noise``;
    dqn-style modules act epsilon-greedily with the member's ``epsilon``
    (an (N,) vector), else the module's default; anything else (sac's
    stochastic policy) just draws from the generator.

    ``explore_noise`` is deliberately its own hyper: td3's ``noise`` is
    the target-policy smoothing inside the critic update, and reusing it
    for acting would let PBT disable smoothing while tuning exploration."""
    explore = getattr(module, "pop_explore", None)
    if explore is not None:
        return explore
    defaults = getattr(module, "DEFAULT_HYPERS", {})
    if "noise" in defaults:
        def fn(actors, obs, generator, hypers=None):
            h = hypers if hypers else {}
            scale = h.get("explore_noise", h.get("noise", defaults["noise"]))
            return module.pop_policy(actors, obs, generator,
                                     exploration_noise=scale)
        return fn
    if "epsilon" in defaults:
        def fn(actors, obs, generator, hypers=None):
            h = hypers if hypers else {}
            return module.pop_policy(actors, obs, generator,
                                     epsilon=h.get("epsilon",
                                                   defaults["epsilon"]))
        return fn
    return lambda actors, obs, generator, hypers=None: module.pop_policy(
        actors, obs, generator)


def default_exploration(agent):
    """The exploration policy of a ``repro_torch.pop`` agent's module."""
    return exploration_policy(agent.exploration_module)


def split_actions(policy_out):
    """Normalise a policy result to ``(actions, extras_dict)``."""
    if isinstance(policy_out, tuple):
        return policy_out
    return policy_out, {}


class Collector:
    """Drives a population of actors through their batched envs."""

    def __init__(self, venv: VecEnv, policy_fn):
        self.venv = venv
        self.policy_fn = policy_fn

    def init(self, generator, n: int, device="cpu"):
        """Population VecEnvState (leaves (N, E, ...))."""
        return self.venv.reset(generator, n, device)

    @torch.no_grad()
    def collect(self, actors, vstate, generator, num_steps: int,
                hypers=None, *, flat: bool = True, chunk_steps=None):
        """Act ``num_steps`` batched steps. Returns ``(vstate, traj)`` with
        traj leaves ``(N, num_steps * num_envs, ...)`` in insertion order
        (time-major per env, so FIFO eviction drops the oldest first), or
        time-major ``(N, num_steps, num_envs, ...)`` with ``flat=False``.
        Any extras the policy emits are recorded beside the transition.
        ``chunk_steps`` acts in chunks, each written into the one
        trajectory as it is made, so the steps in flight are one chunk's
        (identical results); to bound the trajectory's memory too, use
        :meth:`collect_into`."""
        n_chunks, chunk = self._chunks(num_steps, chunk_steps)
        if n_chunks == 1:
            vstate, traj = self._act(actors, vstate, generator, num_steps,
                                     hypers)
        else:
            traj = None
            for c in range(n_chunks):
                vstate, part = self._act(actors, vstate, generator, chunk,
                                         hypers)
                if traj is None:
                    traj = tree_map(lambda x: x.new_empty(
                        (x.shape[0], num_steps) + x.shape[2:]), part)
                for whole, x in zip(leaves(traj), leaves(part)):
                    whole[:, c * chunk:(c + 1) * chunk].copy_(x)
        if flat:
            traj = tree_map(lambda x: x.flatten(1, 2), traj)
        return vstate, traj

    def _act(self, actors, vstate, generator, num_steps: int, hypers):
        """``num_steps`` steps, time-major ``(N, num_steps, E, ...)``."""
        steps = []
        for _ in range(num_steps):
            actions, extras = split_actions(
                self.policy_fn(actors, vstate.obs, generator, hypers))
            vstate, trans = self.venv.step(vstate, actions, generator)
            steps.append({**trans, **extras})
        return vstate, tree_map(lambda *xs: torch.stack(xs, 1), *steps)

    @staticmethod
    def _chunks(num_steps: int, chunk_steps):
        if chunk_steps is None:
            return 1, num_steps
        if num_steps % chunk_steps:
            raise ValueError(
                f"chunk_steps={chunk_steps} must divide num_steps={num_steps}")
        return num_steps // chunk_steps, chunk_steps

    def collect_into(self, actors, vstate, bufs, add_fn, generator,
                     num_steps: int, chunk_steps, hypers=None, *,
                     flat: bool = True):
        """Chunked collect-and-store: act ``num_steps`` steps as
        ``num_steps // chunk_steps`` chunks, folding each chunk into the
        population's store with ``add_fn(bufs, chunk_traj)``. Equal bit for
        bit to :meth:`collect` and one add: the generator's draws come in
        the same order, and the FIFO and trajectory stores insert chunks at
        the positions one whole insert would use. Returns ``(vstate,
        bufs)``."""
        n_chunks, chunk = self._chunks(num_steps, chunk_steps)
        for _ in range(n_chunks):
            vstate, traj = self.collect(actors, vstate, generator, chunk,
                                        hypers, flat=flat)
            bufs = add_fn(bufs, traj)
        return vstate, bufs
