"""``PolicyForward`` — the one deterministic policy forward
(``repro.serve.forward``).

Serving and evaluation must agree on what "the policy's action" is, or
the fitness that promotes a member describes a different policy than the
one traffic hits. ``member`` is one member's deterministic head (the
exploration policy with no generator, i.e. exploration off); ``members``
runs every member of a stacked tree on the same observations, by default
one member after another, or through a population-level forward
(:meth:`fused_for_agent`: one ``pop_matmul`` launch per layer for the
whole ensemble).
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


class PolicyForward:
    """A deterministic action function over the exploration-policy contract
    ``policy_fn(actor_params, obs, generator) -> actions``, always called
    here with ``generator=None``.

    ``members_fn(actors, obs) -> (M, B, ...)`` optionally replaces the
    member-by-member ensemble evaluation with a population-level forward.
    """

    def __init__(self, policy_fn, members_fn=None):
        self.policy_fn = policy_fn
        self._members_fn = members_fn

    def member(self, actor, obs):
        """One member's deterministic actions on an observation batch."""
        return self.policy_fn(actor, obs, None)

    def members(self, actors, obs):
        """Every member of a stacked tree on the SAME observation batch ->
        actions with a leading member axis ``(M, B, ...)``."""
        if self._members_fn is not None:
            return self._members_fn(actors, obs)
        n = leaves(actors)[0].shape[0]
        return torch.stack([self.member(tree_map(lambda x: x[i], actors), obs)
                            for i in range(n)])

    @classmethod
    def for_agent(cls, agent) -> "PolicyForward":
        """The forward for a ``repro_torch.pop`` agent, from its policy."""
        return cls(agent.policy)

    @classmethod
    def fused_for_agent(cls, agent) -> "PolicyForward":
        """Like :meth:`for_agent`, but the ensemble call runs every member
        through ONE population-batched forward (``repro_torch.rl.networks
        .pop_*_apply``): each linear layer is one ``pop_matmul`` for the
        whole ensemble. ``member`` is unchanged. The heads are td3's tanh
        actor, sac's tanh of the gaussian's mean, dqn's argmax of the
        Q-values, and ppo's tanh mean (continuous) or argmax of the logits
        (discrete), of the ``actor`` subtree of its policy tree.

        The requests are broadcast over members as a stride-0 view
        (``expand``), which the kernel reads in place: no copy per member.
        Agents without a population-level head keep the default forward."""
        from repro_torch.rl import networks as nets

        name = getattr(agent.module, "__name__", "").rsplit(".", 1)[-1]
        heads = {
            "td3": nets.pop_actor_apply,
            "sac": lambda actors, obs: torch.tanh(
                nets.pop_gaussian_actor_apply(actors, obs)[0]),
            "dqn": lambda actors, obs: torch.argmax(
                nets.pop_q_net_apply(actors, obs), dim=-1),
            "ppo": lambda actors, obs: (
                nets.pop_actor_apply(actors["actor"], obs)
                if "log_std" in actors else torch.argmax(
                    nets.pop_mlp_apply(actors["actor"], obs), dim=-1)),
        }
        fwd = cls.for_agent(agent)
        head = heads.get(name)
        if head is not None:
            def members_fn(actors, obs):
                m = leaves(actors)[0].shape[0]
                return head(actors,
                            obs.unsqueeze(0).expand((m,) + tuple(obs.shape)))
            fwd._members_fn = members_fn
        return fwd
