"""``ContinuousEvaluator`` — promotion/demotion from live checkpoints
(``repro.serve.continuous``).

Every new checkpoint step, the watcher reads the JSON extras (fitness,
population size, step — no array IO), loads ONLY the stacked actor
params (the ``"actors"`` aux tree, against an agent-derived template),
embeds every member's behavior on a fixed probe batch, and reselects the
serving set by fitness + DvD diversity. The latest checkpoint always
wins; membership changes are recorded as promote/demote events, and,
given a telemetry object, as ``promotion`` rows.

Served over ranks (``collective=True``: every rank of the default group
polls together), rank 0 decides: the step it sees is broadcast, every
rank reads that checkpoint, and rank 0's selection (its member indices,
not each rank's own float scores) is broadcast, so every rank installs
the same :class:`ServingSet`.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.distributed import broadcast, world
from repro_torch.core.dvd import behavior_embedding
from repro_torch.serve.ensemble import (ServingSet, make_serving_set,
                                        select_members)
from repro_torch.serve.forward import PolicyForward
from repro_torch.tree import leaves, tree_map


def probe_observations(env, generator, size: int = 32, device="cpu"):
    """A fixed batch of reset observations: the shared probe states every
    member is embedded on."""
    _, obs = env.reset(generator, size, device)
    return obs


def load_actor_stack(manager, agent, *, step: int | None = None):
    """The stacked actor params (tensors on ``agent.device``) + extras of a
    checkpoint, without a trainer restore: ``peek_extra`` gives size,
    fitness and step, and the ``"actors"`` aux tree restores against a
    template built from the agent alone. The restore takes only the tree
    structure from the template, so one member's actor (built on the CPU,
    none of the training state) is enough. Raises on a checkpoint without
    that tree."""
    step = manager.latest() if step is None else step
    if step is None:
        raise FileNotFoundError(
            f"load_actor_stack: no checkpoint in {manager.dir}")
    extra = manager.peek_extra(step)
    template = agent.actor_init(torch.Generator().manual_seed(0))
    actors = manager.restore_aux("actors", template, step)
    if actors is None:
        raise ValueError(
            f"checkpoint step {step} in {manager.dir} has no 'actors' aux "
            f"tree — it was written by a producer that does not record the "
            f"serving params, so it cannot be served")
    return tree_map(lambda a: torch.from_numpy(a).to(agent.device),
                    actors), extra


class ContinuousEvaluator:
    """Watches a checkpoint directory and keeps a :class:`ServingSet`
    promoted from the freshest population.

    ``size`` is the ensemble size; ``probe_obs`` the shared probe batch for
    behavioral embeddings (None selects on fitness alone);
    ``diversity_weight`` trades nats of ensemble volume against standard
    deviations of fitness (0 = pure fitness ranking). ``collective``:
    every rank polls together, and rank 0's step and selection are
    broadcast (module docstring).
    """

    def __init__(self, manager, agent, *, size: int = 4, probe_obs=None,
                 diversity_weight: float = 1.0,
                 forward: PolicyForward | None = None, telemetry=None,
                 collective: bool = False):
        self.mgr = manager
        self.agent = agent
        self.size = size
        self.probe_obs = probe_obs
        self.diversity_weight = diversity_weight
        self.forward = forward if forward is not None \
            else PolicyForward.for_agent(agent)
        self.serving: ServingSet | None = None
        self.events: list[dict] = []
        self.telemetry = telemetry
        self.collective = collective
        self._last_step: int | None = None

    def _from_root(self, values):
        """Rank 0's int64 ``values`` on every rank (a broadcast over the
        default group)."""
        t = torch.as_tensor(values, dtype=torch.int64).to(self.agent.device)
        return broadcast(t, 0).cpu().numpy()

    def select(self, actors, fitness) -> np.ndarray:
        """The promotion criterion on a loaded actor stack."""
        n = leaves(actors)[0].shape[0]
        emb = None
        if self.probe_obs is not None:
            with torch.no_grad():
                emb = behavior_embedding(self.forward.member, actors,
                                         self.probe_obs)
            emb = emb.cpu().numpy().astype(np.float64)
        if fitness is None and emb is None:
            warnings.warn(
                "ContinuousEvaluator: checkpoint carries no fitness and no "
                "probe_obs was given; promoting by member index",
                stacklevel=2)
            return np.arange(min(self.size, n), dtype=np.int64)
        return select_members(fitness, emb, self.size,
                              diversity_weight=self.diversity_weight)

    def poll(self, server=None) -> ServingSet | None:
        """Promote from the latest checkpoint if it is newer than the one
        serving. Returns the new :class:`ServingSet` (installed into
        ``server`` when given), or None when nothing changed. Each poll
        that promotes appends ``{"step", "promoted", "demoted",
        "members"}`` to ``self.events``."""
        step = self.mgr.latest()
        if self.collective:
            step = int(self._from_root([-1 if step is None else step])[0])
            step = None if step < 0 else step
        if step is None or step == self._last_step:
            return None
        actors, extra = load_actor_stack(self.mgr, self.agent, step=step)
        fitness = extra["fitness"]
        if not self.collective:
            members = self.select(actors, fitness)
        else:
            n = leaves(actors)[0].shape[0]
            members = (self.select(actors, fitness) if world()[0] == 0
                       else np.zeros(max(1, min(self.size, n)), np.int64))
            members = self._from_root(members)
        new = make_serving_set(actors, members, step=step, fitness=fitness)
        old = set() if self.serving is None else set(
            self.serving.members.tolist())
        now = set(members.tolist())
        event = {
            "step": step,
            "promoted": sorted(now - old),
            "demoted": sorted(old - now),
            "members": members.tolist(),
        }
        self.events.append(event)
        if self.telemetry is not None:
            self.telemetry.record(
                "promotion", **event,
                fitness=None if fitness is None else list(fitness),
                population=extra["size"])
        self.serving = new
        self._last_step = step
        if server is not None:
            server.install(new)
        return new
