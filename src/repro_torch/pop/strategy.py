"""``EvolutionStrategy``: one signature for every outer loop
(``repro.pop.strategy``)::

    evolve(generator, pop_state, hypers, fitness) -> (pop_state, hypers,
                                                      lineage)

``lineage`` is an (N,) integer tensor: ``lineage[i]`` is the member whose
state member i now holds. ``NoEvolution`` makes population size 1 the
degenerate case. PBT is ported; CEM and DvD raise "not ported yet".
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.core.hyperparams import sample_hypers
from repro_torch.core.pbt import pbt_step


class EvolutionStrategy:
    """Base class; subclasses override :meth:`evolve`."""

    null = False  # True: the trainer skips the evolve step entirely

    def init_hypers(self, generator, n: int):
        """Per-member dynamic hyperparameters, or None."""
        return None

    def bind(self, generator, agent, pop_state):
        """Hook run once at trainer init; may transform the population."""
        return pop_state

    def export_state(self):
        """Internal strategy state that checkpoints carry (None here)."""
        return None

    def evolve(self, generator, pop_state, hypers, fitness):
        raise NotImplementedError


class NoEvolution(EvolutionStrategy):
    """Population size 1, or any run without an outer loop."""

    null = True

    def __init__(self, pcfg: PopulationConfig | None = None):
        self.pcfg = pcfg

    def evolve(self, generator, pop_state, hypers, fitness):
        return pop_state, hypers, torch.arange(fitness.shape[0],
                                               device=fitness.device)


class PBT(EvolutionStrategy):
    """Truncation-selection PBT over training state + hyperparameters."""

    def __init__(self, pcfg: PopulationConfig):
        self.pcfg = pcfg
        self._gather = None

    def init_hypers(self, generator, n: int):
        space = self.pcfg.hyper_space
        if not space.names:
            return None
        return sample_hypers(generator, space, n)

    def bind(self, generator, agent, pop_state):
        self._gather = agent.gather_members
        return pop_state

    def evolve(self, generator, pop_state, hypers, fitness):
        state, new_hypers, parents = pbt_step(
            generator, pop_state, {} if hypers is None else hypers, fitness,
            self.pcfg, gather=self._gather)
        return state, (None if hypers is None else new_hypers), parents


STRATEGIES: dict[str, type] = {
    "none": NoEvolution,
    "pbt": PBT,
}
_NOT_PORTED = ("cem", "dvd")


def make_strategy(pcfg: PopulationConfig) -> EvolutionStrategy:
    """Resolve ``pcfg.strategy``; size 1 is always the null strategy."""
    if pcfg.size <= 1:
        return NoEvolution(pcfg)
    name = pcfg.strategy
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"strategy {name!r} is not ported yet (ported: "
            f"{sorted(STRATEGIES)})")
    try:
        return STRATEGIES[name](pcfg)
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"registered: {sorted(STRATEGIES)}") from None
