"""``EvolutionStrategy``: one signature for every outer loop
(``repro.pop.strategy``)::

    evolve(generator, pop_state, hypers, fitness) -> (pop_state, hypers,
                                                      lineage)

``lineage`` is an (N,) integer tensor: ``lineage[i]`` is the member whose
state member i now holds (``i`` for a survivor, ``-1`` for a member drawn
afresh from a search distribution: never an index). ``NoEvolution``
makes population size 1 the degenerate case.

Strategies are objects of the training loop, built once per run and
called every ``pbt_interval`` trainer steps. ``evolve`` wraps the pure
step that ``evolve_fn()`` returns::

    fn(generator, pop_state, hypers, fitness, strat_state)
        -> (pop_state, hypers, lineage, strat_state)

which threads the strategy's internal state (CEM's gaussian) through as
tensors, so a fused train-evolve epoch can run it inside one captured CUDA
graph: it stays on the device, reads nothing back and copies nothing from
the host.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.core.cem import (CEMState, cem_centre, cem_init,
                                  cem_sample, cem_sample_into, cem_update,
                                  cem_update_chunked, cem_weights,
                                  ravel_stacked)
from repro_torch.core.dvd import dvd_coef_schedule
from repro_torch.core.hyperparams import sample_hypers
from repro_torch.core.pbt import pbt_step
from repro_torch.tree import leaves, tree_map


class EvolutionStrategy:
    """Base class; subclasses override :meth:`evolve`."""

    null = False  # True: the trainer skips the evolve step entirely

    def init_hypers(self, generator, n: int):
        """Per-member dynamic hyperparameters, or None."""
        return None

    def configure_agent(self, agent):
        """Hook run before the update is built (DvD installs its
        diversity-coefficient schedule on a shared-critic agent)."""

    def bind(self, generator, agent, pop_state):
        """Hook run once at trainer init; may transform the population."""
        return pop_state

    def export_state(self):
        """Internal strategy state that checkpoints carry (None here)."""
        return None

    def import_state(self, state):
        """Restore what ``export_state`` produced (nothing here)."""

    def evolve_fn(self):
        """The pure evolve step (module docstring)."""
        raise NotImplementedError

    def evolve(self, generator, pop_state, hypers, fitness):
        pop_state, hypers, lineage, strat_state = self.evolve_fn()(
            generator, pop_state, hypers, fitness, self.export_state())
        if strat_state is not None:
            self.import_state(strat_state)
        return pop_state, hypers, lineage


def _identity_evolve(generator, pop_state, hypers, fitness, strat_state):
    return pop_state, hypers, torch.arange(fitness.shape[0],
                                           device=fitness.device), strat_state


class NoEvolution(EvolutionStrategy):
    """Population size 1, or any run without an outer loop."""

    null = True

    def __init__(self, pcfg: PopulationConfig | None = None):
        self.pcfg = pcfg

    def evolve_fn(self):
        return _identity_evolve


class PBT(EvolutionStrategy):
    """Truncation-selection PBT over training state + hyperparameters.
    ``gather`` is the exploit's member copy: the agent's
    ``gather_members`` from ``bind``, which a trainer over several islands
    wraps in the cross-rank exchange
    (:class:`repro_torch.core.distributed.MemberExchange`)."""

    def __init__(self, pcfg: PopulationConfig):
        self.pcfg = pcfg
        self.gather = None

    def init_hypers(self, generator, n: int):
        space = self.pcfg.hyper_space
        if not space.names:
            return None
        return sample_hypers(generator, space, n)

    def bind(self, generator, agent, pop_state):
        self.gather = agent.gather_members
        return pop_state

    def evolve_fn(self):
        pcfg, gather = self.pcfg, self.gather

        def fn(generator, pop_state, hypers, fitness, strat_state):
            state, new_hypers, parents = pbt_step(
                generator, pop_state, {} if hypers is None else hypers,
                fitness, pcfg, gather=gather)
            return (state, None if hypers is None else new_hypers, parents,
                    strat_state)

        return fn


class CEM(EvolutionStrategy):
    """Diagonal-gaussian CEM over the agent's evolvable (policy) params.

    ``bind`` centres the distribution on member 0 and redraws every
    member from it; ``evolve`` refits on the elites and redraws every
    member (lineage all -1: no member inherits a parent's state). The
    elites' weights are made on the device once, at ``bind``.

    An agent whose evolvable parameters are views of one flat ``(N, P)``
    buffer says so with ``evolvable_buffer(pop_state)`` (``LMAgent``):
    the buffer is then the samples, the refit and the redraw go a column
    chunk at a time (:func:`repro_torch.core.cem.cem_update_chunked`,
    :func:`~repro_torch.core.cem.cem_sample_into`) and the redraw is
    written into the buffer, so the leaves stay its views. Only the
    parameters are redrawn: the optimizer state and steps stay."""

    def __init__(self, pcfg: PopulationConfig):
        self.pcfg = pcfg
        self._agent = None
        self.cem_state = None
        self._unravel = None
        self._weights = None
        self._flat = False

    def bind(self, generator, agent, pop_state):
        self._agent = agent
        self._flat = hasattr(agent, "evolvable_buffer")
        if self._flat:
            buffer = agent.evolvable_buffer(pop_state)
            self.cem_state = cem_centre(buffer[0].clone(),
                                        sigma_init=self.pcfg.sigma_init,
                                        noise_init=self.pcfg.cem_noise_init)
        else:
            params = agent.evolvable_params(pop_state)
            buffer = leaves(params)[0]
            self.cem_state, self._unravel = cem_init(
                tree_map(lambda x: x[0], params),
                sigma_init=self.pcfg.sigma_init,
                noise_init=self.pcfg.cem_noise_init)
        self._weights = cem_weights(buffer.shape[0], self.pcfg.elite_frac,
                                    buffer.device)
        return self._redraw(generator, pop_state, self.cem_state,
                            buffer.shape[0])

    def _redraw(self, generator, pop_state, cem_state, n: int):
        if self._flat:
            cem_sample_into(self._agent.evolvable_buffer(pop_state),
                            generator, cem_state)
            return pop_state
        new_params = self._unravel(cem_sample(generator, cem_state, n))
        return self._agent.with_evolvable_params(pop_state, new_params)

    def export_state(self):
        return self.cem_state

    def import_state(self, state):
        self.cem_state = CEMState(*state)

    def evolve_fn(self):
        def fn(generator, pop_state, hypers, fitness, strat_state):
            n = fitness.shape[0]
            if self._flat:
                flat, update = (self._agent.evolvable_buffer(pop_state),
                                cem_update_chunked)
            else:
                flat, update = (ravel_stacked(
                    self._agent.evolvable_params(pop_state)), cem_update)
            cem_state = update(
                CEMState(*strat_state), flat, fitness.to(flat.device),
                elite_frac=self.pcfg.elite_frac,
                noise_decay=self.pcfg.cem_noise_decay,
                weights=self._weights)
            return (self._redraw(generator, pop_state, cem_state, n), hypers,
                    torch.full((n,), -1, dtype=torch.int32,
                               device=fitness.device), cem_state)

        return fn


class DvD(EvolutionStrategy):
    """Diversity via Determinants: the selection pressure is the -logdet
    term inside the actor loss, so ``evolve`` is the identity;
    ``configure_agent`` installs the §B.2 coefficient schedule on an agent
    that takes one (the shared-critic family) and has none yet."""

    def __init__(self, pcfg: PopulationConfig):
        self.pcfg = pcfg

    def configure_agent(self, agent):
        if hasattr(agent, "dvd_coef_fn") and agent.dvd_coef_fn is None:
            period = self.pcfg.dvd_period
            agent.dvd_coef_fn = lambda step: dvd_coef_schedule(
                step, period=period)

    def evolve_fn(self):
        return _identity_evolve


STRATEGIES: dict[str, type] = {
    "none": NoEvolution,
    "pbt": PBT,
    "cem": CEM,
    "dvd": DvD,
}


def make_strategy(pcfg: PopulationConfig) -> EvolutionStrategy:
    """Resolve ``pcfg.strategy``; size 1 is always the null strategy."""
    if pcfg.size <= 1:
        return NoEvolution(pcfg)
    name = pcfg.strategy
    try:
        return STRATEGIES[name](pcfg)
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"registered: {sorted(STRATEGIES)}") from None
