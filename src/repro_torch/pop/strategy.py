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

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.core.cem import (CHUNK, CEMState, cem_centre, cem_sample,
                                  cem_sample_into, cem_update_chunked,
                                  cem_weights, ravel, ravel_stacked)
from repro_torch.core.distributed import (Rows, gather_columns_to_root,
                                          owner_rows)
from repro_torch.core.dvd import dvd_coef_schedule
from repro_torch.core.hyperparams import sample_hypers
from repro_torch.core.pbt import pbt_step
from repro_torch.tree import leaves, tree_map


class Spread(NamedTuple):
    """A population spread over ranks, as a strategy sees it: the
    ``layout`` (an :class:`~repro_torch.elastic.IslandLayout`), this
    rank's member ``rows``, the ``pop`` group of its column (one rank an
    island), a ``host_group`` over the whole world for root gathers (None:
    the default group), and ``parts``, this rank's
    :class:`~repro_torch.models.sharding.PartMap` of a model-sharded
    member (None: whole members)."""
    layout: Any
    rows: Rows
    group: Any = None
    host_group: Any = None
    parts: Any = None


class EvolutionStrategy:
    """Base class; subclasses override :meth:`evolve`."""

    null = False  # True: the trainer skips the evolve step entirely

    def init_hypers(self, generator, n: int):
        """Per-member dynamic hyperparameters, or None."""
        return None

    def configure_agent(self, agent):
        """Hook run before the update is built (DvD installs its
        diversity-coefficient schedule on a shared-critic agent)."""

    def bind(self, generator, agent, pop_state, *, over=None):
        """Hook run once at trainer init; may transform the population.
        ``over`` (a :class:`Spread`) places it over several ranks."""
        return pop_state

    def export_state(self):
        """Internal strategy state the evolve step threads (None here)."""
        return None

    def checkpoint_state(self):
        """The state a checkpoint carries: ``export_state``'s, whole."""
        return self.export_state()

    def import_state(self, state):
        """Restore what ``export_state`` or ``checkpoint_state`` produced
        (nothing here)."""

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

    def bind(self, generator, agent, pop_state, *, over=None):
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

    The refit goes a column chunk at a time
    (:func:`repro_torch.core.cem.cem_update_chunked`). An agent whose
    evolvable parameters are views of one flat ``(N, P)`` buffer says so
    with ``evolvable_buffer(pop_state)`` (``LMAgent``): the buffer is then
    the samples, and the redraw goes a column chunk at a time too
    (:func:`~repro_torch.core.cem.cem_sample_into`), written into the
    buffer, so the leaves stay its views. Only the parameters are
    redrawn: the optimizer state and steps stay.

    Over several ranks (``bind(over=...)``, a :class:`Spread`) the rank
    holds its island's rows and, for model-sharded members, its columns
    of them (``over.parts``). ``cem_state`` is then this rank's columns
    of the distribution, the same on every island. Member 0, the centre,
    is broadcast from the ranks of island 0, as the elites are at each
    evolve (:func:`repro_torch.core.distributed.owner_rows`, a column
    chunk at a time); every draw is made at the whole population's rows
    and the whole member's columns, so every rank's numbers are the
    one-rank run's, bit for bit. ``checkpoint_state`` puts the whole distribution back together on
    rank 0; ``import_state`` takes a whole one and keeps this rank's
    columns."""

    def __init__(self, pcfg: PopulationConfig):
        self.pcfg = pcfg
        self._agent = None
        self.cem_state = None
        self._unravel = None
        self._weights = None
        self._flat = False
        self._over = None

    @property
    def _parts(self):
        return None if self._over is None else self._over.parts

    def _owner_rows(self):
        """``elites(members, block)`` over this rank's spread (None on one
        rank)."""
        over = self._over
        if over is None or over.layout.islands == 1:
            return None
        return lambda members, block: owner_rows(
            block, members, over.layout, over.group)

    def _samples(self, pop_state):
        """The rank's ``(rows, columns)`` of the evolvable parameters."""
        if self._flat:
            return self._agent.evolvable_buffer(pop_state)
        return ravel_stacked(self._agent.evolvable_params(pop_state))

    def bind(self, generator, agent, pop_state, *, over=None):
        self._agent, self._over = agent, over
        self._flat = hasattr(agent, "evolvable_buffer")
        if not self._flat:
            params = agent.evolvable_params(pop_state)
            _, self._unravel = ravel(tree_map(lambda x: x[0], params))
        samples = self._samples(pop_state)
        gather = self._owner_rows()
        if gather is None:
            centre = samples[0].clone()
        else:                 # island 0's member 0, a column chunk at a time
            centre = samples.new_empty(samples.shape[1:])
            for c in range(0, centre.shape[0], CHUNK):
                centre[c:c + CHUNK] = gather([0], samples[:, c:c + CHUNK])[0]
        self.cem_state = cem_centre(centre, sigma_init=self.pcfg.sigma_init,
                                    noise_init=self.pcfg.cem_noise_init)
        n = samples.shape[0] if over is None else over.rows.n
        self._weights = cem_weights(n, self.pcfg.elite_frac, samples.device)
        return self._redraw(generator, pop_state, self.cem_state)

    def _redraw(self, generator, pop_state, cem_state):
        if self._flat:
            parts = {} if self._parts is None else {"parts": self._parts}
            cem_sample_into(self._agent.evolvable_buffer(pop_state),
                            generator, cem_state, **parts)
            return pop_state
        n = leaves(self._agent.evolvable_params(pop_state))[0].shape[0]
        new_params = self._unravel(cem_sample(generator, cem_state, n))
        return self._agent.with_evolvable_params(pop_state, new_params)

    def export_state(self):
        """The distribution the evolve threads: this rank's columns."""
        return self.cem_state

    def checkpoint_state(self):
        """The whole one-rank distribution for a checkpoint. With model
        parts it is put together on rank 0 (a collective every rank
        calls; None on the others)."""
        parts = self._parts
        if parts is None or self.cem_state is None:
            return self.cem_state
        over = self._over
        mean, var = (gather_columns_to_root(x, over.layout, parts.whole_of,
                                            over.host_group)
                     for x in self.cem_state[:2])
        return None if mean is None else CEMState(mean, var,
                                                  self.cem_state.noise)

    def import_state(self, state):
        """Take ``state``: the evolve's, or a checkpoint's whole one, of
        which this rank keeps its columns (on the device of its own)."""
        state = CEMState(*(torch.as_tensor(x) for x in state))
        if self.cem_state is None:
            self.cem_state = state
            return
        parts = self._parts
        if parts is not None and state.mean.shape[0] != parts.local:
            state = state._replace(mean=parts.local_of(state.mean),
                                   var=parts.local_of(state.var))
        device = self.cem_state.mean.device
        self.cem_state = CEMState(*(x.to(device) for x in state))

    def evolve_fn(self):
        def fn(generator, pop_state, hypers, fitness, strat_state):
            n = fitness.shape[0]
            samples = self._samples(pop_state)
            elites = self._owner_rows()
            state = CEMState(*strat_state)
            kw = dict(elite_frac=self.pcfg.elite_frac,
                      noise_decay=self.pcfg.cem_noise_decay,
                      weights=self._weights)
            if not self._flat:       # the refit writes in place
                state = CEMState(state.mean.clone(), state.var.clone(),
                                 state.noise)
            cem_state = cem_update_chunked(
                state, samples, fitness.to(samples.device), elites=elites,
                **kw)
            return (self._redraw(generator, pop_state, cem_state), hypers,
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
