"""How the population update executes, as a config value
(``repro.pop.backend``):

  * ``vectorized`` — the agent's population-level update
    (``fused_update``): every member at once, through the ``pop_matmul``
    and ``pop_adam`` kernels on the card (TD3, SAC, DQN), or one
    ``pop_adam`` launch for the whole population (the LM). There is no
    ``jit(vmap(update))``
    in PyTorch, so the vectorized update is always the population-level
    one.
  * ``sequential`` — the paper's Sequential baseline: the agent's
    per-member ``update`` (plain layers, the stock Adam, no kernel; DQN's
    Atari torso by ``F.conv2d``) looped over the members (:func:`repro_torch.core.vectorize.sequential_update`).
  * ``sharded``    — the vectorized update over the rows this rank holds
    of a population split over the mesh's population axes
    (:func:`repro_torch.core.distributed.population_sharding`; every rank
    holds all members when the population does not divide). Per-member
    agents only.
  * ``islands``    — the vectorized update over one island's member group
    of an :class:`repro_torch.elastic.IslandLayout` (the paper's §5.1
    islands-per-accelerator topology), registered by
    :mod:`repro_torch.elastic.islands` and resolved on first use.

For a ``population_level`` agent (the shared critic, §4.2) the same
names pick the paper's averaged-loss update through the kernels
(``vectorized``) or the original CEM-RL ordering (``sequential``), both
from ``agent.population_update``.

``num_steps`` chains the update per call. Builders are ``builder(agent,
num_steps)``; one that also takes a ``mesh`` keyword (the islands
backend) gets the trainer's mesh through ``make_update(..., mesh=...)``.
The sharded and islands updates compute what the vectorized update
computes for the same members: their generator's member-axis draws are
made at the whole population's shape
(:func:`repro_torch.core.distributed.member_draw`).
"""
from __future__ import annotations

import inspect

from repro_torch.core.vectorize import chain_steps, sequential_update


def _chained(fn, num_steps: int):
    return fn if num_steps == 1 else chain_steps(fn, num_steps)


def _build_vectorized(agent, num_steps: int):
    if getattr(agent, "population_level", False):
        return _chained(agent.population_update(), num_steps)
    return _chained(agent.fused_update(), num_steps)


def _build_sequential(agent, num_steps: int):
    if getattr(agent, "population_level", False):
        return _chained(agent.population_update(sequential=True), num_steps)
    return sequential_update(agent.update, num_steps)


def _build_sharded(agent, num_steps: int):
    if getattr(agent, "population_level", False):
        raise ValueError("sharded backend requires per-member agents "
                         "(the shared critic is replicated, not sharded)")
    return _build_vectorized(agent, num_steps)


BACKENDS = {
    "vectorized": _build_vectorized,
    "sequential": _build_sequential,
    "sharded": _build_sharded,
}


def register_backend(name: str, builder):
    BACKENDS[name] = builder


def make_update(agent, backend: str = "vectorized", *, num_steps: int = 1,
                mesh=None):
    """Build ``fn(pop_state, batches, hypers, generator, *, noise=None) ->
    (pop_state, metrics)``; batches leaves are (N, B, ...) when
    ``num_steps == 1``, else (num_steps, N, B, ...), N the members this
    rank holds. ``mesh`` goes to builders that take it (islands)."""
    builder = BACKENDS.get(backend)
    if builder is None and backend == "islands":
        import repro_torch.elastic  # noqa: F401  registers "islands"
        builder = BACKENDS.get(backend)
    if builder is None:
        raise ValueError(f"unknown backend {backend!r}; registered: "
                         f"{sorted(set(BACKENDS) | {'islands'})}")
    if "mesh" in inspect.signature(builder).parameters:
        return builder(agent, num_steps, mesh=mesh)
    return builder(agent, num_steps)
