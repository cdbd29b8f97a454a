"""How the population update executes, as a config value
(``repro.pop.backend``).

Only ``vectorized`` is ported: the module's population-level update
(``make_population_update``), chained ``num_steps`` times per call. There
is no ``jit(vmap(update))`` in PyTorch, so the vectorized update is always
the population-level one, through the ``pop_matmul`` and ``pop_adam``
kernels on the card. ``sequential``, ``sharded`` and ``islands`` raise
"not ported yet".
"""
from __future__ import annotations

from repro_torch.core.vectorize import chain_steps

BACKENDS = ("vectorized",)
_NOT_PORTED = ("sequential", "sharded", "islands")


def make_update(agent, backend: str = "vectorized", *, num_steps: int = 1):
    """Build ``fn(pop_state, batches, hypers, generator, *, noise=None) ->
    (pop_state, metrics)``; batches leaves are (N, B, ...) when
    ``num_steps == 1``, else (num_steps, N, B, ...)."""
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (ported: "
            f"{list(BACKENDS)})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; registered: "
                         f"{sorted(BACKENDS + _NOT_PORTED)}")
    fn = agent.fused_update()
    return fn if num_steps == 1 else chain_steps(fn, num_steps)
