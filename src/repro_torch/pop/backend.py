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

For a ``population_level`` agent (the shared critic, §4.2) the same
names pick the paper's averaged-loss update through the kernels
(``vectorized``) or the original CEM-RL ordering (``sequential``), both
from ``agent.population_update``.

``num_steps`` chains the update per call. ``sharded`` and ``islands``
raise "not ported yet".
"""
from __future__ import annotations

from repro_torch.core.vectorize import chain_steps, sequential_update

BACKENDS = ("vectorized", "sequential")
_NOT_PORTED = ("sharded", "islands")


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
    if getattr(agent, "population_level", False):
        fn = agent.population_update(sequential=backend == "sequential")
    elif backend == "sequential":
        return sequential_update(agent.update, num_steps)
    else:
        fn = agent.fused_update()
    return fn if num_steps == 1 else chain_steps(fn, num_steps)
