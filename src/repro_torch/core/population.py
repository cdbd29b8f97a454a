"""Population state = stacked trees: the single-agent state with a leading
member axis on every leaf (``repro.core.population``)."""
from __future__ import annotations

from repro_torch.tree import leaves, stack, tree_map


def population_init(init_fn, generator, n: int):
    """``n`` members from ``init_fn(generator) -> state``, drawn in turn from
    one generator, stacked member-first."""
    return stack([init_fn(generator) for _ in range(n)])


def stack_members(members):
    """List of per-member trees -> stacked population tree."""
    return stack(members)


def member(pop, i):
    return tree_map(lambda x: x[i], pop)


def population_size(pop) -> int:
    return leaves(pop)[0].shape[0]
