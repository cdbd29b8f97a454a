"""The paper's update protocols (``repro.core.vectorize``, §4.1):

  * ``chain_steps``       — the "num_steps" protocol: K update steps per
    call over a ``(K, N, B, ...)`` batch stack;
  * ``sequential_update`` — *Sequential*, the baseline of the paper's
    Fig. 2: one member's update applied member by member in a Python loop.

The JAX package scans the K steps inside one compiled call; PyTorch runs
eagerly, so this is a Python loop whose steps stay on the device. The
JAX package's ``vectorized_update`` (``jit(vmap(update))``) has no
counterpart: the port's vectorized update is the agent's population-level
update itself (``repro_torch.pop.backend``).
"""
from __future__ import annotations

import torch

from repro_torch.core.population import member, population_size
from repro_torch.tree import stack, tree_map


def chain_steps(update_fn, num_steps: int):
    """``update_fn(state, batch, hypers, generator, *, noise=None)`` over
    ``num_steps`` batches (leaves ``(num_steps, ...)``).

    Float metrics are MEANED over the chained window (a k-sample fitness
    estimate for PBT, not the last step's 1-sample one); integer metrics
    keep the final value. ``noise`` (leading axis ``num_steps``) injects
    each step's draw."""
    def chained(state, batches, hypers=None, generator=None, *, noise=None):
        rows = []
        for k in range(num_steps):
            batch = tree_map(lambda x: x[k], batches)
            state, metrics = update_fn(
                state, batch, hypers, generator,
                noise=None if noise is None else noise[k])
            rows.append(metrics)
        return state, tree_map(
            lambda *xs: torch.stack(xs).mean(0) if xs[0].is_floating_point()
            else xs[-1], *rows)
    return chained


def sequential_update(update_fn, num_steps: int = 1):
    """The Sequential baseline: ``update_fn(state, batch, hypers, generator,
    *, noise=None)``, one member's step, applied to each member in turn
    (``num_steps`` chained steps each). Returns ``fn(pop_state, batches,
    hypers, generator, *, noise=None) -> (pop_state, metrics)`` with the
    vectorized update's layout: batches and noise ``(N, ...)``, or
    ``(num_steps, N, ...)``; hypers ``(N,)`` vectors or None.

    Each member's new state is written into its slot of the population's
    own tensors, which are returned: the population is never copied (an
    LM population at full width has no room for a second one), and views
    of its tensors stay valid."""
    inner = update_fn if num_steps == 1 else chain_steps(update_fn,
                                                          num_steps)
    at = (lambda x, i: x[i]) if num_steps == 1 else (lambda x, i: x[:, i])

    def stepped(pop_state, batches, hypers=None, generator=None, *,
                noise=None):
        rows = []
        for i in range(population_size(pop_state)):
            new, metrics = inner(
                member(pop_state, i), tree_map(lambda x: at(x, i), batches),
                None if hypers is None else tree_map(lambda x: x[i], hypers),
                generator, noise=None if noise is None else at(noise, i))
            # metrics first: one may be a view of the state just written
            rows.append(tree_map(torch.clone, metrics))
            tree_map(lambda d, x: d[i].copy_(x), pop_state, new)
            del new
        return pop_state, stack(rows)

    return stepped
