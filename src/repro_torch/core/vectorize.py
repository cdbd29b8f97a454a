"""Chained update steps (``repro.core.vectorize``), the paper's
"num_steps" protocol (§4.1): K update steps per call over a
``(K, N, B, ...)`` batch stack.

The JAX package scans the K steps inside one compiled call; PyTorch runs
eagerly, so this is a Python loop whose steps stay on the device. The
JAX package's ``vectorized_update`` (``jit(vmap(update))``) has no
counterpart: the port's vectorized update is the module's population-level
update itself (``repro_torch.pop.backend``).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


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
