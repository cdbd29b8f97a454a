"""Elastic population resize (``repro.elastic.resize``): drop the worst,
refill with PBT clones.

A population's size can change between runs with the same mechanics its
exploit/explore loop already uses:

  * shrink: keep the ``new_size`` fittest members (the rest would have
    been exploited away at the next PBT step anyway);
  * grow: survivors keep their own state bit for bit, and the new slots
    are cloned from the fittest survivors round-robin, what a PBT exploit
    would produce (the next explore step perturbs the copies apart).

Everything works on member-stacked trees (:mod:`repro_torch.tree`): a
leaf whose leading axis equals the old population size is gathered
(training state, hypers, replay buffers, env states alike); a leaf
without that axis (a shared critic, CEM's distribution, a 0-d counter)
passes through untouched. Leaves may be numpy arrays or tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import flatten, tree_map


def plan_resize(old_size: int, new_size: int, fitness=None):
    """Member index map for a resize: ``(parents, lineage)``.

    ``parents[i]`` is the OLD member whose state new member ``i``
    receives; ``lineage[i]`` mirrors the evolution strategies' convention
    (the old index for members that keep or inherit a state). Shrinks
    keep the ``new_size`` fittest (in their original order); grows keep
    every member in place and fill slots ``old_size..new_size`` with the
    fittest survivors round-robin. Without fitness, shrinks keep the first
    ``new_size`` members and grows clone from member 0 up."""
    if new_size < 1:
        raise ValueError(
            f"cannot resize a population to {new_size} members; training "
            f"needs at least 1 (got new_size={new_size})")
    rank = (np.argsort(np.asarray(fitness))[::-1] if fitness is not None
            else np.arange(old_size))
    if new_size <= old_size:
        parents = np.sort(rank[:new_size])
    else:
        refill = rank[np.arange(new_size - old_size) % old_size]
        parents = np.concatenate([np.arange(old_size), refill])
    return parents.astype(np.int64), parents.astype(np.int64)


def _has_axis(x, old_size: int) -> bool:
    return hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == old_size


def resize_tree(tree, old_size: int, parents):
    """Apply a :func:`plan_resize` index map to a member-stacked tree:
    leaves with leading axis ``old_size`` are gathered by ``parents``
    (a tensor on its own device); all other leaves are returned
    unchanged."""
    parents = np.asarray(parents)

    def take(x):
        if not _has_axis(x, old_size):
            return x
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(parents, device=x.device)]
        return x[parents]
    return tree_map(take, tree)


def shrink_population(pop_tree, fitness, new_size: int):
    """Keep the ``new_size`` fittest members. Returns ``(tree, keep)``
    with ``keep`` the sorted surviving indices. ``new_size`` outside
    ``[1, N]`` raises: an empty population is never a training state."""
    fitness = np.asarray(fitness)
    if not 1 <= new_size <= fitness.shape[0]:
        raise ValueError(
            f"shrink_population: new_size must be in [1, {fitness.shape[0]}]"
            f", got {new_size}")
    keep, _ = plan_resize(fitness.shape[0], new_size, fitness)
    return resize_tree(pop_tree, fitness.shape[0], keep), keep


def grow_population(pop_tree, fitness, new_size: int):
    """Grow to ``new_size`` members: survivors stay in place (bit for
    bit), new slots are PBT clones of the fittest. Returns ``(tree,
    parents)``. The old size comes from ``fitness`` (length N), never
    from the first leaf, which may be a shared critic."""
    fitness = np.asarray(fitness)
    if fitness.ndim != 1:
        raise ValueError("grow_population needs the (N,) fitness of the "
                         "current members (it defines the old size and "
                         f"the clone ranking); got shape {fitness.shape}")
    old = fitness.shape[0]
    if new_size < old:
        raise ValueError(f"grow_population: new_size={new_size} < {old}; "
                         "use shrink_population")
    parents, _ = plan_resize(old, new_size, fitness)
    return resize_tree(pop_tree, old, parents), parents


def resize_into(dst, src, old_size: int, parents):
    """:func:`resize_tree` written into ``dst``'s tensors in place, leaf
    by leaf and member row by member row: ``src`` (numpy leaves from a
    checkpoint, or tensors) at ``old_size`` members, ``dst`` the
    trainer's own tensors at ``len(parents)``. Nothing is rebound (an
    ``LMAgent``'s leaves stay views of its flat buffers, a captured
    graph's inputs stay its inputs) and no gathered copy of a leaf is
    made on the host. Returns ``dst``; raises ``ValueError`` on a
    structure or shape mismatch."""
    mine, _ = flatten(dst)
    theirs, _ = flatten(src)
    if len(mine) != len(theirs):
        raise ValueError(f"resize_into: {len(theirs)} leaves into "
                         f"{len(mine)}")
    parents = [int(p) for p in np.asarray(parents)]
    for d, s in zip(mine, theirs):
        s = torch.as_tensor(s)
        if _has_axis(s, old_size):
            want = (len(parents),) + tuple(s.shape[1:])
            if tuple(d.shape) != want:
                raise ValueError(f"resize_into: a leaf of shape "
                                 f"{tuple(s.shape)} resized to {want} into "
                                 f"one of {tuple(d.shape)}")
            for i, p in enumerate(parents):
                d[i].copy_(s[p])
        elif tuple(s.shape) != tuple(d.shape):
            raise ValueError(f"resize_into: a leaf of shape "
                             f"{tuple(s.shape)} into one of "
                             f"{tuple(d.shape)}")
        else:
            d.copy_(s)
    return dst
