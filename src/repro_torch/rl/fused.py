"""Shared pieces of the population-level updates (``repro.rl.fused``).

A population-level update takes the member-stacked state (leaves
``(N, ...)``), batches ``(N, B, ...)`` and hypers as ``(N,)`` vectors.
This module broadcasts default hypers to per-member vectors and selects
member-wise between two trees (TD3's delayed actor, DQN's target sync). The JAX package's
``pop_split`` has no counterpart: the port's updates draw from a
``torch.Generator``.
"""
from __future__ import annotations

import torch

from repro_torch.device import device_tensor
from repro_torch.tree import tree_map


def pop_hypers(defaults: dict, hypers, n: int, device) -> dict:
    """Merge ``defaults`` with the per-member ``hypers`` dict, broadcasting
    every entry to an ``(N,)`` float32 vector on ``device``."""
    merged = dict(defaults)
    if hypers:
        merged.update(hypers)
    return {k: device_tensor(v, torch.float32, device).expand(n)
            for k, v in merged.items()}


def pop_select(mask, new, old):
    """Per-member tree select: leaves ``(N, ...)``, ``mask`` ``(N,)`` bool;
    member i keeps ``new`` iff ``mask[i]``."""
    return tree_map(
        lambda a, b: torch.where(mask.reshape(mask.shape + (1,) *
                                              (a.ndim - 1)), a, b),
        new, old)
