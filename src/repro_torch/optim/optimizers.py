"""Functional Adam over parameter trees (``repro.optim.optimizers``).

An optimizer is a pair ``(init_fn, update_fn)``::

    state = init_fn(params)
    updates, state = update_fn(grads, state, params, lr_override=None)

``lr_override`` is given at update time, which is what lets PBT treat the
learning rate as a per-member hyperparameter. Gradient clipping, weight
decay and the schedules come with the LM slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """Adam; ``update_fn(grads, state, params, lr_override=...)``."""

    def init_fn(params):
        zeros = lambda: tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=leaves(params)[0].device)
        return AdamState(step=step, mu=zeros(), nu=zeros())

    def update_fn(grads, state, params=None, lr_override=None):
        lr_t = lr if lr_override is None else lr_override
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                      grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float() * g.float(),
                      state.nu, grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()
        updates = tree_map(
            lambda m, n: -(lr_t * (m / c1) / (torch.sqrt(n / c2) + eps)),
            mu, nu)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return init_fn, update_fn
