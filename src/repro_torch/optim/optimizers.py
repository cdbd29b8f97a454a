"""Functional optimizers over parameter trees (``repro.optim.optimizers``).

An optimizer is a pair ``(init_fn, update_fn)``::

    state = init_fn(params)
    updates, state = update_fn(grads, state, params, lr_override=None)

``lr_override`` is given at update time, which is what lets PBT treat the
learning rate as a per-member hyperparameter; Adam's ``wd_override`` does
the same for the decoupled weight decay. The schedules take an integer
step tensor and return a float32 tensor; ``dynamic_warmup_cosine`` takes
the warmup length as a fraction that may itself be a tensor, so it is
evaluated elementwise on ``(N,)`` vectors of per-member steps and
fractions.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def global_norm(tree):
    """The L2 norm of every leaf together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm):
    """``tree`` scaled so its global norm is at most ``max_norm``;
    returns (clipped tree, norm before clipping)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda x: x * scale, tree), norm


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         max_grad_norm: float | None = None):
    """Adam, or AdamW with ``weight_decay`` (decoupled: ``-lr wd p`` on the
    old parameters). ``update_fn(grads, state, params, lr_override=...,
    wd_override=...)``; ``params`` is needed only when there is decay."""

    def init_fn(params):
        zeros = lambda: tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=leaves(params)[0].device)
        return AdamState(step=step, mu=zeros(), nu=zeros())

    def update_fn(grads, state, params=None, lr_override=None,
                  wd_override=None):
        lr_t = lr if lr_override is None else lr_override
        wd = weight_decay if wd_override is None else wd_override
        decoupled = (wd_override is not None) or bool(weight_decay)
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        step = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                      grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float() * g.float(),
                      state.nu, grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(m, n, p):
            u = -(lr_t * (m / c1) / (torch.sqrt(n / c2) + eps))
            if decoupled:
                u = u - lr_t * wd * p.float()
            return u

        updates = tree_map(upd, mu, nu, params if decoupled else mu)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return init_fn, update_fn


def adamw(lr: float = 3e-4, weight_decay: float = 0.1, **kw):
    return adam(lr=lr, weight_decay=weight_decay, **kw)


def sgd(lr: float = 1e-2, momentum: float = 0.0):
    """SGD, with heavy-ball ``momentum`` when it is nonzero."""

    def init_fn(params):
        if momentum:
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
        return ()

    def update_fn(grads, state, params=None, lr_override=None):
        lr_t = lr if lr_override is None else lr_override
        if momentum:
            state = tree_map(lambda v, g: momentum * v + g.float(), state,
                             grads)
            return tree_map(lambda v: -lr_t * v, state), state
        return tree_map(lambda g: -lr_t * g.float(), grads), state

    return init_fn, update_fn


def cosine_schedule(base_lr: float, total_steps: int,
                    final_frac: float = 0.1):
    def lr_at(step):
        t = torch.clamp(step.float(), max=total_steps) / total_steps
        return base_lr * (final_frac + (1 - final_frac) * 0.5
                          * (1 + torch.cos(math.pi * t)))
    return lr_at


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          final_frac)

    def lr_at(step):
        step = step.float()
        warm = base_lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return lr_at


def dynamic_warmup_cosine(base_lr: float, total_steps: int,
                          final_frac: float = 0.1):
    """:func:`warmup_cosine` with the warmup length a fraction of
    ``total_steps`` given at call time: ``lr_at(step, warmup_frac)``,
    elementwise, the form PBT needs to perturb warmup per member."""
    def lr_at(step, warmup_frac):
        step = step.float()
        warm_steps = torch.clamp(
            torch.as_tensor(warmup_frac, dtype=torch.float32,
                            device=step.device) * total_steps, min=1.0)
        span = torch.clamp(total_steps - warm_steps, min=1.0)
        warm = base_lr * step / warm_steps
        t = torch.minimum(step - warm_steps, span) / span
        cos = base_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warm_steps, warm, cos)
    return lr_at
