"""Population-level Adam (``repro.optim.pop_adam``): the ``pop_adam``
kernel as an optimizer over member-stacked parameter trees.

``apply_fn`` flattens every stacked leaf (in the sorted-key order of
:mod:`repro_torch.tree`) into ONE ``(N, P)`` matrix, runs one Adam step
for the whole population with each member's own learning rate, and
rebuilds contiguous leaves (``pop_matmul`` requires a contiguous ``w``).
The kernel masks its ragged tail, so nothing is padded.

``fused=None`` runs :func:`repro_torch.kernels.pop_adam.pop_adam`: the
Triton kernel on CUDA tensors, its plain version on CPU tensors.
``fused=False`` always runs the plain version (the JAX package's
``fused=False``, where XLA runs Adam). The optimizer state has the same
structure as the JAX package's: ``AdamState(step=(N,) int32, mu, nu)``
with mu and nu stacked like the parameters.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.pop_adam import pop_adam, pop_adam_plain
from repro_torch.optim.optimizers import AdamState
from repro_torch.tree import flatten, tree_map, unflatten


def _flatten(tree):
    """Stacked tree (leaves (N, ...)) -> ((N, P) float32, rebuild fn)."""
    leaves, treedef = flatten(tree)
    n = leaves[0].shape[0]
    sizes = [math.prod(l.shape[1:]) for l in leaves]
    flat = torch.cat([l.reshape(n, -1).float() for l in leaves], dim=1)

    def rebuild(mat):
        outs, off = [], 0
        for leaf, size in zip(leaves, sizes):
            outs.append(mat[:, off:off + size].reshape(leaf.shape)
                        .to(leaf.dtype).contiguous())
            off += size
        return unflatten(treedef, outs)

    return flat, rebuild


def population_adam(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8, fused=None):
    """Build ``(init_fn, apply_fn)`` over population-stacked trees::

        state = init_fn(stacked_params)               # leaves (N, ...)
        params, state = apply_fn(params, grads, state, lr_override=lr_n)

    ``lr_override`` is a scalar or an ``(N,)`` per-member vector. Unlike the
    stock pair this applies the update itself (the kernel fuses moment
    update, bias correction and apply in one pass). ``grads`` has the
    structure of ``params``."""
    step_fn = pop_adam_plain if fused is False else pop_adam

    def init_fn(params):
        leaves, _ = flatten(params)
        zeros = lambda: tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(step=torch.zeros((leaves[0].shape[0],),
                                          dtype=torch.int32,
                                          device=leaves[0].device),
                         mu=zeros(), nu=zeros())

    def apply_fn(params, grads, state, lr_override=None):
        step = state.step + 1
        n = step.shape[0]
        lr_t = lr if lr_override is None else lr_override
        lr_vec = torch.as_tensor(lr_t, dtype=torch.float32,
                                 device=step.device).expand(n).contiguous()
        pf, rebuild = _flatten(params)
        gf, _ = _flatten(grads)
        mf, _ = _flatten(state.mu)
        nf, _ = _flatten(state.nu)
        p2, m2, v2 = step_fn(pf, gf, mf, nf, lr_vec, step, b1=b1, b2=b2,
                             eps=eps)
        return rebuild(p2), AdamState(step=step, mu=rebuild(m2),
                                      nu=rebuild(v2))

    return init_fn, apply_fn
