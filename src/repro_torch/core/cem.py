"""Cross-Entropy Method over policy parameters (CEM-RL, Pourchot & Sigaud;
``repro.core.cem``).

The distribution is a diagonal gaussian over the flattened parameter
vector of one member. The vector is ``ravel_pytree``'s: the leaves in the
JAX package's flatten order (:func:`repro_torch.tree.flatten`, dict keys
sorted), each raveled row-major and concatenated. Sampling N members is
one ``(N, P)`` matrix, the stacked-population layout.

The JAX package draws from a key; here :func:`cem_sample` draws from a
``torch.Generator``, or takes the standard normal draw as ``eps``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.tree import flatten, unflatten


class CEMState(NamedTuple):
    mean: torch.Tensor     # (P,)
    var: torch.Tensor      # (P,)
    noise: torch.Tensor    # scalar additive noise on the variance (decays)


def ravel(tree):
    """One member's parameter tree -> ``((P,) vector, unravel)``;
    ``unravel`` maps an ``(N, P)`` matrix to the member-stacked tree of
    contiguous leaves ``(N, ...)``."""
    leaves, treedef = flatten(tree)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(mat):
        outs, off = [], 0
        for shape, size in zip(shapes, sizes):
            outs.append(mat[:, off:off + size]
                        .reshape((mat.shape[0],) + shape).contiguous())
            off += size
        return unflatten(treedef, outs)

    return flat, unravel


def ravel_stacked(tree):
    """Member-stacked tree (leaves ``(N, ...)``) -> the ``(N, P)`` matrix
    of its members' raveled vectors."""
    leaves, _ = flatten(tree)
    n = leaves[0].shape[0]
    return torch.cat([leaf.reshape(n, -1) for leaf in leaves], dim=1)


def cem_init(params_template, sigma_init: float = 1e-2,
             noise_init: float = 1e-2):
    """Centre the distribution on one member's parameters; the paper raises
    CEM's initial noise from 1e-3 to 1e-2 (§B.2). Returns (state,
    unravel)."""
    flat, unravel = ravel(params_template)
    state = CEMState(mean=flat, var=torch.full_like(flat, sigma_init),
                     noise=torch.tensor(noise_init, dtype=flat.dtype,
                                        device=flat.device))
    return state, unravel


def cem_sample(generator, state: CEMState, n: int, *, eps=None):
    """``n`` draws, ``(N, P)``: ``mean + sqrt(var + noise) * eps`` (the
    noise is added to the variance). ``eps`` is the ``(N, P)`` standard
    normal draw, made from ``generator`` when not given."""
    if eps is None:
        eps = torch.randn((n,) + tuple(state.mean.shape), generator=generator,
                          device=generator.device)
    return state.mean + torch.sqrt(state.var + state.noise) * \
        eps.to(state.mean.device)


def cem_weights(n: int, elite_frac: float = 0.5, device="cpu"):
    """The elites' log-rank weights, ``(k,)`` with ``k = round(N
    elite_frac)``, in the ascending order of :func:`cem_update`'s elites
    (the fittest last, weighing most). Computed on the host and copied to
    ``device`` once: a strategy makes them outside any captured graph."""
    k = max(1, int(round(n * elite_frac)))
    w = (torch.log(torch.tensor(float(1 + k)))
         - torch.log(torch.arange(1, k + 1, dtype=torch.float32)))
    return (w / w.sum()).flip(0).to(device)


def cem_update(state: CEMState, samples, fitness, elite_frac: float = 0.5,
               noise_decay: float = 0.999, *, weights=None):
    """Refit on the elites. samples: (N, P); fitness: (N,) higher-better.
    The elites are the top ``round(N elite_frac)`` by a stable ascending
    sort (ties keep member order, as ``jnp.argsort``); the log-rank weights
    (:func:`cem_weights`, or ``weights`` made by it) are in that ascending
    order, so the fittest weighs most. The new variance is taken about the
    OLD mean."""
    n = fitness.shape[0]
    w = cem_weights(n, elite_frac, samples.device) if weights is None \
        else weights
    k = w.shape[0]
    elite_idx = torch.argsort(fitness, stable=True)[n - k:]
    elites = samples[elite_idx]
    mean = torch.einsum("i,ip->p", w, elites)
    var = torch.einsum("i,ip->p", w, torch.square(elites - state.mean))
    return CEMState(mean=mean, var=var, noise=state.noise * noise_decay)
