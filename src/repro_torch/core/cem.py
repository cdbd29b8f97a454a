"""Cross-Entropy Method over policy parameters (CEM-RL, Pourchot & Sigaud;
``repro.core.cem``).

The distribution is a diagonal gaussian over the flattened parameter
vector of one member. The vector is ``ravel_pytree``'s: the leaves in the
JAX package's flatten order (:func:`repro_torch.tree.flatten`, dict keys
sorted), each raveled row-major and concatenated. Sampling N members is
one ``(N, P)`` matrix, the stacked-population layout.

The JAX package draws from a key; here :func:`cem_sample` draws from a
``torch.Generator``, or takes the standard normal draw as ``eps``.

A language model's population is too large for the ``(N, P)`` copies of
the plain forms (qwen2-0.5b: 7.9 GB each at N = 4). Its samples are the
flat buffer that holds the members' parameters:
:func:`cem_update_chunked` refits the distribution on the buffer's elites
and :func:`cem_sample_into` redraws the members into the buffer, both a
column chunk at a time and in place. Each computes what the plain form
does, element for element in the same order, so the two agree bit for
bit given the same draw.

Over several ranks (a population split over islands, members sharded
over a model axis) the same two forms run on a rank's rows and columns:
every draw goes through
:func:`repro_torch.core.distributed.member_draw`, made at the whole
population's rows and, with a
:class:`~repro_torch.models.sharding.PartMap`, at the whole member's
columns, of which the rank keeps its own; the refit takes the elites'
rows from their owners (``elites=``,
:func:`repro_torch.core.distributed.owner_rows`) and refits only the
rank's columns, which is exact since the refit is elementwise per
column. A rank then computes the numbers a one-rank run computes for
its rows and columns.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.tree import flatten, unflatten

CHUNK = 1 << 24   # columns the chunked forms refit and redraw at a time


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
    return cem_centre(flat, sigma_init, noise_init), unravel


def cem_centre(mean, sigma_init: float = 1e-2, noise_init: float = 1e-2):
    """The distribution centred on ``mean``, a (P,) vector it keeps."""
    return CEMState(mean=mean, var=torch.full_like(mean, sigma_init),
                    noise=torch.tensor(noise_init, dtype=mean.dtype,
                                       device=mean.device))


def cem_sample(generator, state: CEMState, n: int, *, eps=None):
    """``n`` draws, ``(N, P)``: ``mean + sqrt(var + noise) * eps`` (the
    noise is added to the variance). ``eps`` is the ``(N, P)`` standard
    normal draw, made from ``generator`` when not given (a member-axis
    draw: a rank's ``n`` rows of the whole population's)."""
    if eps is None:
        eps = member_draw(torch.randn, (n,) + tuple(state.mean.shape),
                          generator)
    return state.mean + torch.sqrt(state.var + state.noise) * \
        eps.to(state.mean.device)


def cem_sample_into(out, generator, state: CEMState, *, eps=None,
                    chunk: int | None = None, parts=None):
    """:func:`cem_sample` written into ``out``, an ``(N, P)`` tensor, in
    place, ``chunk`` columns (default :data:`CHUNK`) at a time. Each
    chunk's ``(N, chunk)`` standard normal draw is made from
    ``generator`` (a member-axis draw), or taken from the ``(N, P)``
    ``eps``.

    With ``parts`` (a :class:`~repro_torch.models.sharding.PartMap`)
    ``out`` and ``state`` hold this rank's columns of a model-sharded
    member: the chunks walk the whole member's columns, each draw is made
    at the whole chunk's width, and the rank writes its columns of it, so
    its numbers are those of the one-rank redraw."""
    n, p = out.shape
    chunk = chunk or CHUNK
    width = p if parts is None else parts.whole
    for c in range(0, width, chunk):
        c1 = min(c + chunk, width)
        e = (eps[:, c:c1] if eps is not None else
             member_draw(torch.randn, (n, c1 - c), generator))
        e = e.to(out.device)
        pieces = ([((c, c1), lambda block: block)] if parts is None
                  else parts.pieces(c, c1))
        for (lo, hi), select in pieces:
            out[:, lo:hi] = state.mean[lo:hi] + torch.sqrt(
                state.var[lo:hi] + state.noise) * select(e)
    return out


def cem_weights(n: int, elite_frac: float = 0.5, device="cpu"):
    """The elites' log-rank weights, ``(k,)`` with ``k = round(N
    elite_frac)``, in the ascending order of :func:`cem_update`'s elites
    (the fittest last, weighing most). Computed on the host and copied to
    ``device`` once: a strategy makes them outside any captured graph."""
    k = max(1, int(round(n * elite_frac)))
    w = (torch.log(torch.tensor(float(1 + k)))
         - torch.log(torch.arange(1, k + 1, dtype=torch.float32)))
    return (w / w.sum()).flip(0).to(device)


def _elites(samples, fitness, elite_frac, weights):
    """(the elites' log-rank weights, their rows of ``samples``): the top
    ``round(N elite_frac)`` by a stable ascending sort (ties keep member
    order, as ``jnp.argsort``), the fittest last."""
    n = fitness.shape[0]
    w = cem_weights(n, elite_frac, samples.device) if weights is None \
        else weights
    return w, torch.argsort(fitness, stable=True)[n - w.shape[0]:]


def _refit(w, elites, old_mean):
    """The elites' weighted mean, and their weighted variance about
    ``old_mean``, summed over the elites in their order one elementwise
    operation at a time: a column's result does not depend on which
    columns are computed with it."""
    mean = var = None
    for i in range(w.shape[0]):
        m = w[i] * elites[i]
        v = w[i] * torch.square(elites[i] - old_mean)
        mean, var = (m, v) if mean is None else (mean + m, var + v)
    return mean, var


def cem_update(state: CEMState, samples, fitness, elite_frac: float = 0.5,
               noise_decay: float = 0.999, *, weights=None):
    """Refit on the elites. samples: (N, P); fitness: (N,) higher-better.
    The elites are the top ``round(N elite_frac)`` by a stable ascending
    sort (ties keep member order, as ``jnp.argsort``); the log-rank weights
    (:func:`cem_weights`, or ``weights`` made by it) are in that ascending
    order, so the fittest weighs most. The new variance is taken about the
    OLD mean."""
    w, idx = _elites(samples, fitness, elite_frac, weights)
    mean, var = _refit(w, samples[idx], state.mean)
    return CEMState(mean=mean, var=var, noise=state.noise * noise_decay)


def cem_update_chunked(state: CEMState, samples, fitness,
                       elite_frac: float = 0.5, noise_decay: float = 0.999,
                       *, weights=None, chunk: int | None = None,
                       elites=None):
    """:func:`cem_update` written into ``state.mean`` and ``state.var``
    in place, ``chunk`` columns (default :data:`CHUNK`) at a time, so that
    its temporaries are a few ``(k, chunk)`` blocks and not copies of the
    ``(N, P)`` samples. Returns the state with the decayed noise.

    ``fitness`` is every member's ``(N,)``; ``samples`` may hold only some
    rows (a rank's), when ``elites(members, block)`` gives the rows
    ``members`` (host indices) from this rank's ``block`` of the columns
    (the owners' rows over islands:
    :func:`repro_torch.core.distributed.owner_rows`)."""
    w, idx = _elites(samples, fitness, elite_frac, weights)
    p = samples.shape[1]
    chunk = chunk or CHUNK
    if elites is not None:
        members = idx.tolist()
    for c in range(0, p, chunk):
        cols = slice(c, min(c + chunk, p))
        block = (samples[idx, cols] if elites is None
                 else elites(members, samples[:, cols]))
        mean, var = _refit(w, block, state.mean[cols])
        state.mean[cols] = mean
        state.var[cols] = var
    return CEMState(mean=state.mean, var=state.var,
                    noise=state.noise * noise_decay)
