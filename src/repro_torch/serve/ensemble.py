"""``ServingSet`` — which members of a trained population serve traffic
(``repro.serve.ensemble``).

Selection follows Effective Diversity (DvD): maximize z-normalized
fitness plus the log-determinant volume of the RBF kernel of behavioral
embeddings, greedily, the fittest member always first. This is host-side
control-plane math that runs once per promotion, never per request.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.dvd import rbf_kernel
from repro_torch.tree import tree_map


def _logdet(k: np.ndarray) -> float:
    sign, logdet = np.linalg.slogdet(k)
    return float(logdet)


def select_members(fitness, embeddings, k: int, *,
                   diversity_weight: float = 1.0,
                   length_scale: float = 1.0) -> np.ndarray:
    """Pick ``k`` member indices by fitness + DvD diversity gain.

    ``fitness`` is (N,) or None (selection on diversity alone);
    ``embeddings`` is (N, E) or None (selection on fitness alone). Each
    slot after the fittest member goes to the candidate maximizing
    ``z_fitness + diversity_weight * (logdet K[S+c] - logdet K[S])``.

    The kernel matrix is float32, as the JAX package's is (64-bit off), so
    both packages score candidates alike and pick the same members."""
    if fitness is None and embeddings is None:
        raise ValueError("select_members needs fitness and/or embeddings; "
                         "got neither")
    n = len(fitness) if fitness is not None else len(embeddings)
    k = max(1, min(k, n))
    if fitness is not None:
        fit = np.asarray(fitness, np.float64)
        std = fit.std()
        z = (fit - fit.mean()) / (std if std > 0 else 1.0)
    else:
        z = np.zeros((n,))
    if embeddings is None:
        return np.argsort(-z, kind="stable")[:k].astype(np.int64)

    emb = torch.as_tensor(np.asarray(embeddings), dtype=torch.float32)
    kern = rbf_kernel(emb, length_scale=length_scale).numpy()
    selected = [int(np.argmax(z))]
    while len(selected) < k:
        base = _logdet(kern[np.ix_(selected, selected)])
        best_c, best_score = None, -np.inf
        for c in range(n):
            if c in selected:
                continue
            trial = selected + [c]
            gain = _logdet(kern[np.ix_(trial, trial)]) - base
            score = z[c] + diversity_weight * gain
            if score > best_score:
                best_c, best_score = c, score
        selected.append(best_c)
    return np.asarray(selected, np.int64)


@dataclass(frozen=True)
class ServingSet:
    """The members currently serving traffic.

    ``members[i]`` is the population index behind ensemble slot ``i``;
    ``params`` the (k,)-stacked actor tree in that order; ``best`` the slot
    (not the population index) of the fittest member, which the ``"best"``
    reduction serves; ``step`` the checkpoint step it was promoted from.
    """
    step: int
    members: np.ndarray                 # (k,) population indices
    params: Any                         # stacked actor tree, leaves (k, ...)
    fitness: np.ndarray | None = None   # (k,) fitness per slot, or None
    best: int = 0                       # slot index of the fittest member

    @property
    def size(self) -> int:
        return len(self.members)

    def describe(self) -> str:
        fit = ("none" if self.fitness is None
               else np.asarray(self.fitness).round(2).tolist())
        return (f"ServingSet(step={self.step}, "
                f"members={self.members.tolist()}, fitness={fit}, "
                f"best=slot {self.best})")


def make_serving_set(actors, members, *, step: int = -1,
                     fitness=None) -> ServingSet:
    """Gather ``members`` (population indices) out of a stacked actor tree
    into a :class:`ServingSet`."""
    members = np.asarray(members, np.int64)
    params = tree_map(
        lambda x: x[torch.as_tensor(members, device=x.device)].contiguous(),
        actors)
    fit = None
    if fitness is not None:
        fit = np.asarray(fitness, np.float64)[members]
    best = 0 if fit is None else int(np.argmax(fit))
    return ServingSet(step=step, members=members, params=params,
                      fitness=fit, best=best)
