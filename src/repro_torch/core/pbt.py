"""PBT exploit/explore on the device (paper §5.1, Jaderberg et al. 2017;
``repro.core.pbt``). Every ``pbt_interval`` trainer steps the bottom
``exploit_frac`` of members (by fitness) copy the full training state of a
random top-``exploit_frac`` member and re-explore their hyperparameters.

As in :mod:`repro_torch.core.hyperparams` the random step is split into
draws (:func:`pbt_draws`) and a pure apply, so the JAX package's draws can
be injected. The cut ``k`` is computed on the host from N alone; ranking,
parent picks and gathers stay on the device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import PopulationConfig
from repro_torch.core.hyperparams import perturb_draws, perturb_hypers
from repro_torch.tree import tree_map


def exploit_count(n: int, exploit_frac: float) -> int:
    return max(1, int(round(n * exploit_frac)))


def pbt_draws(generator, hypers, pcfg: PopulationConfig, n: int) -> dict:
    """``parent``: (k,) picks in [0, k) among the top k; ``perturb``: the
    explore draws (:func:`perturb_draws`)."""
    k = exploit_count(n, pcfg.exploit_frac)
    return {"parent": torch.randint(0, k, (k,), generator=generator,
                                    device=generator.device),
            "perturb": perturb_draws(generator, pcfg.hyper_space, hypers, n,
                                     pcfg.perturb_prob)}


def pbt_step(generator, pop_state, hypers, fitness, pcfg: PopulationConfig,
             gather=None, *, draws=None):
    """fitness: (N,), higher is better. Returns (pop_state, hypers,
    parents); ``parents[i]`` is the member whose state member i now holds
    (``i`` for survivors). ``gather(pop_state, parents)`` overrides the
    member copy."""
    n = fitness.shape[0]
    k = exploit_count(n, pcfg.exploit_frac)
    if draws is None:
        draws = pbt_draws(generator, hypers, pcfg, n)
    order = torch.argsort(fitness, stable=True)        # ascending
    bottom, top = order[:k], order[n - k:]
    parents = torch.arange(n, device=fitness.device)
    parents[bottom] = top[draws["parent"].to(fitness.device)]

    if gather is None:
        new_state = tree_map(lambda x: x[parents], pop_state)
    else:
        new_state = gather(pop_state, parents)
    replaced = torch.zeros((n,), dtype=torch.bool, device=fitness.device)
    replaced.index_fill_(0, bottom, True)
    new_hypers = tree_map(lambda x: x[parents], hypers)
    new_hypers = perturb_hypers(generator, new_hypers, pcfg.hyper_space,
                                replaced, perturb_prob=pcfg.perturb_prob,
                                scale=pcfg.perturb_scale,
                                draws=draws["perturb"])
    return new_state, new_hypers, parents
