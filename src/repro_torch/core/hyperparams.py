"""Per-member hyperparameters as ``(N,)`` vectors (paper §5.1 / §B.1;
``repro.core.hyperparams``). Priors: log-uniform for learning rates,
uniform for the rest.

Each random step is split in two: the *draws* (from a ``torch.Generator``,
on its device) and a pure *apply* that takes them, so a test can feed the
draws that the JAX package's key chain makes and compare exactly.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import HyperSpace
from repro_torch.device import device_tensor


def hyper_draws(generator, space: HyperSpace, n: int) -> dict:
    """One uniform [0, 1) float32 vector ``(n,)`` per prior entry."""
    return {name: torch.rand((n,), generator=generator,
                             device=generator.device)
            for name in space.names}


def apply_hyper_draws(space: HyperSpace, draws: dict) -> dict:
    """Uniform draws -> hyper values, in the JAX package's arithmetic
    (``jax.random.uniform``: ``max(lo, u * (hi - lo) + lo)`` in float32,
    on ``log lo``, ``log hi`` and then ``exp`` for log-uniform priors)."""
    out = {}
    for name, lo, hi in space.log_uniform:
        u = draws[name]
        lo_t, hi_t = (torch.log(device_tensor(v, torch.float32, u.device))
                      for v in (lo, hi))
        out[name] = torch.exp(torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t))
    for name, lo, hi in space.uniform:
        u = draws[name]
        lo_t, hi_t = (device_tensor(v, torch.float32, u.device)
                      for v in (lo, hi))
        out[name] = torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)
    return out


def sample_hypers(generator, space: HyperSpace, n: int, *, draws=None):
    """``(n,)`` values for every prior entry of ``space``."""
    if draws is None:
        draws = hyper_draws(generator, space, n)
    return apply_hyper_draws(space, draws)


def _bounds(space: HyperSpace, name: str):
    for n, lo, hi in tuple(space.log_uniform) + tuple(space.uniform):
        if n == name:
            return lo, hi
    raise KeyError(name)


def perturb_draws(generator, space: HyperSpace, names, n: int,
                  perturb_prob: float = 0.5) -> dict:
    """The draws of one explore step: ``fresh`` samples from the prior, and
    per hyper (sorted names) an ``up`` coin (scale up or down) and a
    ``resample`` coin (fresh sample instead of the scaled value)."""
    fresh = sample_hypers(generator, space, n)
    up, resample = {}, {}
    for name in sorted(names):
        up[name] = torch.rand((n,), generator=generator,
                              device=generator.device) < 0.5
        resample[name] = torch.rand((n,), generator=generator,
                                    device=generator.device) < perturb_prob
    return {"fresh": fresh, "up": up, "resample": resample}


def perturb_hypers(generator, hypers, space: HyperSpace, mask,
                   perturb_prob: float = 0.5, scale: float = 1.2, *,
                   draws=None):
    """PBT explore: members where ``mask`` is True either take a fresh
    sample from the prior or have each hyper multiplied by scale^{+-1}
    (clipped to the prior range); the others keep theirs."""
    if draws is None:
        draws = perturb_draws(generator, space, hypers, mask.shape[0],
                              perturb_prob)
    out = {}
    for name in sorted(hypers):
        lo, hi = _bounds(space, name)
        h = hypers[name]
        factor = torch.where(draws["up"][name],
                             device_tensor(scale, h.dtype, h.device),
                             device_tensor(1.0 / scale, h.dtype, h.device))
        perturbed = torch.clamp(h * factor, lo, hi)
        explored = torch.where(draws["resample"][name],
                               draws["fresh"][name], perturbed)
        out[name] = torch.where(mask, explored, h)
    return out
