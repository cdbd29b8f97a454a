"""Functional MLP building blocks: ``*_init`` returns a nested dict of
float32 tensors with the JAX package's names and layouts (``w`` is
(in, out)), ``*_apply`` consumes it.

Initial values are drawn on the CPU from an explicit ``torch.Generator``
and then moved to ``device``, so a seed gives the same parameters on every
device. They are not the JAX package's values (threefry keys have no
torch counterpart): parity tests carry parameters across with
:mod:`repro_torch.convert` instead.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def lecun_normal(generator: torch.Generator, shape, in_axis: int = -2,
                 *, device="cpu") -> torch.Tensor:
    """``std * N(0,1)`` truncated at +-2 (before scaling), std =
    1/sqrt(fan_in): the JAX package's ``lecun_normal``."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(1.0 / math.sqrt(fan_in)).to(device)


def linear_init(generator, in_features: int, out_features: int, *,
                device="cpu"):
    return {"w": lecun_normal(generator, (in_features, out_features),
                              device=device),
            "b": torch.zeros((out_features,), dtype=torch.float32,
                             device=device)}


def linear_apply(p, x):
    return x @ p["w"] + p["b"]


_ACTS = {"relu": torch.relu, "tanh": torch.tanh}


def mlp_init(generator, sizes: Sequence[int], *, device="cpu"):
    """Plain MLP: sizes = [in, h1, ..., out] -> {"layer_i": {"w", "b"}}."""
    return {f"layer_{i}": linear_init(generator, sizes[i], sizes[i + 1],
                                      device=device)
            for i in range(len(sizes) - 1)}


def mlp_apply(p, x, *, activation: str = "relu",
              final_activation: str | None = None):
    n = len(p)
    act = _ACTS[activation]
    for i in range(n):
        x = linear_apply(p[f"layer_{i}"], x)
        if i < n - 1:
            x = act(x)
        elif final_activation is not None:
            x = _ACTS[final_activation](x)
    return x
