"""The TD3 actor and the population-batched applies (``repro.rl.networks``).

Standard size from Fujimoto et al.: a 256-256 MLP.

The ``pop_*_apply`` family evaluates the same parametrization over
member-stacked parameters (leaves ``(N, ...)``) and member-batched inputs
``(N, B, ...)`` in one population-level call, each linear layer one
:func:`repro_torch.kernels.pop_matmul.pop_matmul` with the bias and
activation fused. Routing per linear is decided by ``fused``:

  * ``None`` / ``True`` — the ``pop_matmul`` wrapper: the CUDA kernel for a
    CUDA tensor (every shape; there is no tileability gate), its plain
    version for a CPU tensor;
  * ``False``           — always the plain einsum version.

Forward only for now: the wrapper refuses inputs that require grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pop_matmul import (ACTIVATIONS, pop_matmul,
                                            pop_matmul_plain)
from repro_torch.nn.basic import mlp_apply, mlp_init

HIDDEN = (256, 256)


def actor_init(generator, obs_dim: int, act_dim: int, hidden=HIDDEN, *,
               device="cpu"):
    return mlp_init(generator, [obs_dim, *hidden, act_dim], device=device)


def actor_apply(params, obs):
    return torch.tanh(mlp_apply(params, obs))


def pop_linear_apply(p, x, *, activation: str = "none", fused=None):
    """Member-stacked linear: ``p`` {"w": (N,K,M), "b": (N,M)}, ``x``
    (N,B,K) -> act(x @ w + b), (N,B,M)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"pop_linear_apply: unsupported activation "
                         f"{activation!r} (none|relu|tanh)")
    fn = pop_matmul_plain if fused is False else pop_matmul
    return fn(x, p["w"], p.get("b"), activation=activation)


def pop_mlp_apply(p, x, *, activation: str = "relu",
                  final_activation: str | None = None, fused=None):
    """``mlp_apply`` over member-stacked params: same layer naming and
    activation placement, population-level."""
    n = len(p)
    for i in range(n):
        inner = activation if i < n - 1 else (final_activation or "none")
        x = pop_linear_apply(p[f"layer_{i}"], x, activation=inner,
                             fused=fused)
    return x


def pop_actor_apply(params, obs, *, fused=None):
    """Population-level ``actor_apply``: tanh MLP, (N,B,obs) -> (N,B,act)."""
    return pop_mlp_apply(params, obs, final_activation="tanh", fused=fused)
