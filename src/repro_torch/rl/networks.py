"""The TD3 actor and twin critic, and the population-batched applies
(``repro.rl.networks``).

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

Both routes are differentiable: the wrapper records its backward through
``repro_torch.kernels.pop_matmul.PopMatmul`` (batched matmuls), the plain
version through torch's own autograd.
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


def critic_init(generator, obs_dim: int, act_dim: int, hidden=HIDDEN, *,
                device="cpu"):
    """Twin Q networks on ``concat(obs, act)``."""
    sizes = [obs_dim + act_dim, *hidden, 1]
    return {"q1": mlp_init(generator, sizes, device=device),
            "q2": mlp_init(generator, sizes, device=device)}


def critic_apply(params, obs, act):
    x = torch.cat([obs, act], dim=-1)
    return (mlp_apply(params["q1"], x)[..., 0],
            mlp_apply(params["q2"], x)[..., 0])


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


def pop_critic_apply(params, obs, act, *, fused=None):
    """Population-level ``critic_apply``: (N,B,obs), (N,B,act) -> the twin
    Q values, each (N,B)."""
    x = torch.cat([obs, act], dim=-1)
    return (pop_mlp_apply(params["q1"], x, fused=fused)[..., 0],
            pop_mlp_apply(params["q2"], x, fused=fused)[..., 0])
