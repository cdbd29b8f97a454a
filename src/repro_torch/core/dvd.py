"""DvD diversity (Parker-Holder et al., 2020; ``repro.core.dvd``), §5.3.

The diversity of a population is the volume (determinant) of the RBF
kernel matrix of its members' behavioral embeddings: each policy's
actions on a shared batch of probe states, flattened. Serving picks a
diverse ensemble with :func:`rbf_kernel`; training adds
``coef * dvd_loss`` to the actor loss, with the coefficient on the square
wave of :func:`dvd_coef_schedule` (§B.2).
"""
from __future__ import annotations

import torch

from repro_torch.device import device_tensor
from repro_torch.rl import networks as nets
from repro_torch.tree import leaves, tree_map


def behavior_embedding(policy_apply, pop_params, probe_obs):
    """Embed each member: its actions on the shared probe states,
    flattened -> (N, E)."""
    n = leaves(pop_params)[0].shape[0]
    return torch.stack([
        policy_apply(tree_map(lambda x: x[i], pop_params),
                     probe_obs).reshape(-1)
        for i in range(n)])


def rbf_kernel(embeddings, *, length_scale: float = 1.0, eps: float = 1e-4):
    """The (N, N) RBF kernel matrix of member embeddings plus ``eps`` on the
    diagonal."""
    d2 = torch.sum(
        torch.square(embeddings[:, None, :] - embeddings[None, :, :]), dim=-1)
    n = embeddings.shape[0]
    k = torch.exp(-d2 / (2 * length_scale ** 2 * embeddings.shape[-1]))
    return k + eps * torch.eye(n, dtype=k.dtype, device=k.device)


def pop_behavior_embedding(policies, probe_obs, *, fused=None):
    """:func:`behavior_embedding` of the TD3 actor over member-stacked
    ``policies`` in one population-level call: the (P, obs) probe is
    broadcast over the members (member stride 0, no copy) and each layer
    is one ``pop_matmul``. -> (N, P * act)."""
    n = leaves(policies)[0].shape[0]
    probe = probe_obs.unsqueeze(0).expand((n,) + tuple(probe_obs.shape))
    return nets.pop_actor_apply(policies, probe, fused=fused).reshape(n, -1)


def dvd_loss(embeddings, *, length_scale: float = 1.0, eps: float = 1e-4):
    """-log det of the RBF kernel matrix of member embeddings (maximising
    diversity is minimising this loss)."""
    k = rbf_kernel(embeddings, length_scale=length_scale, eps=eps)
    return -torch.linalg.slogdet(k)[1]


def dvd_coef_schedule(step, period: int = 20_000, hi: float = 0.5,
                      lo: float = 0.0):
    """Square wave of the diversity coefficient (§B.2): ``lo`` for the
    first ``period // 2`` steps, then ``hi``, and so on. ``step`` is an
    integer or an integer tensor; returns a float32 tensor on its
    device."""
    step = torch.as_tensor(step)
    phase = (step // (period // 2)) % 2
    return torch.where(phase == 0,
                       device_tensor(lo, torch.float32, step.device),
                       device_tensor(hi, torch.float32, step.device))
