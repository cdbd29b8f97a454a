"""DvD diversity (Parker-Holder et al., 2020), the part serving shares with
training (``repro.core.dvd``): behavioral embeddings and their RBF kernel,
whose determinant is the ensemble's volume."""
from __future__ import annotations

import torch

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
