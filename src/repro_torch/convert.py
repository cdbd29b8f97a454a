"""Carry parameter trees between the JAX package and the port through numpy.

``from_jax_params`` takes a tree whose leaves are numpy arrays (or anything
``np.asarray`` accepts, a JAX array among them — no JAX import needed
here) and returns the same structure with float tensors on ``device``;
``to_numpy`` goes back. Layouts are the same on both sides (``w`` is
(in, out), member axis first), so nothing is transposed."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def from_jax_params(tree, device="cpu"):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def to_numpy(tree):
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    return tree_map(one, tree)
