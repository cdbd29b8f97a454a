"""Carry parameter trees between the JAX package and the port through numpy.

``from_jax_params`` takes a tree whose leaves are numpy arrays (or anything
``np.asarray`` accepts, a JAX array among them — no JAX import needed
here) and returns the same structure with float tensors on ``device``;
``to_numpy`` goes back. Layouts are the same on both sides (``w`` is
(in, out), member axis first), so nothing is transposed, with one
exception: a convolution's weight (the ``w`` of a ``conv_<i>`` entry, DQN's
Atari torso) is HWIO in the JAX package and OIHW in the port, and is
permuted on its last four axes on the way across."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map

# the last four axes: HWIO -> OIHW, and back
_TO_OIHW = (3, 2, 0, 1)
_TO_HWIO = (2, 3, 1, 0)


def _axes(ndim, order):
    """Every axis in place but the last four, which take ``order``."""
    lead = ndim - 4
    return (*range(lead), *(lead + i for i in order))


def _map(fn, tree, conv_fn, in_conv=False):
    """``fn`` over the leaves, then ``conv_fn`` over convolution weights."""
    if isinstance(tree, dict):
        return {k: (conv_fn(fn(v)) if in_conv and k == "w" else
                    _map(fn, v, conv_fn, k.startswith("conv_")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map(fn, v, conv_fn) for v in tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, conv_fn) for v in tree))
    return tree_map(fn, tree)


def from_jax_params(tree, device="cpu"):
    return _map(lambda a: torch.from_numpy(np.array(a)).to(device), tree,
                lambda w: w.permute(_axes(w.ndim, _TO_OIHW)).contiguous())


def to_numpy(tree):
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)
    return _map(one, tree, lambda w: np.ascontiguousarray(
        np.transpose(w, _axes(w.ndim, _TO_HWIO))))
