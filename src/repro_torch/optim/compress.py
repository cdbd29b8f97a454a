"""Int8 error-feedback gradient compression for the data-parallel
reduction (``repro.optim.compress``).

Before the reduction, gradients are quantized per tensor to int8 with an
fp32 scale; the quantization error is fed back into the next step's
gradient (error feedback), which keeps SGD/Adam convergence (Karimireddy
et al., 2019). The int8 tensors are what crosses the links
(:mod:`repro_torch.optim.dp`), a quarter of fp32's bytes. Plain PyTorch,
as the JAX package computes it outside any Pallas kernel; ``torch.round``
rounds half to even as ``jnp.round`` does, so the payloads are the JAX
package's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.tree import flatten, tree_map, unflatten


def int8_compress(g):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_decompress(q, scale):
    return q.to(torch.float32) * scale


def compress_tree(grads, error):
    """Quantize grads + error; returns (q_tree, scale_tree,
    new_error_tree)."""
    flat, treedef = flatten(grads)
    out = []
    for g, e in zip(flat, flatten(error)[0]):
        ge = g.to(torch.float32) + e
        q, s = int8_compress(ge)
        out.append((q, s, ge - int8_decompress(q, s)))
    return tuple(unflatten(treedef, [o[i] for o in out]) for i in range(3))


def decompress_tree(q, s):
    return tree_map(int8_decompress, q, s)
