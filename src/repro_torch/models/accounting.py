"""Parameter and FLOP accounting (``repro.models.accounting``).

``model_flops`` is 6*N*D for training (N the active parameters, D the
tokens) and 2*N*D for an inference pass; the attention scores' O(S^2)
terms are left out, so a step's time against these FLOPs also shows what
attention, recomputation and dispatch cost.

The counts come from shapes alone: :func:`param_shapes` runs
``lm.init_params`` with every tensor it makes on the ``meta`` device, so
no parameter is allocated or drawn (qwen3-moe-30b-a3b's 30.5 B
parameters count in milliseconds on the CPU).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import LMConfig, ShapeSpec


class _MetaShapes(TorchDispatchMode):
    """Every op on the ``meta`` device, a value read back as 0: the
    initialisers' shapes without their numbers (a truncated normal's
    redraw loop, which reads whether any value fell outside, ends at
    once)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.ops.aten._local_scalar_dense.default:
            return 0
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def _paths(node, prefix=""):
    """``(path, leaf)`` of a nested dict/list tree, the path its keys and
    indices joined by dots, as the JAX package names them."""
    if isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        items = enumerate(node)
    else:
        yield prefix, node
        return
    for k, child in items:
        yield from _paths(child, f"{prefix}.{k}" if prefix else str(k))


def param_shapes(cfg: LMConfig) -> list[tuple[str, tuple]]:
    """``(path, shape)`` of every parameter of ``cfg``, from ``meta``
    tensors."""
    from repro_torch.models import lm
    with _MetaShapes():
        params = lm.init_params(torch.Generator(), cfg)
    return [(path, tuple(leaf.shape)) for path, leaf in _paths(params)]


def _leaf_sizes_with_paths(cfg: LMConfig):
    out = []
    for path, shape in param_shapes(cfg):
        size = 1
        for d in shape:
            size *= d
        out.append((path, size))
    return out


def param_count(cfg: LMConfig) -> int:
    return sum(s for _, s in _leaf_sizes_with_paths(cfg))


def active_param_count(cfg: LMConfig) -> int:
    """Experts scaled by top_k/E; the zamba shared block counted once per
    invocation (it runs num_layers/shared_attn_every times); an untied
    embedding table left out (a lookup is a gather, not a matmul; a tied
    one is the output matmul)."""
    total = 0.0
    moe_scale = (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 1.0
    shared_mult = 1.0
    if cfg.shared_attn_every:
        shared_mult = float(-(-cfg.num_layers // cfg.shared_attn_every))
    for path, size in _leaf_sizes_with_paths(cfg):
        if "experts" in path:
            total += size * moe_scale
        elif path.startswith("shared_attn"):
            total += size * shared_mult
        elif path.startswith("embed") and not cfg.tie_embeddings:
            continue
        else:
            total += size
    return int(total)


def model_flops(cfg: LMConfig, shape: ShapeSpec) -> float:
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
