"""Data-parallel gradient reduction with int8 error-feedback compression
(``repro.optim.dp``).

The JAX package runs this inside ``shard_map`` over the data axis; the
port runs it in each rank's process over a ``torch.distributed`` group
(the world, or a mesh's ``"data"`` group). ``compressed_psum_tree``
quantizes each rank's local gradient to int8 (+ one fp32 scale per
tensor), all-gathers the int8 payloads and the scales (wire bytes: world
x size x 1 B, against the ~2 x size x 4 B of a ring fp32 all-reduce),
decompresses and sums locally; the quantization error is fed back into
the next step. ``plain_psum_tree`` is an ``all_reduce`` divided by the
world. ``make_dp_update`` wraps one rank's gradient function into the
data-parallel update with either reduction, selected by
``TrainConfig.grad_compression``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import all_gather, all_reduce
from repro_torch.optim.compress import compress_tree
from repro_torch.optim.optimizers import apply_updates
from repro_torch.tree import leaves, tree_map


def compressed_psum_tree(grads, error, group=None):
    """The mean of every rank's ``grads`` over ``group`` by int8 payloads;
    returns ``(mean_grads, new_error)``."""
    q, s, new_error = compress_tree(grads, error)
    n = dist.get_world_size(group)

    def reduce_one(qi, si):
        gq = torch.stack(all_gather(qi, group))                 # (n, ...)
        gs = torch.stack(all_gather(si.reshape(1), group))[:, 0]  # (n,)
        return torch.tensordot(gs, gq.to(torch.float32),
                               dims=([0], [0])) / n

    return tree_map(reduce_one, q, s), new_error


def plain_psum_tree(grads, group=None):
    """The mean of every rank's ``grads`` over ``group`` (fp32
    all-reduce)."""
    n = dist.get_world_size(group)
    return tree_map(lambda g: all_reduce(g.clone(), group) / n, grads)


def wire_bytes(grads, world: int, compression: str = "none") -> int:
    """Bytes each rank puts on the wire for one reduction of ``grads``:
    ``world`` x (payload + 4-byte scale) a tensor for int8 (an all-gather
    sends every rank's payload to every rank), ``2 (world - 1) / world``
    x the fp32 bytes for a ring all-reduce."""
    sizes = [x.numel() for x in leaves(grads)]
    if compression == "int8":
        return sum(world * (size + 4) for size in sizes)
    return int(sum(2 * (world - 1) * size * 4 / world for size in sizes))


def make_dp_update(grad_fn, opt_update, group=None, *,
                   compression="none"):
    """``grad_fn(params, batch) -> (loss, grads)`` on this rank's shard of
    the batch. Returns ``update(params, opt_state, error, batch) ->
    (params, opt_state, error, loss)``: the gradient reduced over
    ``group`` (``compression`` ``"none"`` or ``"int8"``, or a
    ``TrainConfig``, whose ``grad_compression`` is taken), one
    ``opt_update(grads, opt_state, params)`` step on every rank (the
    parameters stay replicated), and the mean loss."""
    compression = getattr(compression, "grad_compression", compression)
    if compression not in ("none", "int8"):
        raise ValueError(f"unknown compression {compression!r} (none or "
                         f"int8)")

    def update(params, opt_state, error, batch):
        loss, grads = grad_fn(params, batch)
        if compression == "int8":
            grads, error = compressed_psum_tree(grads, error, group)
        else:
            grads = plain_psum_tree(grads, group)
        updates, opt_state = opt_update(grads, opt_state, params)
        params = apply_updates(params, updates)
        loss = all_reduce(loss.detach().reshape(1).clone(), group)[0]
        return params, opt_state, error, loss / dist.get_world_size(group)

    return update
