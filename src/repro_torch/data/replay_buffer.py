"""Device-resident FIFO replay buffers of a whole population
(``repro.data.replay_buffer``).

The JAX package writes one member's buffer and ``vmap``s it; here the
population's buffers are written out as one tree: every data leaf is
``(N, capacity, ...)``, and ``insert_pos`` and ``total`` are ``(N,)``
int32. Inserts and samples are single indexed copies over all members,
on the device.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.distributed import member_draw
from repro_torch.tree import leaves, tree_map


class ReplayBuffer(NamedTuple):
    data: Any                  # tree; leaves (N, capacity, ...)
    insert_pos: torch.Tensor   # (N,) int32
    total: torch.Tensor        # (N,) int32, items ever added


def buffer_init(n: int, capacity: int, item_spec: dict,
                device="cpu") -> ReplayBuffer:
    """``item_spec``: name -> (shape, dtype) of one item."""
    data = {k: torch.zeros((n, capacity) + tuple(shape), dtype=dtype,
                           device=device)
            for k, (shape, dtype) in item_spec.items()}
    zeros = torch.zeros((n,), dtype=torch.int32, device=device)
    return ReplayBuffer(data=data, insert_pos=zeros, total=zeros.clone())


def buffer_add(buf: ReplayBuffer, batch) -> ReplayBuffer:
    """Insert a batch (leaves (N, T, ...)) at each member's ring position
    (FIFO, wrapping around). The buffer stores exactly the keys its spec
    declared; a richer transition dict is filtered down.

    The items are written into the buffer's tensors in place (where the
    JAX package donates them), so the returned buffer shares its data with
    ``buf``: keep using the returned one."""
    batch = {k: batch[k] for k in buf.data}
    n, t = leaves(batch)[0].shape[:2]
    capacity = leaves(buf.data)[0].shape[1]
    rows = torch.arange(n, device=buf.insert_pos.device)[:, None]
    idx = (buf.insert_pos[:, None].long()
           + torch.arange(t, device=buf.insert_pos.device)) % capacity

    for k, store in buf.data.items():
        store[rows, idx] = batch[k].to(store.dtype)
    return ReplayBuffer(
        data=buf.data,
        insert_pos=((buf.insert_pos + t) % capacity).to(torch.int32),
        total=buf.total + t)


def buffer_can_sample(buf: ReplayBuffer, batch_size: int):
    """(N,) bool: which members' buffers hold a batch (a device value)."""
    return buf.total >= batch_size


def sample_indices(buf: ReplayBuffer, generator, batch_size: int,
                   steps: int = 1):
    """``(steps, N, B)`` uniform indices into each member's filled items,
    ``floor(u * min(total, capacity))`` from one uniform draw ``u`` of
    ``generator``. The count is the device's ``buf.total``, never a host
    number, so a CUDA graph that captures the draw samples each replay's
    fill, not the capture's."""
    n, capacity = leaves(buf.data)[0].shape[:2]
    count = torch.clamp(buf.total, max=capacity)[None, :, None]
    u = member_draw(torch.rand, (steps, n, batch_size), generator,
                    axis=1).to(count.device)
    idx = torch.floor(u * count.float()).long()
    # u * count can round up to count in float32 for large counts
    return torch.minimum(idx, (count - 1).long())


def buffer_sample(buf: ReplayBuffer, generator, batch_size: int,
                  steps: int = 1, *, filled: int | None = None, idx=None):
    """Uniform samples (with replacement): leaves ``(steps, N, B, ...)``.

    One index tensor ``(steps, N, B)`` is drawn by :func:`sample_indices`
    from ``generator`` (in ``[0, min(total, capacity))`` of each member,
    the count read on the device), or injected as ``idx``. ``filled`` is
    the host's count of items each member's buffer holds (every member
    inserts the same number per collect, so a caller that counts its
    inserts never reads the device); it only guards against sampling an
    empty buffer, which would return the zero initialization as if it
    were data. Without it the count is read back from ``buf.total`` for
    that check."""
    if filled is None:
        filled = int(buf.total.min())
    if filled <= 0:
        raise ValueError(
            "buffer_sample called on an empty buffer; gate on "
            "buffer_can_sample(buf, batch_size) first")
    n = leaves(buf.data)[0].shape[0]
    if idx is None:
        idx = sample_indices(buf, generator, batch_size, steps)
    rows = torch.arange(n, device=idx.device)[None, :, None]
    return tree_map(lambda store: store[rows, idx.to(store.device)],
                    buf.data)
