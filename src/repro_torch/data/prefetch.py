"""Host-side asynchronous data plumbing (``repro.data.prefetch``; the
paper's Appendix A in one process).

``Prefetcher`` runs a producer on a background thread and keeps a bounded
queue of ready batches, so the device's update chain never waits on the
host; an exception in the producer is raised by the next ``__next__``.

``DoubleBuffer`` keeps batch k+1 on its way to the device while batch k is
used. On the card each batch (a tree of numpy arrays or CPU tensors) is
copied into pinned host memory and sent by a non-blocking copy on the
buffer's own stream, with an event recorded after it; ``__next__`` makes
the consumer's current stream wait for that event (no host
synchronisation) and marks the batch's tensors as used on that stream.
On the CPU a batch is copied plainly. Every batch of the wrapped iterator
is yielded, the last one included.

    for batch in DoubleBuffer(host_batches(...), device="cuda"):
        trainer.step(batch)
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.tree import leaves, tree_map


class Prefetcher:
    def __init__(self, producer: Callable[[], object], depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: BaseException | None = None

        def run():
            try:
                while not self._stop.is_set():
                    item = producer()
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # raised by the next __next__
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                return self._q.get(timeout=0.5)
            except queue.Empty:
                continue

    def close(self):
        self._stop.set()


class DoubleBuffer:
    """Wrap a host-batch iterator; yields each batch as tensors on
    ``device`` (the card unless the caller asks for the CPU), the next
    one already in flight."""

    def __init__(self, it: Iterator, device=DEFAULT_DEVICE):
        self._it = iter(it)
        self._device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._next = self._put()

    def _put(self):
        """The next host batch sent on its way, with its event; None once
        the iterator is done."""
        try:
            batch = next(self._it)
        except StopIteration:
            return None
        host = lambda x: torch.as_tensor(x)
        if self._stream is None:
            return tree_map(lambda x: host(x).to(self._device, copy=True),
                            batch), None
        pinned = tree_map(lambda x: host(x).pin_memory(), batch)
        with torch.cuda.stream(self._stream):
            out = tree_map(lambda x: x.to(self._device, non_blocking=True),
                           pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def __iter__(self):
        return self

    def __next__(self):
        if self._next is None:
            raise StopIteration
        out, done = self._next
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for x in leaves(out):
                x.record_stream(consumer)
        self._next = self._put()
        return out
