"""A function of device trees captured once as a CUDA graph and replayed
(the port's counterpart of one jitted JAX program).

:class:`CapturedFunction` wraps ``fn(*trees, generator) -> outputs`` whose
first ``len(trees)`` outputs have the structure of its inputs (the state
it carries: population state, buffers, env states, hypers, strategy
state) and whose other outputs are results (stacked metrics, fitness,
lineage). The first call captures; every call replays:

  * warm-up: one run of ``fn`` on clones of the inputs on a side stream,
    with the generator's state put back after it, so the kernels' builds,
    Triton's compile, cuBLAS's handles and the allocator all settle before
    the capture and nothing of the real state moves;
  * capture: the inputs become the graph's static inputs (a leaf that
    shares storage with another, or is not contiguous, is cloned first);
    at the end of the captured region every carried output is copied into
    its static input (``torch._foreach_copy_``), so each replay starts
    where the last one ended;
  * the generator is registered with the graph
    (``CUDAGraph.register_generator_state``): each replay draws the
    numbers that follow the last ones, as the eager run would, not the
    capture's again;
  * a later call whose inputs are not the static ones (an eager iteration
    ran in between) copies them in first.

Nothing here reads the device. A capture that fails raises: the caller
never falls back to running eagerly. Launch counters that Python code
moves (the kernel wrappers') do not move on a replay, so given
``counts``, a function returning such counters by name, the capture
records how many launches of each it captured (``captured_launches``)
and the warm-up ran (``warmup_launches``); a replay launches the captured
ones again (``replays`` counts them).

A capture holds :data:`repro_torch.telemetry.sink.capture_lock`, so a
telemetry writer thread copies nothing while it runs (a capture refuses
other threads' work), and is announced to the compile listeners
(:func:`repro_torch.kernels.build.notify_compile`) as ``"cuda_graph"``
with its seconds.
"""
from __future__ import annotations

import ctypes
import time

import torch

from repro_torch.kernels.build import notify_compile
from repro_torch.telemetry.sink import capture_lock
from repro_torch.tree import distinct, flatten, leaves, tree_map


class CapturedFunction:
    def __init__(self, fn, generator, carried: int, counts=None):
        """``fn(*trees, generator)``; its first ``carried`` outputs are
        copied back into the ``carried`` input trees. ``counts() -> {name:
        count}`` snapshots the launch counters to record (or None)."""
        self.fn = fn
        self.generator = generator
        self.carried = carried
        self.counts = counts
        self.graph = None
        self.static = None
        self.results = None
        self.replays = 0
        self.capture_seconds = None
        self.pool_bytes = None
        self.captured_launches = None
        self.warmup_launches = None

    def _counts(self):
        return None if self.counts is None else dict(self.counts())

    def _since(self, before):
        if before is None:
            return None
        return {k: v - before[k] for k, v in self.counts().items()}

    def _warm_up(self, trees):
        state = self.generator.get_state()
        clones = tree_map(torch.clone, trees)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        before = self._counts()
        with torch.cuda.stream(side):
            self.fn(*clones, self.generator)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.warmup_launches = self._since(before)
        del clones
        self.generator.set_state(state)

    def _capture(self, trees):
        with capture_lock:
            self._capture_locked(trees)
        notify_compile("cuda_graph", self.capture_seconds)

    def _capture_locked(self, trees):
        self._warm_up(trees)
        self.static = distinct(trees)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        register = getattr(graph, "register_generator_state", None)
        if register is None:
            raise RuntimeError(
                "this torch's CUDAGraph has no register_generator_state: a "
                "captured epoch could not draw new numbers on each replay")
        register(self.generator)
        # the capture empties the allocator's cache first; so do we, so
        # that what it reserves after is the graph's private pool
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        before = self._counts()
        with torch.cuda.graph(graph):
            outs = self.fn(*self.static, self.generator)
            carried = list(outs[:self.carried])
            mine = {id(x) for x in leaves(self.static)}
            dst, src = [], []
            for static, out in zip(self.static, carried):
                for s, o in zip(leaves(static), leaves(out)):
                    if o is s:
                        continue
                    if id(o) in mine:   # another input's tensor: copy it
                        o = o.clone()   # before any input is overwritten
                    dst.append(s)
                    src.append(o)
            if dst:
                torch._foreach_copy_(dst, src)
        self.captured_launches = self._since(before)
        graph.instantiate()
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        for static, out in zip(self.static, carried):
            if flatten(static)[1] != flatten(out)[1]:
                raise ValueError("a captured function must return its "
                                 "carried trees with their input structure")
        self.results = outs[self.carried:]
        self.graph = graph

    def _load(self, trees):
        for static, tree in zip(self.static, trees):
            got, treedef = flatten(tree)
            mine, static_def = flatten(static)
            if treedef != static_def:
                raise ValueError("captured function called with inputs of "
                                 "another structure than at its capture")
            for s, x in zip(mine, got):
                if x is not s:
                    s.copy_(x)

    def __call__(self, *trees):
        """Run the function (capturing it at the first call): returns the
        static carried trees, now holding the outputs, followed by the
        result outputs (graph-owned: the next replay overwrites them)."""
        if len(trees) != self.carried:
            raise ValueError(f"expected {self.carried} carried trees, got "
                             f"{len(trees)}")
        if self.graph is None:
            self._capture(trees)
        else:
            self._load(trees)
        self.graph.replay()
        self.replays += 1
        return (*self.static, *self.results)

    def node_count(self) -> int | None:
        """Nodes of the captured graph (``cudaGraphGetNodes``), or None
        where the CUDA runtime cannot be opened by name."""
        try:
            cudart = ctypes.CDLL("libcudart.so.12")
        except OSError:
            return None
        count = ctypes.c_size_t(0)
        rc = cudart.cudaGraphGetNodes(
            ctypes.c_void_p(self.graph.raw_cuda_graph()), None,
            ctypes.byref(count))
        return int(count.value) if rc == 0 else None
