"""Roofline accounting of one pass (``repro.launch.hlo_analysis``).

The JAX package parses the optimized HLO text of a compiled cell. The
port has no HLO: this module reads the aten ops of a pass run on ``meta``
tensors (shapes and dtypes, no memory, no kernel), one rank's pass, as
the post-partitioning HLO is one device's. :class:`OpCounter`, a
``TorchDispatchMode``, adds the pass up the way the JAX analyzer does:

  * **FLOPs** of dot-like ops only: ``mm``, ``bmm``, ``addmm``,
    ``baddbmm`` (2 M N K, times the batch) and ``convolution`` (2 x the
    output's elements x the input channels a group x the kernel's taps),
    as JAX counts ``dot`` and ``convolution``;
  * **traffic**: the operand and output bytes of every op that is not a
    view (a view counts as nothing, like ``bitcast``; an allocation
    without operands, ``empty``, as nothing, like ``parameter``);
  * **collectives**: every call of :mod:`repro_torch.core.distributed`'s
    choke point (``all_reduce``, ``broadcast``, ``all_gather``, and the
    tensor-parallel region functions over them) while the counter runs,
    recorded (never run: the pass joins no process group) with the bytes
    of its output times JAX's ``_COLL_FACTOR`` (all-reduce 2, the others
    1; broadcast, which JAX's HLO never shows, 1), counted by kind, and
    the module that issued it;
  * **a hand-written kernel** called on ``meta`` tensors takes its
    wrapper's meta route (:func:`repro_torch.kernels.meta_call`): meta
    outputs of the right shapes, no build and no launch, and one op
    counted as JAX counts a ``custom-call``: its operand and output
    bytes, plus the matmul FLOPs of its shapes (``flash_attention``
    4 B H D x the causal pairs S (S + 1) / 2, or S^2 without the mask;
    ``wkv6`` B H S (4 D^2 + 2 C D) with chunk C: the state's products and
    the chunk's two causal products; ``ssd`` B H S (4 P N + C (N + P));
    ``pop_matmul`` 2 N B K M; ``pop_adam`` none, it is elementwise).

It also tracks every storage a pass allocates (a view shares its base's,
so a storage counts once) for the peak of live bytes, the dry run's
``temps``.

:func:`roofline_terms` keeps JAX's keys against the H100's published
peaks at 700 W, per card: 989e12 FLOP/s of dense bf16, 3.35e12 B/s of
HBM, 450e9 B/s of NVLink each way. A 256-card mesh spans hosts (8 cards
a host share NVLink; between hosts the link is the network's, several
times slower), so the collective term is a lower bound there.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import distributed as _dist
from repro_torch import kernels as _kernels

# wire bytes per output byte, JAX's ring approximations, and broadcast
COLL_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0,
               "broadcast": 1.0}

# the H100 SXM's published peaks at 700 W, per card
PEAK_FLOPS = 989e12       # dense bf16
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # NVLink, bytes/s each way

_aten = torch.ops.aten
_MM = {_aten.mm.default, _aten.addmm.default}
_BMM = {_aten.bmm.default, _aten.baddbmm.default}
_CONV = {_aten.convolution.default}
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.detach.default,
         _aten.lift_fresh.default, _aten._unsafe_view.default}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def dot_flops(func, args) -> float:
    """FLOPs of a dot-like aten op (0 for any other)."""
    if func in _MM:
        a, b = (args[0], args[1]) if func is _aten.mm.default else \
            (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in _BMM:
        a, b = (args[0], args[1]) if func is _aten.bmm.default else \
            (args[1], args[2])
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func in _CONV:
        x, w = args[0], args[1]
        groups = args[8] if len(args) > 8 else 1
        out_elems = (x.shape[0] * w.shape[0]
                     * math.prod(_conv_out(x, w, args)))
        return 2.0 * out_elems * (x.shape[1] // groups) * math.prod(
            w.shape[2:])
    return 0.0


def _conv_out(x, w, args):
    stride, padding, dilation = args[3], args[4], args[5]
    return [(n + 2 * p - d * (k - 1) - 1) // s + 1
            for n, k, s, p, d in zip(x.shape[2:], w.shape[2:], stride,
                                     padding, dilation)]


def _issuer() -> str:
    """The module of the first frame outside the collectives' modules and
    this one: who issued a collective."""
    skip = ("repro_torch/core/distributed.py", "repro_torch/launch/"
            "hlo_analysis.py", "torch/autograd", "torch/utils")
    for frame in inspect.stack()[2:]:
        name = frame.filename.replace("\\", "/")
        if not any(s in name for s in skip):
            mod = (name.rsplit("src/", 1)[-1] if "src/" in name
                   else name.rsplit("/", 1)[-1]).removesuffix(".py")
            return f"{mod.replace('/', '.')}:{frame.lineno}"
    return "?"


class OpCounter(TorchDispatchMode):
    """Counts a pass (module docstring). Use as a context manager around
    the pass; the totals are in :meth:`analysis`. ``args`` (a tree of
    tensors) are the pass's arguments: their storages are live before
    it, and excluded from ``temps``."""

    def __init__(self, args=None):
        super().__init__()
        self.flops = 0.0
        self.traffic = 0.0
        self.coll_bytes = 0.0
        self.coll_counts: dict = defaultdict(int)
        self.collectives: list = []
        self.custom_calls: dict = defaultdict(int)
        self.ops = 0
        self._live: dict = {}
        self._live_bytes = 0
        self.peak_bytes = 0
        self._paused = False
        self._args = {StorageWeakRef(t.untyped_storage()).cdata
                      for t in _tensors(args)}

    # -------------------------------------------------------- bookkeeping
    def _track(self, out):
        for t in _tensors(out):
            ref = StorageWeakRef(t.untyped_storage())
            held = self._live.get(ref.cdata)
            if ref.cdata in self._args or (held is not None
                                           and not held[0].expired()):
                continue
            if held is not None:         # a freed storage's address reused
                self._live_bytes -= held[1]
            size = t.untyped_storage().nbytes()
            self._live[ref.cdata] = (ref, size)
            self._live_bytes += size
        if self._live_bytes > self.peak_bytes:
            self._prune()
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    def _prune(self):
        for key in [k for k, (ref, _) in self._live.items()
                    if ref.expired()]:
            self._live_bytes -= self._live.pop(key)[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._paused:
            return out
        self.ops += 1
        if func not in _FREE and not func.is_view:
            self.flops += dot_flops(func, args)
            self.traffic += sum(nbytes(t) for t in _tensors(args)) + sum(
                nbytes(t) for t in _tensors(kwargs or {})) + sum(
                nbytes(t) for t in _tensors(out))
        self._track(out)
        return out

    def _collective(self, kind, tensor, group):
        size = _dist.group_size(group)
        if kind == "all-gather":
            with self._pause():
                out = [torch.empty_like(tensor) for _ in range(size)]
            wire = nbytes(tensor) * size
        else:
            out = tensor
            wire = nbytes(tensor)
        self.record_collective(kind, wire, _issuer())
        return out

    def record_collective(self, kind: str, out_bytes: float, issuer=""):
        """Count one collective of ``out_bytes`` output bytes (the dry
        run's FSDP gathers and reduce-scatters, reckoned by rule, come
        here too)."""
        wire = out_bytes * COLL_FACTOR[kind]
        self.coll_bytes += wire
        self.coll_counts[kind] += 1
        self.collectives.append({"op": kind, "bytes": wire,
                                 "issuer": issuer})

    def _custom_call(self, name, inputs, outputs, flops):
        self.custom_calls[name] += 1
        self.flops += flops
        self.traffic += sum(nbytes(t) for t in inputs) + sum(
            nbytes(t) for t in outputs)

    @contextlib.contextmanager
    def _pause(self):
        prev, self._paused = self._paused, True
        try:
            yield
        finally:
            self._paused = prev

    def __enter__(self):
        self._hooks = contextlib.ExitStack()
        self._hooks.enter_context(_dist.recording(self._collective))
        self._hooks.enter_context(_kernels.meta_counting(self._custom_call))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._hooks.close()

    def analysis(self) -> dict:
        """JAX's ``analyze_hlo`` keys: ``flops``, ``traffic_bytes``,
        ``collective_bytes``, ``collective_counts``; and the ops seen, the
        kernels' meta calls by name, and the peak of live bytes the pass
        allocated."""
        return {"flops": self.flops, "traffic_bytes": self.traffic,
                "collective_bytes": self.coll_bytes,
                "collective_counts": dict(self.coll_counts),
                "num_ops": self.ops,
                "custom_calls": dict(self.custom_calls),
                "peak_bytes": self.peak_bytes}


def top_collectives(counter: OpCounter, k: int = 20) -> list:
    """The largest collectives of a counted pass by bytes, summed over the
    calls of one kind from one place: ``{"op", "bytes", "trips",
    "total", "hint"}`` (JAX's keys; ``hint`` the issuing module and
    line, ``trips`` the calls)."""
    groups: dict = {}
    for c in counter.collectives:
        key = (c["op"], c["bytes"], c["issuer"])
        groups[key] = groups.get(key, 0) + 1
    records = [{"op": op, "bytes": b, "trips": n, "total": b * n,
                "hint": hint} for (op, b, hint), n in groups.items()]
    records.sort(key=lambda r: -r["total"])
    return records[:k]


def roofline_terms(analysis: dict) -> dict:
    """One card's three-term roofline (seconds) against the H100's peaks;
    the pass is one rank's, so no further division."""
    t_compute = analysis["flops"] / PEAK_FLOPS
    t_memory = analysis["traffic_bytes"] / HBM_BW
    t_coll = analysis["collective_bytes"] / LINK_BW
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {"t_compute": t_compute, "t_memory": t_memory,
            "t_collective": t_coll, "bottleneck": dom[1],
            "roofline_s": dom[0]}
