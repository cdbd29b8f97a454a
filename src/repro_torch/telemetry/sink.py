"""Metrics sinks (``repro.telemetry.sink``): where telemetry rows go,
without blocking training.

A *row* is a flat-ish dict; the only keys every row must carry are

  * ``kind`` — the row type (``"iter"``, ``"evolve"``, ``"serve"``, ...;
    see :data:`ROW_KINDS` for the per-kind required fields), and
  * ``t`` — seconds since the sink was opened (stamped by the sink when
    the producer didn't).

Everything else is kind-specific. Every sink hands rows to a background
writer thread, which converts them with :func:`jsonable`: that is where
device values reach the host, off the train loop's thread. A torch tensor
is mutable, where a JAX array is not: a captured epoch's outputs are
overwritten by its next replay, and an LM population's parameters are
stepped in place. So a row never carries a live CUDA tensor; it carries a
:class:`Snapshot`, a clone made on the device (enqueued, not waited for)
with an event recorded after it. The writer thread makes its stream wait
for that event, copies into pinned host memory with non-blocking copies
and waits for an event of its own: it never syncs a stream, which
``torch.cuda.set_sync_debug_mode("error")``, process-wide, would refuse,
and never reads a value before the launch that made it has finished.
While a CUDA graph is being captured (:mod:`repro_torch.rollout.graph`)
the copy, its wait and the pinned buffers' release wait
(``capture_lock``): a capture refuses work of other threads.

Sinks:

  * :class:`JSONLSink`  — one JSON object per line; the canonical format
    (``tools/report.py`` consumes it).
  * :class:`CSVSink`    — one row kind per file, header from the first row.
  * :class:`ConsoleSink`— the human formatting path.
  * :class:`MultiSink`  — fan-out to several sinks.
  * :class:`NullSink`   — the disabled case; ``write`` is a no-op.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import to_host
from repro_torch.tree import flatten, tree_map, unflatten

# held by a CUDA graph capture; the writer's copies take it too
capture_lock = threading.Lock()

# Required fields per row kind (beyond "kind" and "t").  ``tools/report.py
# --check`` and the sink-side validation both read this table; a kind not
# listed here is legal (user-defined rows) but only checked for kind/t.
ROW_KINDS: dict[str, tuple] = {
    "run": ("run_id",),                      # header: config, devices, ...
    "iter": ("step", "phases"),              # per-iteration timings:
    #   "phases" — host DISPATCH wall-clock per phase (time spent
    #     enqueueing device work; never includes waiting on results);
    #   "blocks" (optional) — host WAIT wall-clock per name
    #     (``RunTelemetry.block``: the wait on an event recorded after
    #     the value was made).
    #   Serial engine: block ≈ device wall per iteration.  Overlapped
    #   engine (policy_lag=1): block covers only the update — collect
    #   dispatch hides under it, which is the overlap win report.py shows.
    "members": ("step",),                    # per-member fitness/hypers
    "evolve": ("step", "parents"),           # lineage event
    "compile": ("event", "secs", "label"),   # a kernel build, a capture
    "ckpt": ("step", "secs"),                # checkpoint save
    "serve": ("count", "p50_ms", "p99_ms"),  # serving latency window
    "promotion": ("step", "members"),        # serving-set audit event
    "engine": ("algo",),                     # rollout engine config
    "profile": ("action",),                  # profiler start/stop marker
    "bench": ("bench",),                     # benchmark result row
}


def validate_row(row) -> str | None:
    """None when ``row`` is schema-valid, else a human-readable error."""
    if not isinstance(row, dict):
        return f"row is {type(row).__name__}, not a dict"
    kind = row.get("kind")
    if not isinstance(kind, str):
        return f"row lacks a string 'kind': {row!r}"
    if not isinstance(row.get("t"), (int, float)):
        return f"{kind} row lacks a numeric 't'"
    missing = [f for f in ROW_KINDS.get(kind, ()) if f not in row]
    if missing:
        return f"{kind} row lacks required fields {missing}"
    return None


class _Source:
    """What a :class:`Snapshot` reads: a tree of tensors that no later
    launch writes, the event after which it holds its values (None on the
    CPU), and its host copy, made once."""

    def __init__(self, tree, event):
        self.tree, self.event = tree, event
        self.host = None
        self.lock = threading.Lock()

    def fetch(self):
        with self.lock:
            if self.host is None:
                self.host = _copy_to_host(self.tree, self.event)
                self.tree = self.event = None
            return self.host


def _copy_to_host(tree, event):
    """Numpy copies of ``tree``'s tensors, made on this thread's own
    stream after ``event`` (:func:`repro_torch.device.to_host`). On the
    card every CUDA call of it runs under ``capture_lock``, the wait for
    the copies and the return of the pinned buffers to the allocator
    included: a graph capture in global mode refuses such calls from any
    other thread."""
    if event is None:
        flat, treedef = flatten(tree)
        return unflatten(treedef, [_numpy(x) for x in flat])
    with capture_lock:
        stream = _writer_stream()
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            flat, treedef = flatten(to_host(tree))
            host = [np.array(_numpy(x)) if isinstance(x, torch.Tensor)
                    else x for x in flat]
            del flat    # the pinned buffers go back to the allocator here
    return unflatten(treedef, host)


_streams = threading.local()


def _writer_stream():
    """The calling thread's own CUDA stream (a writer never queues behind
    the training loop's default stream)."""
    stream = getattr(_streams, "stream", None)
    if stream is None:
        stream = _streams.stream = torch.cuda.Stream()
    return stream


def _numpy(x):
    if not isinstance(x, torch.Tensor):
        return x
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.numpy()


class Snapshot:
    """A part of a snapshot of device values (:meth:`take`), read on the
    writer thread. ``map(fn)`` selects a part (a key, a slice of a
    stack) without a launch; every part shares one host copy."""

    def __init__(self, source: _Source, path=()):
        self._source, self._path = source, path

    @classmethod
    def take(cls, tree, *, clone: bool = True) -> "Snapshot":
        """Snapshot ``tree``: its tensors cloned (``clone=False``: they are
        clones already, which nothing writes), and on the card an event
        recorded after them on the current stream. Nothing is waited
        for."""
        if clone:
            tree = tree_map(lambda x: x.detach().clone()
                            if isinstance(x, torch.Tensor) else x, tree)
        event = None
        if any(isinstance(x, torch.Tensor) and x.is_cuda
               for x in flatten(tree)[0]):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream())
        return cls(_Source(tree, event))

    def map(self, fn) -> "Snapshot":
        return Snapshot(self._source, self._path + (fn,))

    def host(self):
        """The selected part, as numpy (waits for the snapshot's event)."""
        value = self._source.fetch()
        for fn in self._path:
            value = fn(value)
        return value


def has_tensor(value) -> bool:
    """Whether ``value`` holds a torch tensor that a row would have to
    snapshot."""
    if isinstance(value, torch.Tensor):
        return True
    if isinstance(value, dict):
        return any(has_tensor(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(has_tensor(v) for v in value)
    return False


def jsonable(value):
    """Recursively convert a row value to plain JSON types. Runs on the
    sink's writer thread: a :class:`Snapshot` is fetched here; a CPU
    tensor is read as it is (a CUDA one raises: it must come as a
    snapshot)."""
    if isinstance(value, Snapshot):
        value = value.host()
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            raise TypeError("a CUDA tensor in a telemetry row: pass a "
                            "Snapshot (RunTelemetry snapshots row values)")
        value = _numpy(value)
    if isinstance(value, float):
        # json can't carry NaN/Inf portably; stringify the rare ones
        return value if np.isfinite(value) else str(value)
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    arr = np.asarray(value)
    if arr.ndim == 0:
        item = arr.item()
        if isinstance(item, float) and not np.isfinite(item):
            return str(item)
        return item
    return jsonable(arr.tolist())


class MetricsSink:
    """Protocol: ``write(row)`` must be non-blocking; ``flush()`` waits for
    everything written so far to hit the backing store; ``close()`` flushes
    and releases resources.  Sinks are also context managers."""

    def write(self, row: dict):
        raise NotImplementedError

    def flush(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NullSink(MetricsSink):
    def write(self, row: dict):
        pass


class _ThreadedSink(MetricsSink):
    """Queue + daemon writer thread shared by the concrete sinks.

    ``write`` enqueues the raw row (arrays included) and returns; the
    worker converts with :func:`jsonable` and calls :meth:`_emit`.  A row
    that fails to convert or validate is reported once and dropped —
    telemetry must never take the run down."""

    _CLOSE = object()

    def __init__(self, *, strict: bool = False):
        self._t0 = time.perf_counter()
        self._q: queue.Queue = queue.Queue()
        self._strict = strict
        self._errors: list[str] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ producer
    def write(self, row: dict):
        if "t" not in row:
            row = dict(row, t=round(time.perf_counter() - self._t0, 6))
        self._q.put(row)

    def flush(self):
        done = threading.Event()
        self._q.put(done)
        done.wait(timeout=30)

    def close(self):
        if self._thread is None:
            return
        self._q.put(self._CLOSE)
        self._thread.join(timeout=30)
        self._thread = None
        self._close_backend()
        if self._strict and self._errors:
            raise ValueError("telemetry sink saw invalid rows:\n"
                             + "\n".join(self._errors))

    # -------------------------------------------------------------- worker
    def _worker(self):
        while True:
            item = self._q.get()
            if item is self._CLOSE:
                self._flush_backend()
                return
            if isinstance(item, threading.Event):
                self._flush_backend()
                item.set()
                continue
            try:
                row = jsonable(item)
                err = validate_row(row)
                if err is not None:
                    self._errors.append(err)
                    if not self._strict:
                        continue
                else:
                    self._emit(row)
            except Exception as e:  # pragma: no cover - defensive
                self._errors.append(f"{type(e).__name__}: {e}")

    def _emit(self, row: dict):
        raise NotImplementedError

    def _flush_backend(self):
        pass

    def _close_backend(self):
        pass


class JSONLSink(_ThreadedSink):
    """The canonical sink: one JSON object per line, append-only.

    ``path``'s parent directories are created.  The same format is what
    ``benchmarks/common.write_rows`` produces and ``tools/report.py``
    consumes, so CI benchmark artifacts and run logs are one schema."""

    def __init__(self, path, *, strict: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a", buffering=1)
        super().__init__(strict=strict)

    def _emit(self, row: dict):
        self._file.write(json.dumps(row, separators=(",", ":")) + "\n")

    def _flush_backend(self):
        self._file.flush()

    def _close_backend(self):
        self._file.close()


class CSVSink(_ThreadedSink):
    """CSV for spreadsheet people.  Row kinds have different fields, so the
    sink keeps ONE file per kind (``path`` stem + ``.<kind>.csv``), header
    taken from the first row of that kind; later rows are projected onto
    that header (missing -> empty, extra -> dropped).  Nested values are
    JSON-encoded in their cell."""

    def __init__(self, path, *, kinds: tuple | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._kinds = kinds
        self._files: dict[str, tuple] = {}   # kind -> (file, fields)
        super().__init__()

    def _emit(self, row: dict):
        kind = row["kind"]
        if self._kinds is not None and kind not in self._kinds:
            return
        if kind not in self._files:
            f = open(self.path.with_suffix(f".{kind}.csv"), "w", buffering=1)
            fields = list(row)
            f.write(",".join(fields) + "\n")
            self._files[kind] = (f, fields)
        f, fields = self._files[kind]
        cells = []
        for name in fields:
            v = row.get(name, "")
            if isinstance(v, (dict, list)):
                v = json.dumps(v, separators=(",", ":")).replace(",", ";")
            cells.append(str(v))
        f.write(",".join(cells) + "\n")

    def _flush_backend(self):
        for f, _ in self._files.values():
            f.flush()

    def _close_backend(self):
        for f, _ in self._files.values():
            f.close()


class ConsoleSink(_ThreadedSink):
    """THE human formatting path — every example and launcher prints
    through this one sink instead of rolling its own f-strings.

    ``every`` throttles the high-rate ``iter``/``members`` rows (print one
    in N); event rows (evolve, promotion, ckpt, serve, ...) always print.
    ``compile`` rows never print — a CPU run emits hundreds and they
    belong in the JSONL record (``tools/report.py`` summarizes them; the
    run_end row carries the count).  Unknown kinds print generically, so
    example-specific diagnostics ride the same pipe."""

    THROTTLED = ("iter", "members")
    QUIET = ("compile",)

    def __init__(self, *, every: int = 1, prefix: str = ""):
        self.every = max(1, every)
        self.prefix = prefix
        self._seen: dict[str, int] = {}
        super().__init__()

    @staticmethod
    def _fmt_val(v):
        if isinstance(v, float):
            return f"{v:+.3f}" if abs(v) < 1e4 else f"{v:.3e}"
        if isinstance(v, list):
            flat = [x for x in v if isinstance(x, (int, float))]
            if flat and len(flat) == len(v):
                return (f"mean{sum(flat) / len(flat):+.3f}/"
                        f"max{max(flat):+.3f}")
            return json.dumps(v)
        if isinstance(v, dict):
            return "{" + " ".join(
                f"{k}={ConsoleSink._fmt_val(x)}" for k, x in v.items()) + "}"
        return str(v)

    def _emit(self, row: dict):
        kind = row["kind"]
        if kind in self.QUIET:
            return
        if kind in self.THROTTLED:
            n = self._seen[kind] = self._seen.get(kind, 0) + 1
            if (n - 1) % self.every:
                return
        head = f"{self.prefix}[{kind}"
        if "step" in row:
            head += f" {row['step']}"
        head += "]"
        body = " ".join(
            # a lineage's parents are identities, not a distribution —
            # print the list itself, not mean/max
            f"{k}={json.dumps(v) if k == 'parents' else self._fmt_val(v)}"
            for k, v in row.items()
            if k not in ("kind", "step", "t", "run_id"))
        print(f"{head} {body} ({row['t']:.1f}s)", flush=True)


class MultiSink(MetricsSink):
    """Fan one row stream out to several sinks (e.g. JSONL for the record,
    Console for the operator)."""

    def __init__(self, sinks):
        self.sinks = list(sinks)

    def write(self, row: dict):
        for s in self.sinks:
            s.write(row)

    def flush(self):
        for s in self.sinks:
            s.flush()

    def close(self):
        for s in self.sinks:
            s.close()
