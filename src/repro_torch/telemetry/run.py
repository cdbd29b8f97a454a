"""``RunTelemetry`` (``repro.telemetry.run``): one object that turns a
training or serving run into a structured record.

Owned by ``PopTrainer`` (and shared with the rollout engine, the serving
stack and the launchers); everything it records flows through one
:class:`~repro_torch.telemetry.sink.MetricsSink`, so a run log is a single
JSONL stream ``tools/report.py`` replays into a PBT family tree,
per-member hyper trajectories, per-phase timing and compile counts.

Nothing here reads a device value on the caller's thread. Phase timers
are host wall-clock (``perf_counter``) around dispatch. A row's tensors
are snapshotted (:class:`~repro_torch.telemetry.sink.Snapshot`: a clone
on the device and an event after it, nothing waited for) and fetched by
the sink's writer thread. A caller that already holds clones nothing
writes (the fused epoch's stacks) passes a snapshot of them, taken once
an epoch.

There is no XLA compile to count. The port's ``compile`` rows are its
kernel builds (:mod:`repro_torch.kernels.build`: ``event`` the source's
name) and its CUDA graph captures (:mod:`repro_torch.rollout.graph`:
``event`` ``"cuda_graph"``), both through the listener registry of
:func:`repro_torch.kernels.build.add_compile_listener`, each labelled
``"warmup"`` until the first iteration completes, ``"steady"`` after, or
what an enclosing :meth:`RunTelemetry.compile_scope` says: a capture in
steady state shows as a recompile does.

``start_profile``/``stop_profile``/``tick_profile`` drive
``torch.profiler`` (CPU and, on the card, CUDA activities) and write a
Chrome trace into the directory given. On the card a session opened
minutes after the process's previous one loses the kernels of its first
launches (19 at 230 s in :mod:`repro_torch.telemetry.window_probe`'s
runs; each launch itself is in the trace), whatever waits,
synchronisations or warm-up steps come first. So a CUDA session starts
with :func:`profiler_burst`, ``PROFILE_BURST`` throwaway launches the
loss takes instead of the caller's, and ends with another, before the
caller's last kernels; the ``profile`` rows say so (``burst``).
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from repro_torch.telemetry.sink import MetricsSink, NullSink, Snapshot, \
    has_tensor
from repro_torch.tree import leaves


# the throwaway launches at each end of a profile session on the card
PROFILE_BURST = 64


def profiler_burst(launches: int = PROFILE_BURST):
    """``launches`` one-element kernels on the current CUDA device, then a
    synchronisation: what a late profile session loses in place of the
    caller's kernels."""
    one = torch.zeros(1, device="cuda")
    for _ in range(launches):
        one.add_(1)
    torch.cuda.synchronize()


def _run_id() -> str:
    return f"{int(time.time()):x}-{os.getpid():x}"


def make_telemetry(log_dir=None, *, console: bool = True,
                   console_every: int = 10, meta=None,
                   device=None) -> "RunTelemetry":
    """The launchers' recipe: JSONL into ``log_dir/telemetry.jsonl`` when
    a log dir is given, plus the console sink (iter rows throttled to one
    in ``console_every``) when ``console``."""
    from repro_torch.telemetry.sink import ConsoleSink, JSONLSink, MultiSink

    sinks = []
    if log_dir:
        sinks.append(JSONLSink(Path(log_dir) / "telemetry.jsonl"))
    if console:
        sinks.append(ConsoleSink(every=console_every))
    if not sinks:
        return RunTelemetry(None, meta=meta, device=device)
    sink = sinks[0] if len(sinks) == 1 else MultiSink(sinks)
    return RunTelemetry(sink, meta=meta, device=device)


def _wait(value):
    """Wait, without a stream sync, for the launches that made ``value``'s
    CUDA tensors: an event recorded on the current stream, synchronized."""
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves(value)):
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream())
        done.synchronize()


class RunTelemetry:
    """Phase timers and structured rows over one sink.

    ``sink=None`` builds a disabled instance (``enabled`` False): every
    method stays callable and cheap (no snapshot is taken), so
    instrumented code never branches on "is telemetry on". ``meta`` lands
    in the run-header row; ``device`` names the run's device there (the
    CUDA device when there is one, else the CPU); ``track_compiles``
    subscribes to the kernel builds and graph captures for this object's
    lifetime.
    """

    def __init__(self, sink: MetricsSink | None = None, *, meta=None,
                 run_id: str | None = None, track_compiles: bool = True,
                 device=None):
        self.enabled = sink is not None
        self.sink = sink if sink is not None else NullSink()
        self.run_id = run_id or _run_id()
        self._t0 = time.perf_counter()
        self._phases: dict[str, float] = {}
        self._blocks: dict[str, float] = {}
        self._compile_label = "warmup"
        self.compile_count = 0
        self.compile_secs = 0.0
        self._unregister = None
        self._profiler = None
        self._trace_dir = None
        self._burst = 0
        if self.enabled:
            if device is None:
                device = "cuda" if torch.cuda.is_available() else "cpu"
            device = torch.device(device)
            gpu = device.type == "cuda"
            self.sink.write({
                "kind": "run", "run_id": self.run_id,
                "torch": torch.__version__,
                "devices": torch.cuda.device_count() if gpu else 1,
                "platform": "gpu" if gpu else "cpu",
                "device": (torch.cuda.get_device_name(device) if gpu
                           else "cpu"),
                "meta": dict(meta or {})})
            if track_compiles:
                from repro_torch.kernels.build import add_compile_listener
                self._unregister = add_compile_listener(self._on_compile)

    # -------------------------------------------------------------- timing
    def _stamp(self) -> float:
        return round(time.perf_counter() - self._t0, 6)

    @contextmanager
    def phase(self, name: str):
        """Accumulate host wall-clock of the enclosed block into ``name``
        for the current iteration row. It times dispatch: device time
        shows up in whichever later phase or block waits for it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._phases[name] = self._phases.get(name, 0.0) + dt

    def block(self, name: str, value):
        """Wait for ``value``'s tensors (an event recorded after them on
        the current stream, the stream that made them; never
        ``torch.cuda.synchronize()``) and accumulate the wait into the
        iteration row's ``blocks``. Returns ``value``."""
        t0 = time.perf_counter()
        _wait(value)
        dt = time.perf_counter() - t0
        self._blocks[name] = self._blocks.get(name, 0.0) + dt
        return value

    def snapshot(self, tree, *, clone: bool = True):
        """A :class:`Snapshot` of ``tree`` for rows (None when disabled);
        ``clone=False`` for tensors that nothing will write again."""
        if not self.enabled or tree is None:
            return None
        return Snapshot.take(tree, clone=clone)

    def _value(self, value):
        """A row value: a snapshot of it when it holds tensors."""
        if isinstance(value, Snapshot) or not has_tensor(value):
            return value
        return Snapshot.take(value)

    # --------------------------------------------------------------- rows
    def record(self, kind: str, **fields):
        """Emit one generic row (stamped with ``t``)."""
        if not self.enabled:
            return
        self.sink.write(dict({k: self._value(v) for k, v in fields.items()},
                             kind=kind, t=self._stamp()))

    def record_iteration(self, step: int, *, metrics=None, stats=None,
                         did_update=None, **extra):
        """Close out one train iteration: the accumulated phase timers plus
        what the iteration produced."""
        phases = {k: round(v, 6) for k, v in self._phases.items()}
        self._phases.clear()
        if self._compile_label == "warmup":
            self._compile_label = "steady"
        blocks = {k: round(v, 6) for k, v in self._blocks.items()}
        self._blocks.clear()
        if not self.enabled:
            return
        row = {"kind": "iter", "t": self._stamp(), "step": step,
               "phases": phases, **extra}
        if blocks:
            row["blocks"] = blocks
        if metrics is not None:
            row["metrics"] = self._value(metrics)
        if stats is not None:
            row["stats"] = self._value(stats)
        if did_update is not None:
            row["did_update"] = self._value(did_update)
        self.sink.write(row)

    def record_members(self, step: int, *, fitness=None, hypers=None):
        """Per-member fitness and dynamic hyperparameters: the time series
        of these rows is the hyper trajectory ``tools/report.py``
        reconstructs."""
        if not self.enabled:
            return
        row = {"kind": "members", "t": self._stamp(), "step": step}
        if fitness is not None:
            row["fitness"] = self._value(fitness)
        if hypers is not None:
            row["hypers"] = self._value(hypers)
        self.sink.write(row)

    def record_evolve(self, step: int, parents, *, fitness=None,
                      strategy=None):
        """One lineage event: ``parents[i]`` is the member whose state
        member ``i`` now holds (-1 = drawn fresh from a distribution)."""
        if not self.enabled:
            return
        row = {"kind": "evolve", "t": self._stamp(), "step": step,
               "parents": self._value(parents)}
        if fitness is not None:
            row["fitness"] = self._value(fitness)
        if strategy is not None:
            row["strategy"] = strategy
        self.sink.write(row)

    def record_ckpt(self, step: int, secs: float, **extra):
        if not self.enabled:
            return
        self.sink.write({"kind": "ckpt", "t": self._stamp(), "step": step,
                         "secs": round(secs, 6), **extra})

    # ------------------------------------------------------------ compiles
    def _on_compile(self, event: str, secs: float):
        self.compile_count += 1
        self.compile_secs += secs
        self.sink.write({"kind": "compile", "t": self._stamp(),
                         "event": event, "secs": round(secs, 6),
                         "label": self._compile_label,
                         "count": self.compile_count})

    @contextmanager
    def compile_scope(self, label: str):
        """Attribute builds and captures inside the block to ``label``
        (``"promotion"`` around a serving-set swap, ``"evolve"``)."""
        prev, self._compile_label = self._compile_label, label
        try:
            yield
        finally:
            self._compile_label = prev

    # ------------------------------------------------------------ profiler
    def start_profile(self, trace_dir):
        """Begin a ``torch.profiler`` trace (CPU, and CUDA where there is
        a card, opened with :func:`profiler_burst`); :meth:`stop_profile`
        writes it into ``trace_dir``."""
        if self._profiler is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._trace_dir = Path(trace_dir)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        self._burst = PROFILE_BURST if torch.cuda.is_available() else 0
        if self._burst:
            profiler_burst(self._burst)
        self.record("profile", action="start", dir=str(trace_dir),
                    burst=self._burst)

    def stop_profile(self):
        """End the trace, after another :func:`profiler_burst` on the
        card, and write it as ``<trace_dir>/<run_id>.trace.json`` (Chrome
        trace format)."""
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        if self._burst:
            profiler_burst(self._burst)
        prof.__exit__(None, None, None)
        self._trace_dir.mkdir(parents=True, exist_ok=True)
        path = self._trace_dir / f"{self.run_id}.trace.json"
        prof.export_chrome_trace(str(path))
        self.record("profile", action="stop", path=str(path),
                    burst=self._burst)

    def tick_profile(self, it: int, trace_dir, *, start: int = 1,
                     iters: int = 3):
        """Bounded profiling window for a training or serving loop: start
        the trace at iteration ``start`` (after the warm-up) and stop it
        ``iters`` iterations later. Call once per iteration; no-op when
        ``trace_dir`` is falsy."""
        if not trace_dir:
            return
        if it == start:
            self.start_profile(trace_dir)
        elif it == start + iters:
            self.stop_profile()

    # ------------------------------------------------------------ lifetime
    def close(self):
        """Stop the compile listener and any open trace, and close the
        sink (draining the writer thread)."""
        self.stop_profile()
        if self._unregister is not None:
            self._unregister()
            self._unregister = None
        self.sink.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
