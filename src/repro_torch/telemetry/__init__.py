"""``repro_torch.telemetry`` (``repro.telemetry``): structured run
telemetry behind one non-blocking sink.

Phase timers, per-member fitness and hypers, lineage events, kernel builds
and graph captures, checkpoint times and serving latency flow as schema'd
rows through a background-thread sink (JSONL canonical; CSV, console and
fan-out variants); device values reach the host on the sink's thread,
from snapshots (:class:`Snapshot`), never on the training loop's::

    from repro_torch.telemetry import make_telemetry
    tel = make_telemetry(log_dir, meta={"algo": "td3"})
    trainer = PopTrainer(agent, pcfg, telemetry=tel)
    ...
    tel.close()

``tools/report.py`` replays the JSONL into a PBT family tree, per-member
hyper trajectories, per-phase timing and compile counts.
"""
from repro_torch.telemetry.latency import LatencyWindow
from repro_torch.telemetry.run import RunTelemetry, make_telemetry
from repro_torch.telemetry.sink import (CSVSink, ConsoleSink, JSONLSink,
                                        MetricsSink, MultiSink, NullSink,
                                        ROW_KINDS, Snapshot, jsonable,
                                        validate_row)

__all__ = [
    "CSVSink", "ConsoleSink", "JSONLSink", "LatencyWindow", "MetricsSink",
    "MultiSink", "NullSink", "ROW_KINDS", "RunTelemetry", "Snapshot",
    "jsonable", "make_telemetry", "validate_row",
]
