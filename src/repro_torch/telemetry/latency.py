"""``LatencyWindow`` — the serving-side latency histogram
(``repro.telemetry.latency``).

Accumulates per-request-batch latencies (plus batch-fill ratio and queue
depth) on the host and summarizes them into one row. Pure numpy, no
device traffic.
"""
from __future__ import annotations

import numpy as np


class LatencyWindow:
    """Rolling window of request latencies + batching health."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._lat: list[float] = []
        self._fill: list[float] = []
        self._queue_depth_max = 0
        self._requests = 0

    @property
    def count(self) -> int:
        return len(self._lat)

    def add(self, seconds: float, *, fill: float | None = None,
            requests: int = 1):
        """One served batch: wall latency, the fraction of padded slots
        that carried real requests, and how many requests it answered."""
        self._lat.append(seconds)
        if fill is not None:
            self._fill.append(fill)
        self._requests += requests

    def observe_queue(self, depth: int):
        self._queue_depth_max = max(self._queue_depth_max, depth)

    def summary(self) -> dict:
        """p50/p99/mean latency (ms), request and batch counts, mean fill
        ratio, max queue depth."""
        lat = np.asarray(self._lat, np.float64)
        out = {"count": int(lat.size), "requests": int(self._requests)}
        if lat.size:
            out.update(
                p50_ms=round(1e3 * float(np.percentile(lat, 50)), 3),
                p99_ms=round(1e3 * float(np.percentile(lat, 99)), 3),
                mean_ms=round(1e3 * float(lat.mean()), 3))
        else:
            out.update(p50_ms=None, p99_ms=None, mean_ms=None)
        if self._fill:
            out["fill"] = round(float(np.mean(self._fill)), 4)
        if self._queue_depth_max:
            out["queue_depth_max"] = int(self._queue_depth_max)
        return out
