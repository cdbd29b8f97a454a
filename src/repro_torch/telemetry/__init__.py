"""Serving telemetry of the port (the latency window so far)."""
from repro_torch.telemetry.latency import LatencyWindow  # noqa: F401
