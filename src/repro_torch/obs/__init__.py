"""Engine telemetry: metrics registry, span tracing, Perfetto export.

Host-side only — nothing in this package imports torch or touches a
device tensor, so telemetry adds no device synchronisation. Copies of
``repro.obs`` (the port imports nothing of ``repro``); the metric names,
labels and span names are the reference's. See docs/observability.md for the metric catalog and the
span taxonomy.
"""
from repro_torch.obs.engine import EngineObs
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               default_registry, log_buckets, prometheus,
                               snapshot)
from repro_torch.obs.trace import NullRecorder, TraceRecorder, merge_chrome

__all__ = [
    "EngineObs",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "log_buckets", "prometheus", "snapshot",
    "NullRecorder", "TraceRecorder", "merge_chrome",
]
