"""Engine telemetry: metrics registry, span tracing, Perfetto export.

Host-side only — nothing in this package touches a device tensor, so
telemetry adds no device synchronisation, and importing it imports no
torch: ``engine.py`` imports torch's profiler check on its first use, to
open the pod step's profiler ranges only while a profiler records. Copies of
``repro.obs`` (the port imports nothing of ``repro``); the metric names,
labels and span names are the reference's, plus the pod step's phases
(``EngineObs.step_begin``). See docs/observability.md for the metric
catalog and the span taxonomy, and docs/observability_torch.md for the
pod step's phases, their histograms and profiler ranges.
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
