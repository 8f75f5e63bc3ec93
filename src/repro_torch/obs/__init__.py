"""Observability of the port's serving stack: a copy of ``repro.obs``.

  * :mod:`repro_torch.obs.metrics` — the typed metrics registry
    (`Counter`, `Gauge`, `Histogram`), JSON snapshots and Prometheus
    text exposition;
  * :mod:`repro_torch.obs.trace` — per-request span tracing on the
    serving stack's virtual clock, exported as Chrome trace-event JSON,
    and the port's host spans (`span`, `span_stats`), recorded while a
    ``torch.profiler`` profile is recording;
  * :mod:`repro_torch.obs.flight` — the crash flight recorder, a ring of
    structured events dumped to JSON when a request fails.
"""

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (LATENCY_BUCKETS_MS, PULL_FRAC_BUCKETS,
                                     PULL_BUCKETS, Counter, Gauge, Histogram,
                                     MetricsRegistry, null_registry,
                                     summarize_latencies)
from repro_torch.obs.trace import SpanTracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "null_registry",
    "summarize_latencies", "LATENCY_BUCKETS_MS", "PULL_FRAC_BUCKETS",
    "PULL_BUCKETS", "SpanTracer", "FlightRecorder",
]
