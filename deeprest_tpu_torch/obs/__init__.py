"""Spans and metrics for the serving plane (``deeprest_tpu/obs``, less the
profiler, which waits for a later slice).

- :mod:`.spans`: the ring-buffer span recorder with request-scoped trace
  ids propagated server → batcher → fused dispatch; near-zero cost when
  disabled.
- :mod:`.metrics`: counters, gauges and histograms rendered as Prometheus
  text at ``GET /metrics``.
- :mod:`.export`: spans as Jaeger-style JSON and span-derived busy-seconds
  as Prometheus range JSON, both read by the port's ``data/ingest.py``.

Nothing here imports torch; the modules are stdlib-only copies of the JAX
package's.
"""

from __future__ import annotations

from deeprest_tpu_torch.obs.metrics import (
    PROMETHEUS_CONTENT_TYPE, REGISTRY, Counter, Gauge, Histogram,
    MetricsRegistry, Stopwatch,
)
from deeprest_tpu_torch.obs.spans import (
    NULL_SPAN, RECORDER, SpanRecord, SpanRecorder, current_context,
    set_context, span,
)


def configure(enabled: bool | None = None,
              span_capacity: int | None = None) -> None:
    """Flip the process-default span recorder (the serve CLI's ``--no-obs``
    and ``--obs-span-capacity``).  Metrics counters are always live, so
    only span recording is gated.  The recorder is reconfigured in place:
    every module already holding the reference keeps recording into the
    same object."""
    if span_capacity is not None and span_capacity != RECORDER.capacity:
        RECORDER.set_capacity(span_capacity)
    if enabled is not None:
        RECORDER.enabled = bool(enabled)


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Stopwatch",
    "REGISTRY", "PROMETHEUS_CONTENT_TYPE",
    "SpanRecord", "SpanRecorder", "RECORDER", "NULL_SPAN",
    "span", "current_context", "set_context", "configure",
]
