"""Self-ingestion: the plane's own spans become a DeepRest corpus
(``deeprest_tpu/obs/export.py`` without ``push_self_corpus``, which needs
the span wire of a later slice).

The paper's loop is traces + utilization → model (PAPERS.md [1]).  This
module closes that loop on the estimator itself: the obs recorder's spans
export as (a) Jaeger query-API JSON — byte-compatible with what
``data/ingest.jaeger_traces`` already parses from a real Jaeger — and
(b) a Prometheus ``query_range`` matrix of span-derived cumulative
busy-seconds per component (a ``container_cpu_usage_seconds_total``-shaped
counter).  ``python -m deeprest_tpu_torch ingest --traces obs_spans.json
--prom obs_busy.json`` then bucketizes the plane's own traffic through the
STANDARD pipeline, and the standard featurizer accepts it
(tests/test_torch_obs.py feeds ``GET /v1/spans`` through the port's Jaeger
adapter).

Root spans carry the serving identity (component ``deeprest-predictor``,
operation ``/v1/predict`` …), so the synthesized endpoint vocabulary is
``deeprest-predictor_/v1/predict``, as in the JAX package.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

from deeprest_tpu_torch.obs.spans import SpanRecord

# The Prometheus metric name the busy-seconds export publishes under:
# cadvisor's cpu counter, so data/ingest.DEFAULT_RESOURCE_MAP maps it to
# the "cpu" resource with counter semantics out of the box.
BUSY_METRIC = "container_cpu_usage_seconds_total"


def spans_to_jaeger(spans: Iterable[SpanRecord]) -> dict:
    """Jaeger query-API payload (``{"data": [trace, ...]}``) grouping the
    records by trace id.  Field shapes follow what ``jaeger_traces``
    reads: spanID/references/startTime(µs)/duration(µs)/operationName,
    processes keyed per trace with serviceName = the span's component."""
    by_trace: dict[str, list[SpanRecord]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    data = []
    for trace_id in sorted(by_trace):
        records = sorted(by_trace[trace_id], key=lambda s: s.start_s)
        procs: dict[str, str] = {}          # component -> processID
        for s in records:
            procs.setdefault(s.component, f"p{len(procs) + 1}")
        spans_json = []
        for s in records:
            refs = ([] if s.parent_id is None else
                    [{"refType": "CHILD_OF", "traceID": trace_id,
                      "spanID": s.parent_id}])
            spans_json.append({
                "traceID": trace_id,
                "spanID": s.span_id,
                "operationName": s.name,
                "references": refs,
                "startTime": int(round(s.start_s * 1e6)),
                "duration": int(round(s.duration_s * 1e6)),
                "processID": procs[s.component],
                "tags": [{"key": k, "type": "string", "value": str(v)}
                         for k, v in sorted(s.tags.items())],
            })
        data.append({
            "traceID": trace_id,
            "spans": spans_json,
            "processes": {pid: {"serviceName": comp}
                          for comp, pid in procs.items()},
        })
    return {"data": data}


def spans_to_prometheus(spans: Iterable[SpanRecord],
                        metric: str = BUSY_METRIC) -> dict:
    """Span-derived busy-seconds as a Prometheus ``query_range`` matrix.

    Per component, a cumulative counter sampled at each span's END
    instant: value = running sum of span durations.  Bucketized with
    counter semantics this yields per-bucket busy seconds — the plane's
    own cpu-proxy utilization series, time-aligned with its traces.
    """
    ends: dict[str, list[tuple[float, float]]] = {}
    for s in spans:
        ends.setdefault(s.component, []).append(
            (s.start_s + s.duration_s, s.duration_s))
    result = []
    for comp in sorted(ends):
        cum = 0.0
        values = []
        for ts, dur in sorted(ends[comp]):
            cum += dur
            values.append([ts, repr(cum)])
        result.append({
            "metric": {"__name__": metric, "pod": comp},
            "values": values,
        })
    return {"status": "success",
            "data": {"resultType": "matrix", "result": result}}


def write_jaeger_json(spans: Sequence[SpanRecord], path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spans_to_jaeger(spans), f)
    return path


def write_prometheus_json(spans: Sequence[SpanRecord], path: str,
                          metric: str = BUSY_METRIC) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spans_to_prometheus(spans, metric=metric), f)
    return path


def self_corpus(spans: Sequence[SpanRecord], bucket_s: float):
    """In-memory convenience: spans → the ordered Bucket list, through
    the SAME adapters the file path uses (jaeger_traces +
    prometheus_series + bucketize — data/ingest.py)."""
    from deeprest_tpu_torch.data.ingest import (
        bucketize, jaeger_traces, prometheus_series,
    )

    return bucketize(jaeger_traces(spans_to_jaeger(spans)),
                     prometheus_series(spans_to_prometheus(spans)),
                     bucket_s)
