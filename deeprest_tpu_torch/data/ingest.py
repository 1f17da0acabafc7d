"""Ingestion adapters: real telemetry systems → the raw-data contract
(``deeprest_tpu/data/ingest.py``, whole).

The reference's input contract is "Jaeger span trees + Prometheus metrics
from an instrumented cluster" (reference: resource-estimation/README.md:29-63
— "the tracing tool (e.g., Jaeger)" / "the monitoring tool (e.g.,
Prometheus)"; tracer wiring social-network-source/src/tracing.h:52-61;
Jaeger deployment social-network-deploy/k8s-yaml/tracing/run.yaml; scrape
configs minikube-openebs/monitor-openebs-pg.yaml:38-173), but its repo ships
no converter — the pickle appears fully formed.  This module is that
converter: it turns

- Jaeger query-API JSON (``GET /api/traces?...`` → ``{"data": [...]}``),
- OTLP/JSON trace exports (``{"resourceSpans": [...]}``), and
- Prometheus range-query JSON (``/api/v1/query_range`` → ``resultType:
  "matrix"``)

into :class:`~deeprest_tpu_torch.data.schema.Bucket` lists that featurize
identically to the framework's own collector JSONL, so the estimator can be
pointed at ANY instrumented cluster with zero custom collection code.

Discretization follows the reference: the bucket width is the monitoring
scrape interval ("a window size ... defined as the scrape interval in the
resource monitoring tool", README.md:29; the reference cluster scrapes at
5 s, monitor-openebs-pg.yaml:38), traces land in the bucket of their root
span's start time, and counter-style metrics contribute per-bucket
increases while gauges contribute per-bucket means.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from deeprest_tpu_torch.data.schema import Bucket, MetricSample, Span

# ---------------------------------------------------------------------------
# shared span-tree assembly
# ---------------------------------------------------------------------------


def _assemble_trees(
    records: Sequence[tuple[str, str | None, float, str, str]],
) -> list[tuple[float, Span]]:
    """Link ``(span_id, parent_id, start_seconds, component, operation)``
    records into rooted trees.

    Shared by the Jaeger and OTLP adapters (same algorithm, different wire
    fields): children are ordered by start time — the invocation ordering
    the span tree encodes (reference: resource-estimation/README.md:49-55)
    — and a span whose parent is absent from the dump becomes a root
    (partial captures must surface, not vanish).  Returns (root start
    seconds, tree) in root start order.
    """
    nodes: dict[str, Span] = {}
    start: dict[str, float] = {}
    parent: dict[str, str | None] = {}
    for sid, pid, ts, component, operation in records:
        nodes[sid] = Span(component=component, operation=operation)
        start[sid] = ts
        parent[sid] = pid
    pending: dict[str, list[tuple[float, Span]]] = {}
    for sid, node in nodes.items():
        pid = parent[sid]
        if pid is not None and pid in nodes:
            pending.setdefault(pid, []).append((start[sid], node))
    for pid, kids in pending.items():
        nodes[pid].children = [c for _, c in sorted(kids, key=lambda p: p[0])]
    roots = [sid for sid in nodes
             if parent[sid] is None or parent[sid] not in nodes]
    return [(start[sid], nodes[sid])
            for sid in sorted(roots, key=lambda s: start[s])]


# ---------------------------------------------------------------------------
# Jaeger query-API JSON → (root start-time, span tree)
# ---------------------------------------------------------------------------


def jaeger_traces(payload: Mapping[str, Any]) -> list[tuple[float, Span]]:
    """Convert a Jaeger query-API response into rooted span trees.

    Accepts the ``{"data": [trace, ...]}`` envelope or a bare trace list.
    Each Jaeger trace contributes one (start_time_seconds, tree) per root
    span (spans with no CHILD_OF reference, or whose parent is missing
    from the dump — Jaeger emits such orphans for partial captures).
    """
    traces = payload.get("data", payload) if isinstance(payload, Mapping) \
        else payload
    out: list[tuple[float, Span]] = []
    for trace in traces:
        procs = {
            pid: (proc.get("serviceName") or pid)
            for pid, proc in (trace.get("processes") or {}).items()
        }
        records = []
        for s in trace.get("spans") or []:
            pid = None
            for ref in s.get("references") or []:
                if ref.get("refType") == "CHILD_OF":
                    pid = ref.get("spanID")
                    break
            records.append((
                s["spanID"], pid, int(s.get("startTime", 0)) / 1e6,
                str(procs.get(s.get("processID"), s.get("processID", "?"))),
                str(s.get("operationName", "?")),
            ))
        out.extend(_assemble_trees(records))
    return out


# ---------------------------------------------------------------------------
# OTLP/JSON trace export → (root start-time, span tree)
# ---------------------------------------------------------------------------


def otlp_traces(payload: Mapping[str, Any]) -> list[tuple[float, Span]]:
    """Convert an OTLP/JSON trace export (``{"resourceSpans": [...]}``)
    into rooted span trees.  The component is the resource's
    ``service.name`` attribute — the same identity the reference's tracer
    registers per service (reference: social-network-source/src/
    tracing.h:52-61).  Spans are linked by (traceId, parentSpanId) across
    resource boundaries, so a cross-service trace assembles into one tree.
    """
    records: list[dict] = []
    for rs in payload.get("resourceSpans") or []:
        service = "?"
        for attr in ((rs.get("resource") or {}).get("attributes") or []):
            if attr.get("key") == "service.name":
                service = str((attr.get("value") or {}).get("stringValue",
                                                            service))
        for ss in rs.get("scopeSpans") or rs.get("instrumentationLibrarySpans") or []:
            for s in ss.get("spans") or []:
                records.append({
                    "trace": s.get("traceId"),
                    "id": s.get("spanId"),
                    "parent": s.get("parentSpanId") or None,
                    "service": service,
                    "op": str(s.get("name", "?")),
                    "start_ns": int(s.get("startTimeUnixNano", 0)),
                })
    by_trace: dict[str, list[dict]] = {}
    for r in records:
        by_trace.setdefault(r["trace"], []).append(r)
    out: list[tuple[float, Span]] = []
    for spans in by_trace.values():
        out.extend(_assemble_trees([
            (r["id"], r["parent"], r["start_ns"] / 1e9, r["service"], r["op"])
            for r in spans
        ]))
    return out


# ---------------------------------------------------------------------------
# Prometheus range-query JSON → (timestamp, component, resource, value)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MetricRule:
    """How one Prometheus metric becomes a raw-data resource series.

    ``mode='gauge'``: the bucket value is the mean of samples in the
    window (memory bytes, fs usage).  ``mode='counter'``: the bucket value
    is the within-bucket increase of a cumulative counter (cpu seconds,
    write counts), reset-tolerant (a decrease restarts from the new
    value).  These are the two shapes every metric in the reference's
    scrape set has (cadvisor + OpenEBS volume exporters,
    minikube-openebs/monitor-openebs-pg.yaml:60-173).
    """

    resource: str
    mode: str = "gauge"  # 'gauge' | 'counter'


# cadvisor-style defaults covering the reference's five resources
# (cpu / memory / write-iops / write-throughput / usage — SURVEY.md §L2).
DEFAULT_RESOURCE_MAP: dict[str, MetricRule] = {
    "container_cpu_usage_seconds_total": MetricRule("cpu", "counter"),
    "container_memory_working_set_bytes": MetricRule("memory", "gauge"),
    "container_fs_writes_total": MetricRule("wiops", "counter"),
    "container_fs_writes_bytes_total": MetricRule("wtp", "counter"),
    "container_fs_usage_bytes": MetricRule("usage", "gauge"),
}

# Component-identity labels, first match wins.  kubernetes_pod_name is the
# reference's own relabel target (monitor-openebs-pg.yaml:55-57,142-143).
COMPONENT_LABELS = ("kubernetes_pod_name", "pod", "container_label_io_kubernetes_pod_name",
                    "container", "instance", "job")


def prometheus_series(
    payload: Mapping[str, Any],
    resource_map: Mapping[str, MetricRule] | None = None,
    component_labels: Sequence[str] = COMPONENT_LABELS,
) -> list[tuple[float, str, str, float, str, str]]:
    """Flatten a ``query_range`` matrix response into
    ``(ts_seconds, component, resource, value, mode, series_id)`` samples.

    Series whose ``__name__`` has no entry in ``resource_map`` are skipped
    (a range query scoped to one metric has no such series; a federated
    dump may).  The component is the first present label from
    ``component_labels``.  ``series_id`` is the full label set: several
    Prometheus series can share one (component, resource) key — a
    multi-container pod has one cumulative cpu counter PER container —
    and counter increases are only meaningful within ONE series
    (interleaving two counters looks like resets and giant jumps), so
    bucketize aggregates per series first, then sums across series.
    """
    rmap = DEFAULT_RESOURCE_MAP if resource_map is None else resource_map
    data = payload.get("data", payload)
    out: list[tuple[float, str, str, float, str, str]] = []
    for series in data.get("result") or []:
        labels = series.get("metric") or {}
        rule = rmap.get(labels.get("__name__", ""))
        if rule is None:
            continue
        component = next((labels[l] for l in component_labels if l in labels),
                        None)
        if component is None:
            continue
        sid = json.dumps(sorted(labels.items()))
        for ts, val in series.get("values") or ([series["value"]]
                                                if "value" in series else []):
            try:
                v = float(val)
            except (TypeError, ValueError):
                continue
            if math.isnan(v):
                continue
            out.append((float(ts), str(component), rule.resource, v,
                        rule.mode, sid))
    return out


# ---------------------------------------------------------------------------
# discretization onto the common bucket timeline
# ---------------------------------------------------------------------------


def bucketize(
    traces: Iterable[tuple[float, Span]],
    samples: Iterable[tuple[float, str, str, float, str] |
                      tuple[float, str, str, float, str, str]],
    bucket_s: float,
    t0: float | None = None,
    t1: float | None = None,
) -> list[Bucket]:
    """Discretize traces + metric samples into the ordered bucket list the
    estimator consumes (reference: resource-estimation/README.md:29-34 —
    one item per scrape window).

    Every bucket carries the full (component, resource) keyset observed
    anywhere in the range, zero-filled when silent, so the metric-series
    matrix is rectangular — the property featurization requires.

    Aggregation is PER SERIES first (the optional 6th sample element; a
    multi-container pod has one cumulative counter per container, and
    interleaving two counters would read as resets and giant jumps), then
    summed across the key's series: counters sum their per-bucket
    increases, gauges sum their per-bucket means (a pod's memory is the
    sum of its containers').
    """
    traces = list(traces)
    samples = list(samples)
    if bucket_s <= 0:
        raise ValueError(f"bucket_s must be positive, got {bucket_s}")
    times = [t for t, _ in traces] + [s[0] for s in samples]
    if not times:
        return []
    lo = min(times) if t0 is None else t0
    hi = max(times) if t1 is None else t1
    lo = math.floor(lo / bucket_s) * bucket_s
    n = max(1, int(math.ceil((hi - lo) / bucket_s + 1e-9)) or 1)
    if hi >= lo + n * bucket_s:
        n += 1

    def idx(ts: float) -> int | None:
        i = int((ts - lo) // bucket_s)
        return i if 0 <= i < n else None

    trace_buckets: list[list[Span]] = [[] for _ in range(n)]
    for ts, root in traces:
        i = idx(ts)
        if i is not None:
            trace_buckets[i].append(root)

    # Vectorized grid placement: one numpy pass computes every sample's
    # bucket cell with the same floor semantics as the scalar
    # ``int((ts - lo) // bucket_s)`` (np.floor matches // for negatives).
    cells = np.empty((0,), np.int64)
    if samples:
        ts_all = np.fromiter((s[0] for s in samples), dtype=np.float64,
                             count=len(samples))
        cells = np.floor((ts_all - lo) / bucket_s).astype(np.int64)

    # (component, resource, series) → per-bucket accumulators.  Gauges
    # collect (cell, value) pairs and reduce with np.add.at/bincount below
    # — same f64 accumulation in the same sample order as the historical
    # scalar loop, so results are bit-identical; counters keep the
    # sequential reset-tolerant walk (inherently order-dependent).
    SKey = tuple  # (comp, res, series_id)
    gauge_pts: dict[SKey, list[tuple[int, float]]] = {}
    counter_vals: dict[SKey, list[list[tuple[float, float]]]] = {}
    modes: dict[SKey, str] = {}
    for k, sample in enumerate(samples):
        i = int(cells[k])
        if not 0 <= i < n:
            continue
        ts, comp, res, val, mode = sample[:5]
        sid = sample[5] if len(sample) > 5 else ""
        skey = (comp, res, sid)
        modes[skey] = mode
        if mode == "counter":
            counter_vals.setdefault(skey, [[] for _ in range(n)])[i].append(
                (ts, val))
        else:
            gauge_pts.setdefault(skey, []).append((i, val))

    values: dict[tuple[str, str], list[float]] = {}
    for skey, mode in modes.items():
        if mode == "counter":
            per = counter_vals[skey]
            vals = [0.0] * n
            prev_last: float | None = None
            for i in range(n):
                pts = sorted(per[i])
                inc = 0.0
                last = prev_last
                for _, v in pts:
                    if last is None:
                        last = v
                        continue
                    # reset-tolerant increase (counter restarted below its
                    # previous value): count growth from the new base.
                    inc += v - last if v >= last else v
                    last = v
                vals[i] = inc
                prev_last = last if last is not None else prev_last
        else:
            pts = gauge_pts[skey]
            cell_idx = np.fromiter((p[0] for p in pts), np.int64, len(pts))
            pt_vals = np.fromiter((p[1] for p in pts), np.float64, len(pts))
            sums = np.zeros((n,), np.float64)
            np.add.at(sums, cell_idx, pt_vals)
            cnts = np.bincount(cell_idx, minlength=n)
            vals = np.where(cnts > 0, sums / np.maximum(cnts, 1), 0.0).tolist()
        key = (skey[0], skey[1])
        acc = values.setdefault(key, [0.0] * n)
        for i in range(n):
            acc[i] += vals[i]

    keys = sorted(values)
    buckets = []
    for i in range(n):
        metrics = [MetricSample(component=c, resource=r,
                                value=values[(c, r)][i])
                   for c, r in keys]
        buckets.append(Bucket(metrics=metrics, traces=trace_buckets[i]))
    return buckets


# ---------------------------------------------------------------------------
# live-endpoint pull (Jaeger query API + Prometheus HTTP API)
# ---------------------------------------------------------------------------
#
# The reference deploys LIVE Jaeger and Prometheus services
# (social-network-deploy/k8s-yaml/tracing/run.yaml:1-18;
# minikube-openebs/monitor-openebs-pg.yaml:38-173) — file dumps were the
# hand-carried stopgap.  These pullers speak the same HTTP APIs those
# deployments expose, with time-range pagination, feeding the same
# ``bucketize``; stdlib urllib only (no client-library dependency).


def _http_get_json(url: str, timeout_s: float = 30.0):
    import urllib.request

    req = urllib.request.Request(url, headers={"Accept": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def pull_jaeger(
    base_url: str,
    start_s: float,
    end_s: float,
    services: Sequence[str] | None = None,
    limit: int = 1000,
    timeout_s: float = 30.0,
    min_slice_s: float = 1.0,
    fetch=_http_get_json,
) -> list[tuple[float, Span]]:
    """Pull span trees from a live Jaeger query API over ``[start_s, end_s)``.

    Jaeger's HTTP API (``GET /api/traces?service=..&start=..&end=..``,
    microsecond timestamps) has no result cursor — only ``limit``.
    Pagination is therefore TIME-SLICING: when a slice returns ``limit``
    traces (the truncation signal), it is split in half and both halves
    re-queried, down to ``min_slice_s`` (below that the slice is accepted
    with a warning — better a bounded loss surfaced than an unbounded
    recursion).  ``services=None`` discovers the service list from
    ``/api/services``.  Traces are deduplicated by traceID across slices
    and services (a trace spanning services returns for each).
    """
    base = base_url.rstrip("/")
    if services is None:
        payload = fetch(f"{base}/api/services", timeout_s)
        services = [str(s) for s in (payload.get("data") or [])]
    from urllib.parse import urlencode

    seen: set[str] = set()
    out: list[tuple[float, Span]] = []
    for service in services:
        slices = [(start_s, end_s)]
        while slices:
            lo, hi = slices.pop()
            if hi <= lo:
                continue
            q = urlencode({"service": service, "start": int(lo * 1e6),
                           "end": int(hi * 1e6), "limit": limit})
            payload = fetch(f"{base}/api/traces?{q}", timeout_s)
            traces = payload.get("data") or []
            if len(traces) >= limit and (hi - lo) > min_slice_s:
                mid = (lo + hi) / 2.0
                slices += [(lo, mid), (mid, hi)]
                continue
            if len(traces) >= limit:
                import warnings

                warnings.warn(
                    f"jaeger slice [{lo}, {hi}) for {service!r} still hits "
                    f"limit={limit} at the {min_slice_s}s floor — some "
                    f"traces in this slice are not retrievable")
            fresh = [t for t in traces
                     if t.get("traceID") not in seen]
            for t in fresh:
                tid = t.get("traceID")
                if tid is not None:
                    seen.add(tid)
            out.extend(jaeger_traces(fresh))
    out.sort(key=lambda p: p[0])
    return out


def pull_prometheus(
    base_url: str,
    start_s: float,
    end_s: float,
    step_s: float,
    resource_map: Mapping[str, MetricRule] | None = None,
    timeout_s: float = 30.0,
    max_points: int = 10_000,
    fetch=_http_get_json,
) -> list[tuple[float, str, str, float, str, str]]:
    """Pull metric samples from a live Prometheus over ``[start_s, end_s]``.

    One ``/api/v1/query_range`` per metric in ``resource_map``, chunked so
    each request stays under ``max_points`` samples per series (Prometheus
    rejects ranges over ~11k points).  Chunk boundaries are inclusive on
    both ends, so boundary samples are deduplicated by (series, ts).
    """
    from urllib.parse import urlencode

    base = base_url.rstrip("/")
    rmap = DEFAULT_RESOURCE_MAP if resource_map is None else resource_map
    if step_s <= 0:
        raise ValueError(f"step_s must be positive, got {step_s}")
    span = max_points * step_s
    dedup: dict[tuple[str, float, str], tuple] = {}
    for metric in rmap:
        lo = start_s
        while True:
            hi = min(lo + span, end_s)
            q = urlencode({"query": metric, "start": lo, "end": hi,
                           "step": step_s})
            payload = fetch(f"{base}/api/v1/query_range?{q}", timeout_s)
            for s in prometheus_series(payload, resource_map=rmap):
                dedup[(s[5], s[0], s[2])] = s
            if hi >= end_s:
                break
            # Chunks OVERLAP at the boundary instant (the dedup key
            # absorbs the duplicate) — advancing past ``hi`` would skip
            # samples between evaluations.
            lo = hi
    return sorted(dedup.values(), key=lambda s: s[0])


def ingest_live(
    jaeger_url: str | None,
    prom_url: str | None,
    start_s: float,
    end_s: float,
    bucket_s: float,
    step_s: float | None = None,
    resource_map: Mapping[str, MetricRule] | None = None,
    services: Sequence[str] | None = None,
    timeout_s: float = 30.0,
    fetch=_http_get_json,
) -> list[Bucket]:
    """Pull ``[start_s, end_s)`` from live Jaeger/Prometheus endpoints and
    discretize into the ordered bucket list (``bucketize``).  ``step_s``
    defaults to the bucket width — the scrape-interval-as-bucket contract
    (reference: resource-estimation/README.md:29)."""
    traces = (pull_jaeger(jaeger_url, start_s, end_s, services=services,
                          timeout_s=timeout_s, fetch=fetch)
              if jaeger_url else [])
    samples = (pull_prometheus(prom_url, start_s, end_s,
                               step_s if step_s is not None else bucket_s,
                               resource_map=resource_map,
                               timeout_s=timeout_s, fetch=fetch)
               if prom_url else [])
    if not traces and not samples:
        return []
    # t1 a fraction of a bucket inside the end so an exactly-aligned range
    # keeps [start, end) semantics instead of growing a trailing empty
    # bucket.  The margin is bucket-relative (not absolute 1e-9: epoch
    # timestamps have float ulp ~2.4e-7, which would swallow it); sample
    # placement is unaffected — only the range arithmetic sees t1.
    return bucketize(traces, samples, bucket_s, t0=start_s,
                     t1=max(start_s, end_s - 1e-3 * bucket_s))


class LiveEndpointTailer:
    """A ``BucketTailer``-protocol source polling live Jaeger/Prometheus.

    Each ``poll()`` pulls the closed bucket range since the previous poll
    (aligned down to whole buckets, ``lag_s`` behind the clock so
    scrape/collection stragglers land before their bucket is read) and
    returns it as Buckets — plugging a live cluster straight into
    ``StreamingTrainer.run`` with no hand-carried dumps.

    A successful pull that yields NO data for its range emits zero-filled
    buckets for the skipped grid cells (a quiet cluster, or series gone
    stale) rather than silently advancing past them: downstream windowing
    treats consecutive list entries as time-adjacent, and a counter
    increase across a silent gap must not collapse into one bucket.

    Failures escalate instead of retrying forever: DETERMINISTIC errors
    (bad URL, HTTP 4xx like 404/auth) raise after
    ``max_deterministic_failures`` consecutive occurrences — a stream
    that can never succeed must not look healthy while ingesting nothing.
    Transient errors (timeouts, connection resets, 5xx) keep retrying the
    same range but set ``degraded`` after ``max_transient_failures`` in a
    row so operators can see the outage; any success clears both.
    """

    backlog = False     # the pull is always caught up to now - lag

    def __init__(self, jaeger_url: str | None = None,
                 prom_url: str | None = None, bucket_s: float = 5.0,
                 step_s: float | None = None,
                 resource_map: Mapping[str, MetricRule] | None = None,
                 services: Sequence[str] | None = None,
                 lag_s: float | None = None, timeout_s: float = 30.0,
                 max_deterministic_failures: int = 3,
                 max_transient_failures: int = 8,
                 now=None, fetch=_http_get_json):
        if not jaeger_url and not prom_url:
            raise ValueError("need at least one of jaeger_url/prom_url")
        import time as _time

        self.jaeger_url = jaeger_url
        self.prom_url = prom_url
        self.bucket_s = bucket_s
        self.step_s = step_s
        self.resource_map = resource_map
        self.services = services
        self.lag_s = 2 * bucket_s if lag_s is None else lag_s
        self.timeout_s = timeout_s
        self.max_deterministic_failures = max_deterministic_failures
        self.max_transient_failures = max_transient_failures
        self.consecutive_failures = 0
        self._deterministic_failures = 0
        self.degraded = False
        self._now = now if now is not None else _time.time
        self._fetch = fetch
        # Start at the previous whole bucket so the first poll returns at
        # most one bucket instead of an unbounded history backfill.
        self._cursor = (math.floor((self._now() - self.lag_s) / bucket_s)
                        * bucket_s)

    # -- ingest-watermark convention (shared with the wire receiver in
    # -- data/wire.py; train/stream.py persists it in the checkpoint
    # -- sidecar and hands it back on resume) ---------------------------

    def ingest_watermark(self) -> dict:
        """This source's resume cursor: the bucket-aligned instant up to
        which every poll result has been handed to the stream."""
        return {"kind": "time_cursor", "position": float(self._cursor)}

    def resume_from(self, wm: dict) -> None:
        """Adopt a persisted cursor so a restarted stream re-polls the
        gap since its last checkpoint exactly once — no bucket skipped,
        none double-counted.  Foreign/malformed dialects are ignored
        (the fresh now-lag cursor stands)."""
        if not isinstance(wm, dict) or wm.get("kind") != "time_cursor":
            return
        try:
            pos = float(wm["position"])
        except (KeyError, TypeError, ValueError):
            return
        if pos > 0:
            # re-align defensively: a cursor off the bucket grid would
            # shift every subsequent bucket boundary
            self._cursor = math.floor(pos / self.bucket_s) * self.bucket_s

    def _note_failure(self, exc: Exception) -> None:
        import urllib.error

        self.consecutive_failures += 1
        # HTTPError before ValueError cannot overlap (HTTPError is an
        # OSError); 4xx minus 429 is deterministic — the same request will
        # fail the same way (wrong path, missing series endpoint, auth) —
        # while 5xx/429 and transport errors are worth retrying.
        deterministic = (
            isinstance(exc, urllib.error.HTTPError)
            and 400 <= exc.code < 500 and exc.code != 429
        ) or (isinstance(exc, (ValueError, TypeError))
              and not isinstance(exc, urllib.error.URLError))
        if deterministic:
            self._deterministic_failures += 1
            if self._deterministic_failures >= self.max_deterministic_failures:
                raise RuntimeError(
                    f"live ingest: {self._deterministic_failures} consecutive "
                    f"deterministic failures (last: {exc!r}) — the endpoint "
                    "configuration is wrong; retrying cannot succeed"
                ) from exc
        else:
            self._deterministic_failures = 0
        if (not self.degraded
                and self.consecutive_failures >= self.max_transient_failures):
            self.degraded = True
            print(f"live ingest: DEGRADED — {self.consecutive_failures} "
                  f"consecutive pull failures (last: {exc!r})")
        print(f"live ingest: pull failed ({exc}); will retry")

    def poll(self) -> list[Bucket]:
        edge = (math.floor((self._now() - self.lag_s) / self.bucket_s)
                * self.bucket_s)
        if edge <= self._cursor:
            return []
        try:
            # Pull ONE lead-in bucket before the cursor and drop it: a
            # counter's per-bucket increase needs a base sample BEFORE the
            # first reported bucket — without the lead-in, every poll's
            # first bucket (i.e. every bucket, at one-bucket-per-poll
            # cadence) would re-establish bases and stream counters as 0.
            buckets = ingest_live(
                self.jaeger_url, self.prom_url,
                self._cursor - self.bucket_s, edge,
                self.bucket_s, step_s=self.step_s,
                resource_map=self.resource_map, services=self.services,
                timeout_s=self.timeout_s, fetch=self._fetch)[1:]
        except Exception as exc:   # blip: retry the SAME range (bounded)
            self._note_failure(exc)
            return []
        self.consecutive_failures = 0
        self._deterministic_failures = 0
        self.degraded = False
        cells = int(round((edge - self._cursor) / self.bucket_s))
        if len(buckets) < cells:
            # bucketize zero-fills interior grid cells whenever ANY data
            # exists in the range, so a short return means the whole range
            # was silent: keep the bucket stream's continuous cadence with
            # explicitly empty buckets (and a log line for operators).
            missing = cells - len(buckets)
            print(f"live ingest: no data for {missing} of {cells} bucket(s) "
                  f"in [{self._cursor:.0f}, {edge:.0f}); zero-filling")
            buckets = buckets + [Bucket() for _ in range(missing)]
        self._cursor = edge
        return buckets

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# file-level convenience (the CLI's ingest surface)
# ---------------------------------------------------------------------------


def ingest_files(
    trace_paths: Sequence[str],
    prom_paths: Sequence[str],
    bucket_s: float,
    resource_map: Mapping[str, MetricRule] | None = None,
) -> list[Bucket]:
    """Load Jaeger/OTLP trace dumps + Prometheus range dumps and produce
    the ordered bucket list.  Format auto-detection: a payload with
    ``resourceSpans`` is OTLP, otherwise Jaeger query JSON; metric files
    must be query_range responses."""
    traces: list[tuple[float, Span]] = []
    for path in trace_paths:
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        if isinstance(payload, Mapping) and "resourceSpans" in payload:
            traces.extend(otlp_traces(payload))
        else:
            traces.extend(jaeger_traces(payload))
    samples: list[tuple[float, str, str, float, str]] = []
    for path in prom_paths:
        with open(path, encoding="utf-8") as f:
            samples.extend(prometheus_series(json.load(f),
                                             resource_map=resource_map))
    return bucketize(traces, samples, bucket_s)
