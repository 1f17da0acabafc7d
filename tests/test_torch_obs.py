"""The port's obs package (spans, metrics, export) against the JAX
package's, on the CPU: the same operations render the same Prometheus
text; the same spans export the same Jaeger and Prometheus JSON; the
serving plane's ``GET /v1/spans`` parses through the port's own
``data/ingest`` Jaeger adapter; span context crosses the MicroBatcher's
worker thread.  Servers and batchers are stopped in a ``finally``.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from deeprest_tpu.obs import export as jax_export
from deeprest_tpu.obs import metrics as jax_metrics
from deeprest_tpu.obs.spans import SpanRecord as JaxSpanRecord
from deeprest_tpu_torch import obs
from deeprest_tpu_torch.data.ingest import (
    bucketize, jaeger_traces, prometheus_series,
)
from deeprest_tpu_torch.obs import export, metrics
from deeprest_tpu_torch.obs.spans import SpanRecord, SpanRecorder

TIMEOUT = 30


@pytest.fixture
def recorder_on():
    """Enable the process-default recorder for one test, restoring the
    disabled default afterwards."""
    prev = obs.RECORDER.enabled
    obs.RECORDER.clear()
    obs.RECORDER.enabled = True
    try:
        yield obs.RECORDER
    finally:
        obs.RECORDER.enabled = prev
        obs.RECORDER.clear()


def drive(mod):
    """The same operations on a fresh registry of package ``mod``."""
    reg = mod.MetricsRegistry()
    c = reg.counter("app_requests_total", "requests by route",
                    labelnames=("route", "code"))
    c.inc(route="/a", code="200")
    c.inc(2, route="/b", code="400")
    g = reg.gauge("app_depth", "queue depth")
    g.set(3)
    g.set_max(7.5)
    g.dec(0.25)
    h = reg.histogram("app_seconds", "latency", buckets=(0.1, 1.0),
                      labelnames=("route",))
    for v in (0.05, 0.5, 3.0):
        h.observe(v, route="/a")
    exposed = mod.Counter("plane_total", "a rebuilt plane's counter")
    exposed.inc(4)
    reg.expose(exposed)
    reg.register_collector("view", lambda sink: (
        sink.gauge("view_depth", 7, help="a render-time view"),
        sink.counter("view_total", 2.5, help="counted elsewhere",
                     labels={"kernel": "gru_fwd"})))
    reg.register_collector("boom", lambda sink: 1 / 0)
    return reg


def test_registry_render_equals_jax():
    got, want = drive(metrics).render(), drive(jax_metrics).render()
    assert got == want
    assert 'view_total{kernel="gru_fwd"} 2.5' in got
    assert "deeprest_collector_errors_total" in got
    assert metrics.PROMETHEUS_CONTENT_TYPE == \
        jax_metrics.PROMETHEUS_CONTENT_TYPE


def test_metric_semantics_equal_jax():
    for mod in (metrics, jax_metrics):
        c = mod.Counter("c_total")
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):
            c.inc(tenant="x")
        reg = mod.MetricsRegistry()
        reg.counter("m_total")
        with pytest.raises(ValueError):
            reg.gauge("m_total")
    sw = metrics.Stopwatch()
    time.sleep(0.01)
    assert 0.005 < sw.elapsed() < 5.0


def records(cls):
    return [cls(trace_id="t1", span_id="s1", parent_id=None,
                name="/v1/predict", component="deeprest-predictor",
                start_s=1.0, duration_s=0.5, tags={"tenant": "default"}),
            cls(trace_id="t1", span_id="s2", parent_id="s1",
                name="batch.dispatch", component="deeprest-batcher",
                start_s=1.1, duration_s=0.25, tags={"requests": 2}),
            cls(trace_id="t2", span_id="s3", parent_id=None,
                name="/v1/whatif", component="deeprest-predictor",
                start_s=2.0, duration_s=0.125, tags={})]


def test_export_equals_jax():
    assert export.spans_to_jaeger(records(SpanRecord)) == \
        jax_export.spans_to_jaeger(records(JaxSpanRecord))
    assert export.spans_to_prometheus(records(SpanRecord)) == \
        jax_export.spans_to_prometheus(records(JaxSpanRecord))
    buckets = export.self_corpus(records(SpanRecord), bucket_s=1.0)
    assert buckets and buckets[0].traces


def test_recorder_nests_and_configure_is_in_place():
    rec = SpanRecorder(capacity=4, enabled=True)
    with rec.span("outer", component="a") as outer:
        outer.tag(k=1)
        with rec.span("inner", component="b"):
            pass
    inner, top = sorted(rec.snapshot(), key=lambda s: s.parent_id is None)
    assert inner.parent_id == top.span_id and inner.trace_id == top.trace_id
    assert top.tags == {"k": 1}
    prev = (obs.RECORDER.enabled, obs.RECORDER.capacity)
    try:
        obs.configure(enabled=True, span_capacity=16)
        assert obs.RECORDER.enabled and obs.RECORDER.capacity == 16
    finally:
        obs.configure(enabled=prev[0], span_capacity=prev[1])
    assert obs.span("x") is obs.NULL_SPAN or obs.RECORDER.enabled


def test_batcher_span_parents_on_the_submitter(recorder_on):
    from deeprest_tpu_torch.serve.batcher import (
        BatcherConfig, MicroBatcher, ShapeLadder,
    )
    import torch

    mb = MicroBatcher(ShapeLadder(lambda x: torch.zeros((len(x), 4, 2, 3)),
                                  (4,)), BatcherConfig(max_batch=4))
    try:
        with obs.span("/v1/predict", component="deeprest-predictor"):
            mb.apply(np.zeros((2, 4, 5), np.float32))
    finally:
        mb.close()
    spans = recorder_on.snapshot()
    root = next(s for s in spans if s.name == "/v1/predict")
    batch = next(s for s in spans if s.name == "batch.dispatch")
    assert batch.trace_id == root.trace_id and batch.parent_id == root.span_id
    assert batch.tags["requests"] == 1 and batch.tags["windows"] == 2


def test_spans_route_parses_through_the_ports_ingest(recorder_on):
    from test_torch_batcher import make_predictor

    from deeprest_tpu_torch.serve.batcher import BatcherConfig
    from deeprest_tpu_torch.serve.server import (
        PredictionServer, PredictionService,
    )

    pred = make_predictor((8,))
    server = PredictionServer(PredictionService(pred), port=0,
                              batching=BatcherConfig())
    server.start()
    try:
        base = "http://%s:%d" % server.address
        traffic = np.random.default_rng(0).random((3 * 8 + 2, 6))
        for path in ("/v1/predict", "/v1/predict"):
            req = urllib.request.Request(
                base + path, json.dumps({"traffic": traffic.tolist()}
                                        ).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                assert resp.status == 200
        deadline = time.monotonic() + TIMEOUT
        payload = {"data": []}
        while time.monotonic() < deadline and sum(
                len(t["spans"]) for t in payload["data"]) < 4:
            # the root span commits after the reply is written, and the
            # batch span on the batcher's worker, in either order
            with urllib.request.urlopen(base + "/v1/spans",
                                        timeout=TIMEOUT) as resp:
                payload = json.loads(resp.read())
            time.sleep(0.05)
        with urllib.request.urlopen(base + "/healthz",
                                    timeout=TIMEOUT) as resp:
            health = json.loads(resp.read())
        assert health["obs"]["enabled"] is True
    finally:
        server.stop()
    trees = jaeger_traces(payload)
    assert len(trees) == 2
    for _, root in trees:
        assert (root.component, root.operation) == ("deeprest-predictor",
                                                    "/v1/predict")
        assert [c.component for c in root.children] == ["deeprest-batcher"]
    samples = prometheus_series(export.spans_to_prometheus(
        recorder_on.snapshot()))
    assert bucketize(trees, samples, 1.0)
    assert threading.active_count() < 50
