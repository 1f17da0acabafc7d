"""The port's ingestion adapters against the JAX package's, on the CPU.

Jaeger, OTLP and Prometheus dumps, rendered from ``make_series_buckets``
as tests/test_ingest.py renders them, give the same buckets in both
packages (``to_dict()`` equality); so do counter-mode series, orphan spans
and one live pull from a stub HTTP server on 127.0.0.1.
"""

import importlib
import json

import pytest

from conftest import make_series_buckets
from deeprest_tpu.data import ingest as jax_ingest
from deeprest_tpu_torch.data import ingest
from test_ingest import (
    BUCKET_S, T0, _gauge_map, _render_jaeger, _render_prometheus,
    _StubCluster,
)


def as_dicts(buckets):
    return [b.to_dict() for b in buckets]


def port_rules(rules):
    return {k: ingest.MetricRule(r.resource, r.mode) for k, r in rules.items()}


def to_otlp(buckets):
    """The trees of ``buckets`` as one OTLP/JSON export, one resource per
    span, as tests/test_ingest.py renders it."""
    resource_spans, counter = [], [0]
    for i, bucket in enumerate(buckets):
        base_ns = int((T0 + i * BUCKET_S) * 1e9)
        for j, root in enumerate(bucket.traces):
            def emit(span, parent, trace_id=f"t{i}_{j}"):
                counter[0] += 1
                sid = f"s{counter[0]:06d}"
                resource_spans.append({
                    "resource": {"attributes": [
                        {"key": "service.name",
                         "value": {"stringValue": span.component}}]},
                    "scopeSpans": [{"spans": [{
                        "traceId": trace_id, "spanId": sid,
                        **({"parentSpanId": parent} if parent else {}),
                        "name": span.operation,
                        "startTimeUnixNano": base_ns + j * 1000_000
                        + counter[0] * 1000}]}]})
                for child in span.children:
                    emit(child, sid)

            emit(root, None)
    return {"resourceSpans": resource_spans}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    d = tmp_path_factory.mktemp("dumps")
    original = make_series_buckets(12, seed=6)
    paths = {"jaeger": d / "jaeger.json", "otlp": d / "otlp.json",
             "prom": d / "prom.json"}
    paths["jaeger"].write_text(json.dumps(_render_jaeger(original)))
    paths["otlp"].write_text(json.dumps(to_otlp(original)))
    paths["prom"].write_text(json.dumps(_render_prometheus(original)))
    return original, {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("traces", ["jaeger", "otlp"])
def test_ingest_files_matches_jax(dumps, traces):
    original, paths = dumps
    rules = _gauge_map(original)
    want = jax_ingest.ingest_files([paths[traces]], [paths["prom"]], BUCKET_S,
                                   resource_map=rules)
    got = ingest.ingest_files([paths[traces]], [paths["prom"]], BUCKET_S,
                              resource_map=port_rules(rules))
    assert len(got) == len(original) and as_dicts(got) == as_dicts(want)
    assert [[t.to_dict() for t in b.traces] for b in got] == \
        [[t.to_dict() for t in b.traces] for b in original]
    # the default cadvisor map knows none of these series: traces only
    bare = ingest.ingest_files([paths[traces]], [paths["prom"]], BUCKET_S)
    assert as_dicts(bare) == as_dicts(jax_ingest.ingest_files(
        [paths[traces]], [paths["prom"]], BUCKET_S))
    assert all(not b.metrics for b in bare)


def test_counter_mode_and_multi_series_match_jax():
    ts = [T0 + (i + 0.5) * BUCKET_S for i in range(5)]
    cum = [10.0, 13.0, 13.0, 2.0, 7.0]             # a reset at bucket 3
    samples = [(ts[i], "svc", "cpu", cum[i], "counter") for i in range(5)]
    for i in range(5):
        samples.append((ts[i], "pod", "cpu", 100.0 * i, "counter", "ctr-a"))
        samples.append((ts[i], "pod", "cpu", 5.0 * i, "counter", "ctr-b"))
        samples.append((ts[i] - 1.0, "pod", "memory", 3.0 + i, "gauge"))
    got = ingest.bucketize([], samples, BUCKET_S)
    assert as_dicts(got) == as_dicts(jax_ingest.bucketize([], samples,
                                                          BUCKET_S))
    svc = [b.metrics[-1].value for b in got]
    assert svc == pytest.approx([0.0, 3.0, 0.0, 2.0, 5.0])
    payload = {"data": {"result": [
        {"metric": {"__name__": "container_cpu_usage_seconds_total",
                    "kubernetes_pod_name": "compose-svc", "container": "a"},
         "values": [[T0, "1.5"], [T0 + 5, "4"]]},
        {"metric": {"__name__": "unrelated_metric", "pod": "x"},
         "values": [[T0, "9"]]},
        {"metric": {"__name__": "container_memory_working_set_bytes",
                    "pod": "store-db"},
         "values": [[T0, "NaN"], [T0 + 1, "2048"]]},
    ]}}
    assert ingest.prometheus_series(payload) == \
        jax_ingest.prometheus_series(payload)


def test_orphan_spans_become_roots_as_in_jax():
    payload = {"data": [{
        "traceID": "t",
        "processes": {"p1": {"serviceName": "gateway"},
                      "p2": {"serviceName": "db"}},
        "spans": [
            {"spanID": "a", "operationName": "/op", "processID": "p1",
             "startTime": 1_000, "references": [
                 {"refType": "CHILD_OF", "spanID": "missing"}]},
            {"spanID": "b", "operationName": "/q", "processID": "p2",
             "startTime": 1_500, "references": [
                 {"refType": "CHILD_OF", "spanID": "a"}]},
            {"spanID": "c", "operationName": "/r", "processID": "p9",
             "startTime": 900},
        ],
    }]}
    got = ingest.jaeger_traces(payload)
    want = jax_ingest.jaeger_traces(payload)
    assert [(t, s.to_dict()) for t, s in got] == \
        [(t, s.to_dict()) for t, s in want]
    assert [s.label for _, s in got] == ["p9_/r", "gateway_/op"]


def test_ingest_live_round_trip_matches_jax_and_the_dumps(tmp_path):
    buckets = make_series_buckets(6, seed=5)
    cluster = _StubCluster(_render_jaeger(buckets),
                           _render_prometheus(buckets))
    try:
        rules = _gauge_map(buckets)
        end = T0 + len(buckets) * BUCKET_S
        got = ingest.ingest_live(cluster.url, cluster.url, T0, end, BUCKET_S,
                                 resource_map=port_rules(rules))
        want = jax_ingest.ingest_live(cluster.url, cluster.url, T0, end,
                                      BUCKET_S, resource_map=rules)
        paged = ingest.pull_jaeger(cluster.url, T0, end, limit=2,
                                   min_slice_s=0.001)
    finally:
        cluster.close()
    assert len(got) == len(buckets) and as_dicts(got) == as_dicts(want)
    jp, pp = tmp_path / "j.json", tmp_path / "p.json"
    jp.write_text(json.dumps(_render_jaeger(buckets)))
    pp.write_text(json.dumps(_render_prometheus(buckets)))
    assert as_dicts(got) == as_dicts(ingest.ingest_files(
        [str(jp)], [str(pp)], BUCKET_S, resource_map=port_rules(rules)))
    assert len(paged) == sum(len(b.traces) for b in buckets)


def test_ingest_cli_writes_the_jax_cli_jsonl(dumps, tmp_path, capsys):
    _, paths = dumps
    lines = {}
    for name in ("deeprest_tpu", "deeprest_tpu_torch"):
        cli = importlib.import_module(f"{name}.cli")
        out = str(tmp_path / f"{name}.jsonl")
        assert cli.main(["ingest", "--traces", paths["jaeger"], "--prom",
                         paths["prom"], "--metric-map", "test_cpu:cpu",
                         "test_wiops:wiops:gauge", "--out", out]) == 0
        lines[name] = json.loads(capsys.readouterr().out.strip()
                                 .splitlines()[-1])
        lines[name].pop("out")
        assert cli.main(["ingest", "--metric-map", "x:y:z"]) == 2
    assert lines["deeprest_tpu_torch"] == lines["deeprest_tpu"]
    assert lines["deeprest_tpu"]["components"] == ["gateway", "store-db"]
    assert (tmp_path / "deeprest_tpu.jsonl").read_bytes() == \
        (tmp_path / "deeprest_tpu_torch.jsonl").read_bytes()
