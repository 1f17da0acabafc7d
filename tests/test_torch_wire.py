"""The port's span wire (``deeprest_tpu_torch/data/wire.py``), live tailer
(``data/ingest.LiveEndpointTailer``) and self-ingestion push
(``obs/export.push_self_corpus``) against the JAX package's, on the CPU.

- Frames and BATCH payloads are byte-equal to JAX's.
- A JAX ``WireClient`` feeds a port receiver and a port client feeds a JAX
  receiver: the featurized rows equal the tailer path's (``extract_sparse``)
  bit for bit, bucket mode decodes value-equal buckets.
- Deferred commit gates the watermark and the ACKs; a restarted receiver
  handed the watermark dedups replayed frames; a malformed frame is counted
  once and announced.
- Wire-fed and tailer-fed port stream trainers (sparse feed, dropout 0)
  end bit-equal, in the serial and the overlapped loop, and the sidecar
  carries the wire watermark.
- ``LiveEndpointTailer`` against the stub Jaeger/Prometheus server of
  ``tests/test_ingest.py`` gives buckets equal to JAX's; counters keep
  their increments, silent ranges zero-fill, deterministic failures
  escalate, the watermark convention round-trips.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch
from conftest import make_series_buckets
from test_ingest import (
    BUCKET_S, T0, _gauge_map, _render_jaeger, _render_prometheus,
    _StubCluster,
)

from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.data import ingest as jax_ingest
from deeprest_tpu.data import wire as jw
from deeprest_tpu.data.featurize import CallPathSpace as JaxSpace
from deeprest_tpu.data.schema import save_raw_data_jsonl
from deeprest_tpu.workload import normal_scenario, simulate_corpus
from deeprest_tpu_torch.config import (
    Config, EtlConfig, FeaturizeConfig, ModelConfig, TrainConfig,
)
from deeprest_tpu_torch.data import ingest as port_ingest
from deeprest_tpu_torch.data import wire as pw
from deeprest_tpu_torch.data.featurize import CallPathSpace
from deeprest_tpu_torch.data.schema import Bucket
from deeprest_tpu_torch.train.checkpoint import load_sidecar
from deeprest_tpu_torch.train.stream import (
    BucketTailer, StreamConfig, StreamingTrainer,
)


@pytest.fixture(scope="module")
def corpus():
    scn = normal_scenario(3)
    scn.calls_per_user = 0.4
    return simulate_corpus(scn, 12)


def _port(buckets):
    return [Bucket.from_dict(b.to_dict()) for b in buckets]


def _space(pkg="port", capacity=512):
    if pkg == "port":
        return CallPathSpace(config=FeaturizeConfig(
            hash_features=True, capacity=capacity)).freeze()
    return JaxSpace(config=JaxFeaturizeConfig(
        hash_features=True, capacity=capacity)).freeze()


def _drain(rx, n_items, deadline_s=30.0):
    out = []
    deadline = time.monotonic() + deadline_s
    while len(out) < n_items:
        got = rx.poll()
        out.extend(got)
        if not got:
            assert time.monotonic() < deadline, f"{len(out)}/{n_items}"
            time.sleep(0.002)
    return out


def test_frames_and_payloads_byte_equal(corpus):
    for args in ((pw.F_BATCH, b"payload", 42, 3), (pw.F_HELLO, b"{}", 0, 0),
                 (pw.F_ACK, b"", 7, 0), (pw.F_BYE, b"", 0, 0)):
        assert pw.pack_frame(*args) == jw.pack_frame(*args)
    for b in corpus:
        want = jw.encode_bucket_payload(b)
        assert pw.encode_bucket_payload(Bucket.from_dict(b.to_dict())) == want
        assert pw.encode_bucket_payload(b.to_dict()) == want
    for name in ("MAGIC", "HEADER_SIZE", "MAX_FRAME_BYTES", "FLAG_JSONL",
                 "F_HELLO", "F_WELCOME", "F_BATCH", "F_ACK", "F_SLOWDOWN",
                 "F_DROPPED", "F_BYE"):
        assert getattr(pw, name) == getattr(jw, name), name
    for spec in ("0.0.0.0:7070", ":7070"):
        assert pw.parse_hostport(spec) == jw.parse_hostport(spec)
    for bad in ("7070", "host:", "host:abc", ""):
        with pytest.raises(ValueError):
            pw.parse_hostport(bad)


@pytest.mark.parametrize("direction", ["jax_client_to_port", "port_client_to_jax"])
def test_cross_package_push_featurizes_like_the_tailer(corpus, direction):
    if direction == "jax_client_to_port":
        rx_mod, client_mod, pkg, sent = pw, jw, "port", corpus
    else:
        rx_mod, client_mod, pkg, sent = jw, pw, "jax", _port(corpus)
    ref = _space("port")
    rx = rx_mod.SpanFirehoseReceiver("127.0.0.1", 0,
                                     space=_space(pkg)).start()
    try:
        t = threading.Thread(target=client_mod.push_corpus,
                             args=(rx.address, sent), daemon=True)
        t.start()
        items = _drain(rx, len(corpus))
        t.join(timeout=10)
        stats = rx.stats()
    finally:
        rx.close()
    for (row, metrics_row), b in zip(items, _port(corpus)):
        cols, vals = ref.extract_sparse(b.traces)
        np.testing.assert_array_equal(row[0], cols)
        np.testing.assert_array_equal(row[1], vals)
        assert metrics_row == {m.key: m.value for m in b.metrics}
    assert stats["batches"] == len(corpus) and stats["dropped"] == 0
    assert stats["spans"] == sum(1 for b in corpus
                                 for tr in b.traces for _ in tr.walk())


def test_bucket_mode_and_bulk_frame(corpus):
    rx = pw.SpanFirehoseReceiver("127.0.0.1", 0).start()
    try:
        t = threading.Thread(target=jw.push_corpus,
                             args=(rx.address, corpus[:3]), daemon=True)
        t.start()
        items = _drain(rx, 3)
        t.join(timeout=10)
    finally:
        rx.close()
    assert [b.to_dict() for b in items] == [b.to_dict() for b in corpus[:3]]
    assert all(isinstance(b, Bucket) for b in items)

    lines = [json.dumps(b.to_dict()).encode("utf-8") for b in corpus[:5]]
    ref = _space("port")
    rx = pw.SpanFirehoseReceiver("127.0.0.1", 0, space=_space()).start()
    client = jw.WireClient(rx.address, client_id="bulk").connect()
    try:
        assert client.send_jsonl(lines) == 1
        items = _drain(rx, 5)
    finally:
        client.close()
        rx.close()
    assert rx.stats()["batches"] == 1
    for (row, _), b in zip(items, _port(corpus[:5])):
        cols, vals = ref.extract_sparse(b.traces)
        np.testing.assert_array_equal(row[0], cols)
        np.testing.assert_array_equal(row[1], vals)
    with pytest.raises(ValueError, match="sparse-first"):
        pw.SpanFirehoseReceiver(space=_space(), sparse=False)


def test_deferred_commit_gates_watermark_and_acks(corpus):
    rx = pw.SpanFirehoseReceiver("127.0.0.1", 0, space=_space()).start()
    client = pw.WireClient(rx.address, client_id="defer").connect()
    try:
        for b in _port(corpus[:3]):
            client.send_bucket(b)
        deadline = time.monotonic() + 30
        while rx.stats()["batches"] < 3:
            assert time.monotonic() < deadline, rx.stats()
            time.sleep(0.002)
        items, token = rx.poll_deferred()
        assert len(items) == 3
        assert rx.ingest_watermark()["clients"].get("defer", 0) == 0
        assert client.flush(timeout_s=0.3) is False
        rx.commit(token)
        assert rx.ingest_watermark()["clients"]["defer"] == 3
        assert client.flush(timeout_s=10) and client.acked == 3
    finally:
        client.close()
        rx.close()


def _welcome(sock):
    hdr = sock.recv(pw.HEADER_SIZE, socket.MSG_WAITALL)
    magic, ftype, _, length, _ = pw._HEADER.unpack(hdr)
    assert (magic, ftype) == (pw.MAGIC, pw.F_WELCOME)
    return json.loads(sock.recv(length, socket.MSG_WAITALL)) if length else {}


def test_watermark_resume_dedups_replayed_frames(corpus):
    payloads = [pw.encode_bucket_payload(b) for b in _port(corpus[:3])]
    rx1 = pw.SpanFirehoseReceiver("127.0.0.1", 0, space=_space()).start()
    try:
        c = pw.WireClient(rx1.address, client_id="replayer").connect()
        for pl in payloads:
            c._send_batch(pl, flags=0)
        _drain(rx1, len(payloads))
        wm = rx1.ingest_watermark()
        c.close()
    finally:
        rx1.close()
    assert wm == {"kind": "wire_seq", "clients": {"replayer": 3}}
    rx2 = pw.SpanFirehoseReceiver("127.0.0.1", 0, space=_space()).start()
    rx2.resume_from(wm)
    try:
        s = socket.create_connection(rx2.address, timeout=5)
        s.sendall(pw.pack_frame(pw.F_HELLO, json.dumps(
            {"client": "replayer"}).encode("utf-8")))
        assert _welcome(s)["watermark"] == 3
        for seq, pl in enumerate(payloads, start=1):
            s.sendall(pw.pack_frame(pw.F_BATCH, pl, seq=seq))
        s.sendall(pw.pack_frame(pw.F_BATCH, payloads[0], seq=4))
        items = _drain(rx2, 1)
        deadline = time.monotonic() + 10
        while rx2.stats()["duplicates"] < 3:
            assert time.monotonic() < deadline, rx2.stats()
            time.sleep(0.005)
        s.close()
        stats = rx2.stats()
    finally:
        rx2.close()
    assert len(items) == 1 and stats["batches"] == 1
    assert rx2.ingest_watermark()["clients"]["replayer"] == 4
    rx3 = pw.SpanFirehoseReceiver("127.0.0.1", 0, space=_space())
    for foreign in ({"kind": "time_cursor", "position": 1.0},
                    {"kind": "wire_seq", "clients": {"a": "junk"}}, "x"):
        rx3.resume_from(foreign)
    assert rx3.ingest_watermark() == {"kind": "wire_seq", "clients": {}}


def test_malformed_frame_counted_once_and_announced():
    rx = pw.SpanFirehoseReceiver("127.0.0.1", 0, space=_space()).start()
    try:
        s = socket.create_connection(rx.address, timeout=5)
        s.sendall(pw.pack_frame(pw.F_HELLO, b"{}"))
        _welcome(s)
        s.sendall(pw.pack_frame(pw.F_BATCH, b"\x00\x00\x00\x02{}", seq=1))
        deadline = time.monotonic() + 10
        while rx.stats()["dropped"] < 1:
            assert time.monotonic() < deadline, rx.stats()
            time.sleep(0.005)
        assert rx.stats()["dropped"] == 1
        hdr = s.recv(pw.HEADER_SIZE, socket.MSG_WAITALL)
        magic, ftype, _, length, _ = pw._HEADER.unpack(hdr)
        assert (magic, ftype) == (pw.MAGIC, pw.F_DROPPED)
        assert json.loads(s.recv(length, socket.MSG_WAITALL))["seqs"] == [1]
        s.close()
    finally:
        rx.close()


# -- wire-fed = tailer-fed ----------------------------------------------------


def _stream(ckpt_dir=None, overlap=True):
    cfg = Config(model=ModelConfig(feature_dim=64, hidden_size=4,
                                   dropout_rate=0.0),
                 train=TrainConfig(batch_size=4, window_size=4, seed=0,
                                   sparse_feed=True, eval_stride=1,
                                   eval_max_cycles=1, log_every_steps=0),
                 etl=EtlConfig(overlap=overlap))
    return StreamingTrainer(
        cfg, StreamConfig(refresh_buckets=12, finetune_epochs=1,
                          eval_holdout=2, poll_interval_s=0.01),
        ckpt_dir=ckpt_dir,
        feature_config=FeaturizeConfig(hash_features=True, capacity=64),
        device="cpu")


@pytest.mark.parametrize("overlap", [False, True])
def test_wire_fed_equals_tailer_fed(corpus, tmp_path, overlap):
    path = str(tmp_path / "raw.jsonl")
    save_raw_data_jsonl(corpus, path)
    st_file = _stream(overlap=overlap)
    tailer = BucketTailer(path)
    res_file = list(st_file.run(tailer, max_refreshes=1, deadline_s=60))
    tailer.close()

    ckpt = str(tmp_path / "ckpt")
    st_wire = _stream(ckpt_dir=ckpt, overlap=overlap)
    rx = pw.SpanFirehoseReceiver("127.0.0.1", 0, space=st_wire.space).start()
    pusher = threading.Thread(target=pw.push_corpus,
                              args=(rx.address, _port(corpus)),
                              kwargs={"client_id": "parity"}, daemon=True)
    pusher.start()
    try:
        res_wire = list(st_wire.run(rx, max_refreshes=1, deadline_s=60))
        pusher.join(timeout=10)
    finally:
        rx.close()
    assert len(res_file) == len(res_wire) == 1
    assert res_file[0].train_loss == res_wire[0].train_loss
    assert res_file[0].eval_loss == res_wire[0].eval_loss
    for a, b in zip(st_file.state.params.values(),
                    st_wire.state.params.values()):
        assert torch.equal(a, b)
    src = load_sidecar(ckpt)["stream_ring_watermark"]["source"]
    assert src == {"kind": "wire_seq", "clients": {"parity": len(corpus)}}


# -- observability and self-ingestion ----------------------------------------


def test_healthz_wire_key_and_push_self_corpus(corpus):
    from deeprest_tpu_torch.obs import export as port_export
    from deeprest_tpu_torch.obs.spans import SpanRecorder
    from deeprest_tpu_torch.serve.server import PredictionService

    class _Stub:
        metric_names = ["comp0_cpu"]
        window_size = 4

    rx = pw.SpanFirehoseReceiver("127.0.0.1", 0).start()
    svc = PredictionService(_Stub(), backend="stub")
    svc.attach_wire(rx)
    rec = SpanRecorder(enabled=True)
    for i in range(6):
        with rec.span("/v1/predict", component="deeprest-predictor"):
            time.sleep(0.001)
    spans = rec.snapshot()
    want = port_export.self_corpus(spans, 5.0)
    pushed = []
    # the receiver ACKs what it drains, so push while this thread polls
    t = threading.Thread(target=lambda: pushed.append(
        port_export.push_self_corpus(rx.address, 5.0, spans=spans)),
        daemon=True)
    try:
        t.start()
        got = _drain(rx, len(want))
        t.join(timeout=10)
        health = svc.healthz()
    finally:
        svc.close()
        rx.close()
    assert pushed == [len(want)] and len(want) >= 1
    assert [b.to_dict() for b in got] == [b.to_dict() for b in want]
    assert health["wire"]["batches"] == len(want)
    assert health["wire"]["dropped"] == 0
    assert port_export.push_self_corpus(rx.address, 5.0, spans=[]) == 0


# -- LiveEndpointTailer against JAX's on the stub cluster --------------------


@pytest.fixture()
def live_cluster():
    buckets = make_series_buckets(8, seed=5)
    cluster = _StubCluster(_render_jaeger(buckets),
                           _render_prometheus(buckets))
    yield buckets, cluster
    cluster.close()


def _poll_sequence(mod, cluster, rmap, steps):
    clock = [T0]
    tailer = mod.LiveEndpointTailer(
        jaeger_url=cluster.url, prom_url=cluster.url, bucket_s=BUCKET_S,
        resource_map=rmap, lag_s=0.0, now=lambda: clock[0])
    out = [tailer.poll()]
    for t in steps:
        clock[0] = T0 + t * BUCKET_S
        out.append(tailer.poll())
    return [[b.to_dict() for b in p] for p in out], tailer.ingest_watermark()


def test_live_tailer_matches_jax_on_stub_cluster(live_cluster):
    buckets, cluster = live_cluster
    steps = (1, 3, 4, 8, 8, 10)
    got_p = _poll_sequence(port_ingest, cluster,
                           _gauge_map(buckets), steps)
    rmap_j = {k: jax_ingest.MetricRule(v.resource, v.mode)
              for k, v in _gauge_map(buckets).items()}
    got_j = _poll_sequence(jax_ingest, cluster, rmap_j, steps)
    assert got_p == got_j
    assert sum(len(p) for p in got_p[0]) >= len(buckets)
    t = port_ingest.LiveEndpointTailer("http://127.0.0.1:1/api",
                                       bucket_s=5.0)
    t.resume_from(got_p[1])
    assert t.ingest_watermark() == got_p[1]
    t.resume_from({"kind": "wire_seq", "clients": {"x": 9}})
    assert t.ingest_watermark() == got_p[1]


def _counter_fetch(url, timeout_s=0):
    from urllib.parse import parse_qs, urlparse

    q = {k: v[0] for k, v in parse_qs(urlparse(url).query).items()}
    lo, hi = float(q["start"]), float(q["end"])
    vals = [[T0 + (i + 0.5) * BUCKET_S, str(100.0 + 10.0 * i)]
            for i in range(10)
            if lo <= T0 + (i + 0.5) * BUCKET_S <= hi]
    return {"status": "success", "data": {"resultType": "matrix",
            "result": [{"metric": {"__name__": "cum_cpu", "pod": "a"},
                        "values": vals}] if vals else []}}


def _quiet_fetch(url, timeout_s=0):
    return {"status": "success", "data": {"resultType": "matrix",
                                          "result": []}}


@pytest.mark.parametrize("fetch, mode", [(_counter_fetch, "counter"),
                                         (_quiet_fetch, "gauge")])
def test_live_tailer_counters_and_zero_fill_match_jax(fetch, mode):
    def run(mod):
        clock = [T0 + BUCKET_S]
        tailer = mod.LiveEndpointTailer(
            prom_url="http://stub", bucket_s=BUCKET_S,
            resource_map={"cum_cpu": mod.MetricRule("cpu", mode)},
            lag_s=0.0, now=lambda: clock[0], fetch=fetch)
        out = []
        for i in (2, 3, 4, 7, 8):
            clock[0] = T0 + i * BUCKET_S
            out.append([b.to_dict() for b in tailer.poll()])
        return out

    got = run(port_ingest)
    assert got == run(jax_ingest)
    assert [len(p) for p in got] == [1, 1, 1, 3, 1]
    if mode == "counter":
        assert [p[0]["metrics"][0]["value"] for p in got] == [10.0] * 5


def test_live_tailer_escalates_deterministic_failures():
    import urllib.error

    def fetch(url, timeout_s=0):
        raise urllib.error.HTTPError(url, 404, "not found", {}, None)

    def conn(url, timeout_s=0):
        raise urllib.error.URLError("connection refused")

    clock = [T0]
    kw = dict(prom_url="http://stub", bucket_s=BUCKET_S, lag_s=0.0,
              now=lambda: clock[0], max_deterministic_failures=3,
              max_transient_failures=2)
    tailer = port_ingest.LiveEndpointTailer(fetch=fetch, **kw)
    for step in (1, 2):
        clock[0] = T0 + step * BUCKET_S
        assert tailer.poll() == []
    clock[0] = T0 + 3 * BUCKET_S
    with pytest.raises(RuntimeError, match="deterministic"):
        tailer.poll()
    tailer2 = port_ingest.LiveEndpointTailer(fetch=conn, **kw)
    for _ in range(4):
        clock[0] += BUCKET_S
        assert tailer2.poll() == []
    assert tailer2.degraded
    with pytest.raises(ValueError, match="jaeger_url/prom_url"):
        port_ingest.LiveEndpointTailer()
