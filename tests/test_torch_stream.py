"""Streaming retrain in the port (``deeprest_tpu_torch/train/stream.py``)
against the JAX package's, on the CPU, at small sizes (capacity 32, W=6,
H=8, f32, dropout 0).

- Across packages: a JAX ``StreamingTrainer`` refreshes once into a
  checkpoint directory, which is copied.  The JAX stream and the port's
  stream resume from the copies, ingest the same next buckets and refresh
  twice: refresh losses within 1e-5, params within 1e-4 of each leaf's
  scale, ``x_union``/``x_stats``/``y_stats`` bit-equal, the frozen metric
  set and the sidecar keys equal.  Then the other way round: the port's
  checkpoint resumed by the JAX stream.
- The port alone: serial = overlapped bit for bit, sparse ring = dense ring
  bit for bit, mid-refresh snapshots carry the stream sidecar, a step with
  no sidecar is skipped with JAX's message, the reserved sidecar keys are
  refused, the rings match a recompute.
- ``BucketTailer``: the scenarios of ``tests/test_stream.py`` (torn tails,
  garbage, late files, rotations, truncation, fd release, bounded polls)
  give equal bucket sequences from the port's tailer and the JAX tailer.
- The ``stream`` CLI runs, is run again and resumes; ``--elastic`` runs
  with a snapshot cadence and without one exits with JAX's message; with
  no GPU the stream raises unless ``device="cpu"``.
"""

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from conftest import make_series_buckets
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.schema import save_raw_data_jsonl
from deeprest_tpu.train.stream import BucketTailer as JaxBucketTailer
from deeprest_tpu.train.stream import StreamConfig as JaxStreamConfig
from deeprest_tpu.train.stream import StreamingTrainer as JaxStreamingTrainer
from deeprest_tpu_torch.config import (
    Config, EtlConfig, FeaturizeConfig, ModelConfig, TrainConfig,
)
from deeprest_tpu_torch.data.schema import Bucket
from deeprest_tpu_torch.train.checkpoint import (
    _SIDECAR, _step_dir, latest_step, list_steps, load_leaves, load_sidecar,
)
from deeprest_tpu_torch.train.stream import (
    BucketTailer, StreamConfig, StreamingTrainer, expand_minmax,
)

CAPACITY = 32
WINDOW = 6
SIDECAR_KEYS = ("stream_refresh_count", "stream_x_union",
                "stream_ring_watermark", "delta_mask", "metric_names")


def _stream_kw(**kw):
    return {**dict(refresh_buckets=12, finetune_epochs=1, history_max=256,
                   eval_holdout=2, poll_interval_s=0.05), **kw}


def _train_kw(**kw):
    return {**dict(batch_size=8, window_size=WINDOW, seed=0, eval_stride=1,
                   eval_max_cycles=2, log_every_steps=0), **kw}


def port_stream(ckpt_dir=None, overlap=True, sparse=False, train_kw=None,
                **stream_kw) -> StreamingTrainer:
    cfg = Config(model=ModelConfig(feature_dim=CAPACITY, hidden_size=8,
                                   dropout_rate=0.0),
                 train=TrainConfig(**_train_kw(sparse_feed=sparse,
                                               **(train_kw or {}))),
                 etl=EtlConfig(overlap=overlap))
    return StreamingTrainer(
        cfg, StreamConfig(**_stream_kw(**stream_kw)), ckpt_dir=ckpt_dir,
        feature_config=FeaturizeConfig(hash_features=True, capacity=CAPACITY),
        device="cpu")


def jax_stream(ckpt_dir=None, **stream_kw) -> JaxStreamingTrainer:
    cfg = JaxConfig(model=JaxModelConfig(feature_dim=CAPACITY, hidden_size=8,
                                         dropout_rate=0.0,
                                         rnn_backend="scan"),
                    train=JaxTrainConfig(**_train_kw()))
    return JaxStreamingTrainer(
        cfg, JaxStreamConfig(**_stream_kw(**stream_kw)), ckpt_dir=ckpt_dir,
        feature_config=JaxFeaturizeConfig(hash_features=True,
                                          capacity=CAPACITY))


def port_buckets(buckets):
    return [Bucket.from_dict(b.to_dict()) for b in buckets]


def _leaf_close(name, got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-6)
    err = float(np.max(np.abs(got - want))) / scale
    assert err <= tol, f"{name}: {err:.3g} of scale"


def _params_close(port_st, jax_st, tol=1e-4):
    port = {k: v.detach().cpu().numpy() for k, v in port_st.state.params.items()}
    for name, leaf in jax_st.state.params.items():
        _leaf_close(name, port[name], leaf, tol)


def _stats_equal(port_st, jax_st):
    for attr in ("x_union", "x_stats", "y_stats"):
        a, b = getattr(port_st, attr), getattr(jax_st, attr)
        np.testing.assert_array_equal(np.asarray(a.min), np.asarray(b.min))
        np.testing.assert_array_equal(np.asarray(a.max), np.asarray(b.max))


def _refresh_twice(port_st, jax_st, buckets):
    out = []
    for chunk in (buckets[:14], buckets[14:]):
        for b in chunk:
            jax_st.ingest(b)
        for b in port_buckets(chunk):
            port_st.ingest(b)
        rj, rp = jax_st.refresh(), port_st.refresh()
        assert rp.refresh == rj.refresh and rp.num_buckets == rj.num_buckets
        assert abs(rp.train_loss - rj.train_loss) <= 1e-5
        assert abs(rp.eval_loss - rj.eval_loss) <= 1e-5
        out.append((rp, rj))
    return out


@pytest.fixture(scope="module")
def jax_refresh_dir(tmp_path_factory):
    """A JAX stream's checkpoint directory after one refresh on 40
    buckets."""
    ckpt = str(tmp_path_factory.mktemp("jax_stream") / "ckpt")
    st = jax_stream(ckpt_dir=ckpt)
    for b in make_series_buckets(40, seed=1):
        st.ingest(b)
    st.refresh()
    return ckpt


def test_port_resumes_jax_stream_and_back(jax_refresh_dir, tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(jax_refresh_dir, jax_dir)
    shutil.copytree(jax_refresh_dir, port_dir)
    jst, pst = jax_stream(ckpt_dir=jax_dir), port_stream(ckpt_dir=port_dir)
    assert pst.metric_names == jst.metric_names
    assert pst._refresh_count == jst._refresh_count == 1
    assert pst._ingested_total == jst._ingested_total == 40
    np.testing.assert_array_equal(pst.current_delta_mask(),
                                  jst.current_delta_mask())
    _params_close(pst, jst, tol=0.0)
    more = make_series_buckets(70, seed=2)[40:]
    _refresh_twice(pst, jst, more)
    _params_close(pst, jst)
    _stats_equal(pst, jst)
    sj = load_sidecar(jax_dir, latest_step(jax_dir))
    sp = load_sidecar(port_dir, latest_step(port_dir))
    assert set(sp) == set(sj)
    for key in SIDECAR_KEYS:
        assert sp[key] == sj[key], key
    leaves_p = load_leaves(port_dir, latest_step(port_dir))
    assert int(leaves_p["step"]) == int(jst.state.step)

    # the other way round: the port's checkpoint resumed by the JAX stream
    back = str(tmp_path / "back")
    shutil.copytree(port_dir, back)
    jst2, pst2 = jax_stream(ckpt_dir=back), port_stream(ckpt_dir=port_dir)
    assert jst2._refresh_count == pst2._refresh_count == 3
    assert jst2.metric_names == pst2.metric_names
    _params_close(pst2, jst2, tol=0.0)
    tail = make_series_buckets(100, seed=3)[70:]
    _refresh_twice(pst2, jst2, tail)
    _params_close(pst2, jst2)
    _stats_equal(pst2, jst2)


def _bundle_losses(st, buckets, n_refresh=2):
    out = []
    for chunk in np.array_split(np.arange(len(buckets)), n_refresh):
        for i in chunk:
            st.ingest(buckets[i])
        r = st.refresh()
        out.append((r.train_loss, r.eval_loss))
    return out


def test_sparse_ring_equals_dense_ring():
    buckets = port_buckets(make_series_buckets(60, seed=5))
    dense, sparse = port_stream(), port_stream(sparse=True)
    assert _bundle_losses(dense, buckets) == _bundle_losses(sparse, buckets)
    np.testing.assert_array_equal(sparse.traffic.densify(),
                                  dense.traffic.view())
    for a, b in zip(dense.state.params.values(),
                    sparse.state.params.values()):
        assert torch.equal(a, b)


def _write(path, buckets):
    save_raw_data_jsonl(buckets, path)


def test_overlapped_run_equals_serial_bit_for_bit(tmp_path):
    path = str(tmp_path / "raw.jsonl")
    _write(path, make_series_buckets(44, seed=13))

    # polls of ~12 buckets, so two refreshes fire without waiting
    cap = 12 * os.path.getsize(path) // 44

    def run_mode(overlap):
        st = port_stream(overlap=overlap)
        tailer = BucketTailer(path, max_poll_bytes=cap)
        out = list(st.run(tailer, max_refreshes=2, deadline_s=60))
        tailer.close()
        return st, out

    st_ser, res_ser = run_mode(False)
    st_ovl, res_ovl = run_mode(True)
    assert [r.num_buckets for r in res_ovl] == [r.num_buckets for r in res_ser]
    assert len(res_ser) == 2
    for a, b in zip(res_ovl, res_ser):
        assert a.train_loss == b.train_loss and a.eval_loss == b.eval_loss
        assert a.etl_dropped == 0 and a.etl_lag_buckets >= 0
    assert all(r.etl_lag_buckets == 0 for r in res_ser)
    for a, b in zip(st_ovl.state.params.values(), st_ser.state.params.values()):
        assert torch.equal(a, b)


def test_mid_refresh_snapshots_carry_stream_sidecar(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    st = port_stream(ckpt_dir=ckpt,
                     train_kw=dict(snapshot_every_steps=1,
                                   steps_per_superstep=1, snapshot_keep=0))
    for b in port_buckets(make_series_buckets(40, seed=1)):
        st.ingest(b)
    r = st.refresh()
    assert r.steps == 4
    cursors = [s for s in list_steps(ckpt)
               if "train_cursor" in load_sidecar(ckpt, s)]
    assert cursors                       # mid-refresh snapshots were cut
    for s in cursors:
        extra = load_sidecar(ckpt, s)
        assert extra["stream_refresh_count"] == 0
        assert extra["stream_ring_watermark"]["ingested_total"] == 40
        assert "stream_x_union" in extra
    st2 = port_stream(ckpt_dir=ckpt)
    assert st2._refresh_count == 1 and st2.metric_names == st.metric_names


def test_resume_skips_step_without_sidecar(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    st = port_stream(ckpt_dir=ckpt)
    for b in port_buckets(make_series_buckets(40, seed=1)):
        st.ingest(b)
    st.refresh()
    good = latest_step(ckpt)
    for b in port_buckets(make_series_buckets(80, seed=2)[40:]):
        st.ingest(b)
    st.refresh()
    os.remove(os.path.join(_step_dir(ckpt, latest_step(ckpt)), _SIDECAR))
    st2 = port_stream(ckpt_dir=ckpt)
    assert st2._refresh_count == 1
    assert "no sidecar" in capsys.readouterr().out
    assert latest_step(ckpt) != good
    with pytest.raises(ValueError, match="reserved sidecar"):
        st.trainer.save(str(tmp_path / "other"), st.state, _bundle_of(st),
                        extra_host_state={"x_stats": {}})


def _bundle_of(st):
    from deeprest_tpu_torch.train.data import DatasetBundle

    return DatasetBundle(
        x_train=None, y_train=None, x_test=None, y_test=None,
        x_stats=st.x_stats, y_stats=st.y_stats,
        metric_names=st.metric_names, split=1, window_size=WINDOW,
        space_dict=st.space.to_dict(), sparse_capacity=CAPACITY)


def test_incremental_rings_and_stats_policy():
    st = port_stream(history_max=24)
    buckets = port_buckets(make_series_buckets(60, seed=7))
    for i, b in enumerate(buckets):
        if i == 30:
            st._freeze_metrics()
        st.ingest(b)
    retained = buckets[-24:]
    from deeprest_tpu_torch.data.featurize import CallPathSpace

    fresh = CallPathSpace(config=FeaturizeConfig(hash_features=True,
                                                 capacity=CAPACITY))
    np.testing.assert_array_equal(
        st.traffic.view(),
        np.stack([fresh.extract_reference(b.traces) for b in retained]))
    assert len(st.traffic) == len(st.metrics) == len(st._targets()) == 24
    a = st.x_union
    assert a is None
    from deeprest_tpu_torch.data.windows import MinMaxStats

    x = MinMaxStats(min=np.float32([0.0, 2.0]), max=np.float32([1.0, 3.0]))
    y = MinMaxStats(min=np.float32([-1.0, 2.5]), max=np.float32([0.5, 9.0]))
    u = expand_minmax(x, y)
    np.testing.assert_array_equal(u.min, [-1.0, 2.0])
    np.testing.assert_array_equal(u.max, [1.0, 9.0])
    assert expand_minmax(None, x) is x


# -- BucketTailer against the JAX tailer -------------------------------------


def _line(b) -> bytes:
    return (json.dumps(b.to_dict(), separators=(",", ":")) + "\n").encode()


def _drain(tailer, grace_s, timeout_s=30.0):
    got, idle_since = [], None
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        batch = tailer.poll()
        got.extend(batch)
        if batch or tailer.backlog:
            idle_since = None
            continue
        now = time.monotonic()
        if idle_since is None:
            idle_since = now
        elif now - idle_since > grace_s + 0.2:
            return got
        time.sleep(0.02)
    raise AssertionError("tailer never drained")


def _torn_tail(d, cls):
    path = os.path.join(d, "raw.jsonl")
    b0, b1 = make_series_buckets(2)
    line = _line(b1)
    with open(path, "wb") as f:
        f.write(_line(b0) + line[:len(line) // 2])
    t = cls(path)
    out = [t.poll(), t.poll()]
    with open(path, "ab") as f:
        f.write(line[len(line) // 2:])
    out.append(t.poll())
    return out, t.dropped


def _garbage(d, cls):
    path = os.path.join(d, "raw.jsonl")
    [b0] = make_series_buckets(1)
    with open(path, "wb") as f:
        f.write(b"this is not json\n" + _line(b0)
                + b'{"metrics": "wrong-type"}\n')
    t = cls(path)
    return [t.poll()], t.dropped


def _late_file(d, cls):
    path = os.path.join(d, "later.jsonl")
    t = cls(path)
    out = [t.poll()]
    save_raw_data_jsonl(make_series_buckets(3), path)
    out.append(t.poll())
    return out, t.dropped


def _rename_mid_backlog(d, cls):
    path = os.path.join(d, "raw.jsonl")
    buckets = make_series_buckets(12, seed=2)
    save_raw_data_jsonl(buckets[:9], path)
    t = cls(path, max_poll_bytes=2 * len(_line(buckets[0])))
    first = t.poll()
    assert t.backlog
    os.rename(path, path + ".old")
    save_raw_data_jsonl(buckets[9:], path)
    return [first + _drain(t, cls.GRACE_S)], (t.dropped, t.truncated_events)


def _double_rotation(d, cls):
    path = os.path.join(d, "raw.jsonl")
    buckets = make_series_buckets(9, seed=3)
    save_raw_data_jsonl(buckets[:5], path)
    t = cls(path, max_poll_bytes=len(_line(buckets[0])))
    got = t.poll()
    os.rename(path, path + ".g1")
    save_raw_data_jsonl(buckets[5:7], path)
    got += t.poll()
    os.rename(path, path + ".g2")
    save_raw_data_jsonl(buckets[7:], path)
    return [got + _drain(t, cls.GRACE_S)], t.dropped


def _writer_keeps_fd(d, cls):
    path = os.path.join(d, "raw.jsonl")
    buckets = make_series_buckets(4, seed=5)
    line = _line(buckets[2])
    writer = open(path, "wb")
    writer.write(_line(buckets[0]) + _line(buckets[1]) + line[:10])
    writer.flush()
    t = cls(path)
    first = t.poll()
    os.rename(path, path + ".old")
    save_raw_data_jsonl([buckets[3]], path)
    t.poll()
    writer.write(line[10:])
    writer.flush()
    writer.close()
    got = _drain(t, cls.GRACE_S)
    return [first, sorted(got, key=lambda b: json.dumps(b.to_dict()))], \
        t.dropped


def _truncate(d, cls):
    path = os.path.join(d, "raw.jsonl")
    buckets = make_series_buckets(5)
    save_raw_data_jsonl(buckets[:3], path)
    t = cls(path)
    first = t.poll()
    save_raw_data_jsonl(buckets[3:], path)
    return [first, t.poll()], t.truncated_events


def _unlink(d, cls):
    path = os.path.join(d, "raw.jsonl")
    save_raw_data_jsonl(make_series_buckets(3), path)
    t = cls(path)
    first = t.poll()
    os.unlink(path)
    t.poll()
    time.sleep(cls.GRACE_S + 0.05)
    t.poll()
    released = t._f is None
    t.close()
    return [first], released


def _bounded_backlog(d, cls):
    path = os.path.join(d, "big.jsonl")
    save_raw_data_jsonl(make_series_buckets(30, seed=4), path)
    line_len = len(open(path, "rb").readline())
    t = cls(path, max_poll_bytes=3 * line_len)
    polls = []
    while True:
        batch = t.poll()
        if not batch and not t.backlog:
            break
        polls.append(batch)
    return polls, (len(polls), t.backlog, t.dropped)


TAILER_CASES = {
    "torn_tail": _torn_tail, "garbage": _garbage, "late_file": _late_file,
    "rename_mid_backlog": _rename_mid_backlog,
    "double_rotation": _double_rotation,
    "writer_keeps_fd": _writer_keeps_fd, "truncate": _truncate,
    "unlink_releases_fd": _unlink, "bounded_backlog": _bounded_backlog,
}


@pytest.mark.parametrize("case", sorted(TAILER_CASES))
def test_tailer_matches_jax(case, tmp_path):
    fn = TAILER_CASES[case]
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got_p, extra_p = fn(str(tmp_path / "port"), BucketTailer)
    got_j, extra_j = fn(str(tmp_path / "jax"), JaxBucketTailer)
    dicts = lambda polls: [[b.to_dict() for b in p] for p in polls]
    assert dicts(got_p) == dicts(got_j)
    assert sum(map(len, got_p)) > 0
    assert extra_p == extra_j


# -- the CLI ------------------------------------------------------------------


def _cli_argv(tmp_path, path):
    return ["stream", "--raw", path, "--ckpt-dir", str(tmp_path / "ckpt"),
            "--capacity", "32", "--window", "6", "--hidden-size", "8",
            "--batch-size", "8", "--refresh-buckets", "12",
            "--finetune-epochs", "1", "--eval-holdout", "2",
            "--poll-interval", "0.05", "--device", "cpu"]


def test_cli_stream_runs_then_resumes(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    path = str(tmp_path / "raw.jsonl")
    save_raw_data_jsonl(make_series_buckets(60, seed=6), path)
    argv = _cli_argv(tmp_path, path)
    assert main(argv + ["--max-refreshes", "1"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["refresh"] == 1 and first["device"] == "cpu"
    assert {"buckets", "train_loss", "eval_loss", "checkpoint", "trigger",
            "etl", "steps", "captures", "seconds"} <= set(first)
    assert main(argv + ["--max-refreshes", "1"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out
    second = json.loads(out.strip().splitlines()[-1])
    assert second["refresh"] == 2
    assert load_sidecar(str(tmp_path / "ckpt"))["stream_refresh_count"] == 2


def test_cli_stream_refusals(tmp_path, capsys):
    from deeprest_tpu_torch.cli import main

    path = str(tmp_path / "raw.jsonl")
    argv = _cli_argv(tmp_path, path)
    assert main(argv + ["--elastic"]) == 2
    out = capsys.readouterr().out
    with pytest.raises(ValueError) as ref:
        JaxTrainConfig(elastic=True)
    assert str(ref.value) in out
    save_raw_data_jsonl(make_series_buckets(60, seed=6), path)
    assert main(argv + ["--elastic", "--snapshot-every-steps", "2",
                        "--max-refreshes", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["refresh"] == 1 and line["remeshes"] == 0
    assert main(argv + ["--wire-listen", "127.0.0.1:0"]) == 2
    assert "need exactly one source" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host with no GPU")
def test_stream_without_gpu_raises_unless_cpu():
    cfg = Config(model=ModelConfig(feature_dim=CAPACITY, hidden_size=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingTrainer(cfg, StreamConfig(), feature_config=FeaturizeConfig(
            hash_features=True, capacity=CAPACITY))
    assert StreamingTrainer(cfg, StreamConfig(), device="cpu",
                            feature_config=FeaturizeConfig(
                                hash_features=True,
                                capacity=CAPACITY)).device.type == "cpu"


def test_run_loop_on_growing_file(tmp_path):
    path = str(tmp_path / "raw.jsonl")
    buckets = make_series_buckets(60, seed=4)
    save_raw_data_jsonl(buckets[:20], path)

    def append_rest():
        for b in buckets[20:]:
            with open(path, "ab") as f:
                f.write(_line(b))
            time.sleep(0.005)

    t = threading.Thread(target=append_rest)
    t.start()
    st = port_stream(refresh_buckets=20)
    results = list(st.run(BucketTailer(path), max_refreshes=2, deadline_s=60))
    t.join()
    assert [r.refresh for r in results] == [1, 2]
    assert results[-1].num_buckets > results[0].num_buckets
    assert all(np.isfinite(r.eval_loss) for r in results)
    assert dataclasses.asdict(results[0])["captures"] == 0   # eager on the CPU
