"""The port's quality monitors, drift→retrain loop and verdict surface
(``deeprest_tpu_torch/obs/quality.py``, ``train/stream.DriftController``,
``serve/server.VerdictIngestor``) against the JAX package's, on the CPU.

- ``HysteresisVerdict``: equal state sequences on the same score streams.
- ``FeatureDriftMonitor``: PSI/KS within 1e-6 on the same rows.
- ``QualityMonitor`` over one deterministic backend: the rolling coverage
  and pinball within 1e-6, the verdict payloads (anomaly scores, states)
  within 1e-5, the event logs equal, the registry text of the quality
  gauges equal.
- ``WindowBackend`` on JAX-derived params (``interop.params_from_jax``)
  within 1e-5 of the JAX ``WindowBackend``.
- ``DriftController`` on the drift corpus of ``tests/test_quality.py``
  (a composition shift onto new call paths), both streams resumed from one
  JAX checkpoint: the same retrain triggers at the same buckets, the same
  verdict transitions.
- ``/v1/verdict`` of a port ``PredictionServer`` with a ``VerdictIngestor``
  on a checkpoint and corpus equals the JAX service's (states equal,
  numbers within 1e-5); 503 with JAX's message without a monitor; the
  ``serve --verdict-raw`` CLI answers it over HTTP.
"""

import json
import os
import select
import shutil
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from conftest import make_series_buckets
from test_torch_whatif import assert_json_close

from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import QualityConfig as JaxQualityConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.schema import Bucket as JaxBucket
from deeprest_tpu.data.schema import MetricSample, Span
from deeprest_tpu.data.schema import save_raw_data_jsonl
from deeprest_tpu.data.windows import MinMaxStats as JaxMinMax
from deeprest_tpu.obs import metrics as jax_obs_metrics
from deeprest_tpu.obs import quality as jq
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.server import PredictionService as JaxService
from deeprest_tpu.serve.server import ServingError as JaxServingError
from deeprest_tpu.serve.server import VerdictIngestor as JaxIngestor
from deeprest_tpu.train.stream import BucketTailer as JaxTailer
from deeprest_tpu.train.stream import DriftController as JaxDrift
from deeprest_tpu.train.stream import StreamConfig as JaxStreamConfig
from deeprest_tpu.train.stream import StreamingTrainer as JaxStreaming
from deeprest_tpu_torch.config import (
    Config, FeaturizeConfig, ModelConfig, QualityConfig, TrainConfig,
)
from deeprest_tpu_torch.data.schema import Bucket
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.models.qrnn import QuantileGRU
from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import quality as pq
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.server import (
    PredictionServer, PredictionService, ServingError, VerdictIngestor,
)
from deeprest_tpu_torch.train.stream import (
    BucketTailer, DriftController, StreamConfig, StreamingTrainer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPACITY = 32
WINDOW = 6
TIMEOUT = 60


# -- HysteresisVerdict and the drift score -----------------------------------


@pytest.mark.parametrize("scores, thresholds", [
    ((0.9, 0.9, 0.9, 0.1, 0.1, 0.9), (0.5, 0.2, 3, 2)),
    ((0.9, 0.1) * 10, (0.5, 0.2, 2, 2)),
    ((0.9, 0.9, 0.35, 0.35, 0.1, 0.3, 0.1, 0.1), (0.5, 0.2, 2, 2)),
    ((0.6, 0.6, 0.1, 0.6, 0.1, 0.1, 0.1), (0.5, 0.2, 2, 3)),
])
def test_hysteresis_sequences_equal(scores, thresholds):
    a, b = pq.HysteresisVerdict(*thresholds), jq.HysteresisVerdict(*thresholds)
    seq_a = [(a.update(s), a.transitions) for s in scores]
    seq_b = [(b.update(s), b.transitions) for s in scores]
    assert seq_a == seq_b
    with pytest.raises(ValueError) as ea:
        pq.HysteresisVerdict(0.1, 0.5)
    with pytest.raises(ValueError) as eb:
        jq.HysteresisVerdict(0.1, 0.5)
    assert str(ea.value) == str(eb.value)


def _sparse_rows(rng, cols_pool, n_rows, scale=8.0):
    rows = []
    for _ in range(n_rows):
        k = rng.integers(1, len(cols_pool) + 1)
        cols = np.sort(rng.choice(cols_pool, size=k, replace=False))
        vals = rng.poisson(scale, size=k).astype(np.float32) + 1.0
        rows.append((cols.astype(np.int32), vals))
    return rows


@pytest.mark.parametrize("ref_pool, live_pool, scale", [
    ((2, 5, 9, 17), (2, 5, 9, 17), 8.0),
    ((2, 5, 9), (2, 20, 21), 8.0),
    ((3, 7), (3, 7), 32.0),
])
def test_drift_scores_match(ref_pool, live_pool, scale):
    rng = np.random.default_rng(0)
    ref = _sparse_rows(rng, np.array(ref_pool), 200)
    live = _sparse_rows(rng, np.array(live_pool), 100, scale=scale)
    dense = []
    for cols, vals in live:
        row = np.zeros((CAPACITY,), np.float32)
        row[cols] = vals
        dense.append(row)
    a, b = pq.FeatureDriftMonitor(), jq.FeatureDriftMonitor()
    a.set_reference(ref)
    b.set_reference(ref)
    for rows in (live, dense):
        sa, sb = a.compare(rows), b.compare(rows)
        for f in ("psi", "psi_max", "ks_max"):
            assert abs(getattr(sa, f) - getattr(sb, f)) <= 1e-6, f
        assert (sa.columns_over, sa.columns) == (sb.columns_over, sb.columns)


# -- QualityMonitor over one deterministic backend ---------------------------


class _FakeBackend:
    """The q50 band tracks the traffic row-sum, q05/q95 bracket it."""

    def __init__(self, metric_names, stats_cls):
        self.metric_names = list(metric_names)
        self.window_size = WINDOW
        self.feature_dim = CAPACITY
        self.quantiles = (0.05, 0.50, 0.95)
        self.delta_mask = None
        self.y_stats = stats_cls(
            min=np.zeros((len(metric_names),), np.float32),
            max=np.ones((len(metric_names),), np.float32))

    def median_index(self):
        return 1

    def predict_series(self, traffic, integrate=True):
        base = traffic.sum(axis=1, keepdims=True)
        med = np.repeat(base, len(self.metric_names), axis=1)
        return np.stack([med * 0.5, med, med * 1.5 + 1.0],
                        axis=-1).astype(np.float32)


def _monitor_run(mod, cfg_cls, stats_cls, registry):
    names = ["svc_cpu", "db_wiops"]
    qc = cfg_cls(enabled=True, min_sweep_buckets=WINDOW, sustain_enter=2,
                 sustain_exit=2, drift_enter=0.5, drift_exit=0.2,
                 calibration_sweeps=3, live_window=2 * WINDOW)
    m = mod.QualityMonitor(names, qc, registry=registry)
    backend = _FakeBackend(names, stats_cls)
    rng = np.random.default_rng(0)
    out = []

    def observe(n, cols, level, gain):
        for _ in range(n):
            vals = rng.poisson(level, size=len(cols)).astype(np.float32) + 1
            m.observe(np.asarray(cols, np.int32), vals,
                      np.array([vals.sum() * gain, vals.sum() * 2 * gain],
                               np.float32))

    observe(2 * WINDOW, [1, 3], 8.0, 1.0)
    out.append(m.sweep(backend))                # no reference yet
    m.rebase_reference()
    for cols, level, gain, rounds in (([1, 3], 8.0, 1.0, 3),
                                      ([1, 3], 8.0, 50.0, 2),
                                      ([20, 25, 28], 30.0, 50.0, 3)):
        for _ in range(rounds):
            observe(WINDOW, cols, level, gain)
            out.append(m.sweep(backend))
    m.on_model_refresh()
    m.rebase_reference()
    for _ in range(2):
        observe(WINDOW, [20, 25, 28], 30.0, 50.0)
        out.append(m.sweep(backend))
    out.append(m.verdicts())
    rolling = (m.calibration.coverage(), m.calibration.pinball())
    return out, list(m.events), m.any_active(mod.VERDICT_DRIFT), rolling


def _quality_lines(text):
    return sorted(line for line in text.splitlines()
                  if "quality" in line or "feature_drift" in line)


def test_monitor_verdicts_events_and_registry_match():
    reg_p = obs_metrics.MetricsRegistry()
    reg_j = jax_obs_metrics.MetricsRegistry()
    got_p = _monitor_run(pq, QualityConfig, MinMaxStats, reg_p)
    got_j = _monitor_run(jq, JaxQualityConfig, JaxMinMax, reg_j)
    assert_json_close(json.loads(json.dumps(got_p[0])),
                      json.loads(json.dumps(got_j[0])))
    assert got_p[1] == got_j[1] and got_p[1]     # transitions happened
    assert got_p[2] == got_j[2]
    for a, b in zip(got_p[3], got_j[3]):          # coverage, pinball
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert _quality_lines(reg_p.render()) == _quality_lines(reg_j.render())
    assert any("deeprest_quality_band_coverage" in line
               for line in _quality_lines(reg_p.render()))


# -- WindowBackend on JAX-derived params -------------------------------------


def test_window_backend_matches_jax():
    import jax

    from deeprest_tpu.models.qrnn import QuantileGRU as JaxGRU

    mc = dict(feature_dim=8, num_metrics=2, hidden_size=8, dropout_rate=0.0)
    jmodel = JaxGRU(config=JaxModelConfig(rnn_backend="scan", **mc))
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          np.zeros((1, WINDOW, 8), np.float32),
                          deterministic=True)["params"]
    japply = jax.jit(lambda p, x: jmodel.apply({"params": p}, x,
                                               deterministic=True))
    stats = [dict(min=np.zeros((1, 8), np.float32),
                  max=np.full((1, 8), 10.0, np.float32)),
             dict(min=np.zeros((2,), np.float32),
                  max=np.asarray([5.0, 9.0], np.float32))]
    model = QuantileGRU(ModelConfig(**mc), device="cpu")
    params = params_from_jax(jparams)
    model.load_params(params)
    names = ["a_cpu", "b_usage"]
    dm = np.array([False, True])
    pb = pq.WindowBackend(pq.model_apply(model), model.params(),
                          MinMaxStats(**stats[0]), MinMaxStats(**stats[1]),
                          names, (0.05, 0.5, 0.95), WINDOW, delta_mask=dm)
    jb = jq.WindowBackend(japply, jparams, JaxMinMax(**stats[0]),
                          JaxMinMax(**stats[1]), names, (0.05, 0.5, 0.95),
                          WINDOW, delta_mask=dm)
    traffic = np.random.default_rng(0).random((WINDOW, 8)).astype(
        np.float32) * 4.0
    for integrate in (False, True):
        got = pb.predict_series(traffic, integrate=integrate)
        want = jb.predict_series(traffic, integrate=integrate)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert pb.feature_dim == jb.feature_dim == 8
    with pytest.raises(ValueError, match="serves exactly one window"):
        pb.predict_series(traffic[:-1])


# -- the drift→retrain loop ---------------------------------------------------


def _shifted_bucket(rng):
    """Post-shift traffic of tests/test_quality.py: new call paths, same
    metric keyset."""
    n = 3 + int(rng.poisson(4))
    traces = [Span(component="gateway", operation="/new",
                   children=[Span("fresh-svc", "/read",
                                  children=[Span("fresh-db", "/find")])])
              for _ in range(n)]
    metrics = [
        MetricSample("gateway", "cpu", 5.0 * n + rng.normal(0, 0.5)),
        MetricSample("store-db", "wiops", rng.normal(0, 1.0)),
    ]
    return JaxBucket(metrics=metrics, traces=traces)


def _stream_kw():
    return dict(refresh_buckets=24, finetune_epochs=1, history_max=256,
                eval_holdout=2, poll_interval_s=0.05)


def _train_kw():
    return dict(batch_size=8, window_size=WINDOW, seed=0, eval_stride=1,
                eval_max_cycles=2, log_every_steps=0)


def _quality_kw():
    return dict(enabled=True, sweep_every_buckets=6, live_window=24,
                min_sweep_buckets=WINDOW, sustain_enter=2, sustain_exit=2,
                drift_enter=0.3, drift_exit=0.12,
                retrain_cooldown_buckets=40, reference_window=48,
                model_warmup_refreshes=2)


@pytest.fixture(scope="module")
def pre_shift_dir(tmp_path_factory):
    """A JAX stream's checkpoint after the pre-shift regime (60 buckets,
    refreshes every 24)."""
    ckpt = str(tmp_path_factory.mktemp("drift") / "ckpt")
    st = JaxStreaming(
        JaxConfig(model=JaxModelConfig(feature_dim=CAPACITY, hidden_size=8,
                                       dropout_rate=0.0, rnn_backend="scan"),
                  train=JaxTrainConfig(**_train_kw())),
        JaxStreamConfig(**_stream_kw()), ckpt_dir=ckpt,
        feature_config=JaxFeaturizeConfig(hash_features=True,
                                          capacity=CAPACITY))
    for b in make_series_buckets(60, seed=3):
        st.ingest(b)
        if st.ready():
            st.refresh()
    return ckpt


def _drift_loop(st, controller, to_bucket):
    rng = np.random.default_rng(0)
    triggers = []
    for i in range(130):
        st.ingest(to_bucket(_shifted_bucket(rng)))
        if st.ready():
            r = st.refresh()
            triggers.append((i, r.trigger, r.refresh))
    return triggers, list(controller.monitor.events), controller.stats


def test_drift_controller_fires_same_triggers_as_jax(pre_shift_dir, tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(pre_shift_dir, jdir)
    shutil.copytree(pre_shift_dir, pdir)
    jst = JaxStreaming(
        JaxConfig(model=JaxModelConfig(feature_dim=CAPACITY, hidden_size=8,
                                       dropout_rate=0.0, rnn_backend="scan"),
                  train=JaxTrainConfig(**_train_kw())),
        JaxStreamConfig(**_stream_kw()), ckpt_dir=jdir,
        feature_config=JaxFeaturizeConfig(hash_features=True,
                                          capacity=CAPACITY))
    pst = StreamingTrainer(
        Config(model=ModelConfig(feature_dim=CAPACITY, hidden_size=8,
                                 dropout_rate=0.0),
               train=TrainConfig(**_train_kw())),
        StreamConfig(**_stream_kw()), ckpt_dir=pdir,
        feature_config=FeaturizeConfig(hash_features=True,
                                       capacity=CAPACITY),
        device="cpu")
    # both resume the same pre-shift retained corpus (the checkpoint holds
    # params and stats only), then arm their monitors from it
    for b in make_series_buckets(60, seed=3)[-48:]:
        jst.ingest(b)
        pst.ingest(Bucket.from_dict(b.to_dict()))
    jst._pending = pst._pending = 0
    jc = JaxDrift(jst, JaxQualityConfig(**_quality_kw()))
    pc = DriftController(pst, QualityConfig(**_quality_kw()))
    from deeprest_tpu.train.stream import RefreshResult as JaxResult
    from deeprest_tpu_torch.train.stream import RefreshResult

    jc.on_refresh(JaxResult(2, 48, 0.0, 0.0, None))
    pc.on_refresh(RefreshResult(2, 48, 0.0, 0.0, None))
    got_j = _drift_loop(jst, jc, lambda b: b)
    got_p = _drift_loop(pst, pc,
                        lambda b: Bucket.from_dict(b.to_dict()))
    assert got_p[0] == got_j[0]
    assert any(t == "drift" for _, t, _ in got_p[0]), got_p[0]
    assert got_p[1] == got_j[1]
    assert any(s == "feature_drift" and state == pq.VERDICT_DRIFT
               for _, s, state in got_p[1])
    assert got_p[2] == got_j[2]
    assert got_p[2]["retrains_triggered"] >= 1


def test_manual_override_and_force_retrain():
    pst = StreamingTrainer(
        Config(model=ModelConfig(feature_dim=CAPACITY, hidden_size=8,
                                 dropout_rate=0.0),
               train=TrainConfig(**_train_kw())),
        StreamConfig(**_stream_kw()),
        feature_config=FeaturizeConfig(hash_features=True,
                                       capacity=CAPACITY), device="cpu")
    qc = QualityConfig(**{**_quality_kw(), "auto_retrain": False,
                          "drift_enter": 0.15, "drift_exit": 0.05})
    controller = DriftController(pst, qc)
    for b in make_series_buckets(60, seed=3):
        pst.ingest(Bucket.from_dict(b.to_dict()))
        if pst.ready():
            pst.refresh()
    rng = np.random.default_rng(0)
    for _ in range(60):
        pst.ingest(Bucket.from_dict(_shifted_bucket(rng).to_dict()))
        if pst.ready():
            pst.refresh()
    assert controller.monitor.any_active(pq.VERDICT_DRIFT)
    assert controller.stats["retrains_triggered"] == 0
    assert controller.stats["suppressed"].get("manual-override", 0) >= 1
    controller.force_retrain()
    assert pst.ready() and pst.refresh().trigger == "manual"


# -- the verdict surface -----------------------------------------------------


def http(url, timeout=TIMEOUT):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_sweeps(fn, n=1, deadline_s=TIMEOUT):
    deadline = time.monotonic() + deadline_s
    v = fn()
    while time.monotonic() < deadline and v.get("sweeps", 0) < n:
        time.sleep(0.05)
        v = fn()
    return v


@pytest.fixture(scope="module")
def verdict_setup(pre_shift_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("verdict")
    raw = str(d / "raw.jsonl")
    rng = np.random.default_rng(1)
    buckets = make_series_buckets(40, seed=5) + [_shifted_bucket(rng)
                                                 for _ in range(20)]
    save_raw_data_jsonl(buckets, raw)
    return {"ckpt": pre_shift_dir, "raw": raw}


def _qc(cls):
    return cls(enabled=True, sweep_every_buckets=12, live_window=24)


def test_verdict_surface_matches_jax(verdict_setup):
    s = verdict_setup
    jpred = JaxPredictor.from_checkpoint(s["ckpt"])
    ppred = Predictor.from_checkpoint(s["ckpt"], device="cpu")
    assert ppred.space().to_dict() == jpred.space().to_dict()
    jsvc, psvc = JaxService(jpred), PredictionService(ppred)
    server = None
    try:
        # one poll reads the whole file: the monitor arms from the first
        # live_window buckets and sweeps once, in both packages
        jmon = jq.QualityMonitor(list(jpred.metric_names), _qc(
            JaxQualityConfig), registry=jax_obs_metrics.MetricsRegistry())
        pmon = pq.QualityMonitor(list(ppred.metric_names), _qc(
            QualityConfig), registry=obs_metrics.MetricsRegistry())
        jing = JaxIngestor(jsvc, JaxTailer(s["raw"]), jpred.space(), jmon,
                           poll_interval_s=0.02).start()
        ping = VerdictIngestor(psvc, BucketTailer(s["raw"]), ppred.space(),
                               pmon, poll_interval_s=0.02).start()
        jsvc.attach_quality(jmon, jing)
        psvc.attach_quality(pmon, ping)
        server = PredictionServer(psvc, port=0).start()
        host, port = server.address
        base = f"http://{host}:{port}"
        want = _wait_sweeps(jsvc.verdict)
        status, got = 200, _wait_sweeps(
            lambda: http(base + "/v1/verdict")[1])
        assert want["sweeps"] == 1
        assert_json_close(got, json.loads(json.dumps(want)))
        assert got["states"] == want["states"]
        health = http(base + "/healthz")[1]
        assert health["quality"]["sweeps"] == 1
        assert ping.errors == 0 and jing.errors == 0
    finally:
        if server is not None:
            server.stop()
        psvc.close()
        jsvc.close()
    assert ping._thread is None


def test_verdict_503_without_monitor_matches_jax(verdict_setup):
    ppred = Predictor.from_checkpoint(verdict_setup["ckpt"], device="cpu")
    jpred = JaxPredictor.from_checkpoint(verdict_setup["ckpt"])
    psvc, jsvc = PredictionService(ppred), JaxService(jpred)
    try:
        with pytest.raises(ServingError) as ep:
            psvc.verdict()
        with pytest.raises(JaxServingError) as ej:
            jsvc.verdict()
        assert ep.value.status == ej.value.status == 503
        assert str(ep.value) == str(ej.value)
    finally:
        psvc.close()
        jsvc.close()


def test_serve_cli_verdict_raw(verdict_setup):
    s = verdict_setup
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeprest_tpu_torch", "serve", "--ckpt-dir",
         s["ckpt"], "--verdict-raw", s["raw"], "--verdict-sweep-every", "12",
         "--verdict-live-window", "24", "--port", "0", "--deadline", "30",
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], TIMEOUT)
        assert ready, "serve printed no startup line"
        line = json.loads(proc.stdout.readline())
        assert line["verdict"] == {"raw": s["raw"], "wire": None,
                                   "sweep_every": 12}
        base = line["listening"]
        v = _wait_sweeps(lambda: http(base + "/v1/verdict")[1])
        assert v["sweeps"] >= 1 and v["armed"]
        assert sum(v["states"].values()) == len(v["metrics"])
        health = http(base + "/healthz")[1]
        assert health["quality"]["sweeps"] >= 1
        status, text = 200, urllib.request.urlopen(
            base + "/metrics", timeout=TIMEOUT).read().decode()
        assert "deeprest_quality_verdict{" in text
    finally:
        proc.kill()
        proc.communicate(timeout=TIMEOUT)
    with pytest.raises(SystemExit, match="pick one"):
        from deeprest_tpu_torch.cli import main

        main(["serve", "--ckpt-dir", s["ckpt"], "--verdict-raw", s["raw"],
              "--verdict-wire-listen", "127.0.0.1:0", "--device", "cpu",
              "--port", "0", "--deadline", "0.01"])
