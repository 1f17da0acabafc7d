"""The serving plane's captured CUDA graphs (serve/graphs.py) on the card.

Needs an NVIDIA GPU and nvcc (the graphs replay the K1 kernel, which has
no CPU mode); without CUDA every test here skips.  Run on the card (the
repository's conftest imports JAX, which the GPU machine does not have):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_serve.py

Captured and eager engines run the same kernels on the same values, so
they must agree bit for bit, over many pages, with and without the delta
carry chained between pages.  The sparse feed's engines (padded-COO pages
densified on the device) must give the dense engines' answers bit for bit,
and their captured graphs the eager ones'; a quantized predictor's
captured graphs (dequant at use) equal its eager ones; an exported
artifact placed on the card runs K1 through the registered operator.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.models.qrnn import init_params
from deeprest_tpu_torch.ops import cuda_gru
from deeprest_tpu_torch.ops.densify import sparsify_rows
from deeprest_tpu_torch.serve.fused import plan_windows
from deeprest_tpu_torch.serve.graphs import RungGraphs
from deeprest_tpu_torch.graphs import GraphCaptureError
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.server import PredictionService

F, E, H, W = 16, 5, 64, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs replay K1, which has "
                    "no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make(graphs: bool, delta: bool, dtype="bfloat16", coalesce_pages=1,
         seed=0, **kwargs):
    cfg = ModelConfig(feature_dim=F, num_metrics=E, hidden_size=H,
                      compute_dtype=dtype, dropout_rate=0.0)
    rng = np.random.default_rng(0)
    y_min = rng.uniform(0.0, 1.0, E).astype(np.float32)
    return Predictor(
        init_params(cfg, seed=seed), cfg,
        x_stats=MinMaxStats(min=np.float32(0.0), max=np.float32(20.0)),
        y_stats=MinMaxStats(min=y_min, max=y_min + 5.0),
        metric_names=[f"c{i}" for i in range(E)], window_size=W,
        delta_mask=np.arange(E) % 2 == 1 if delta else None,
        coalesce_pages=coalesce_pages,
        ladder=(4, 8), page_windows=8, device="cuda", cuda_graphs=graphs,
        **kwargs)


def series(n, seed=1):
    rng = np.random.default_rng(seed)
    lengths = [37 * W + 5, 3 * W, W + 1, 25 * W, 9 * W + 11][:n]
    return [rng.poisson(4.0, (t, F)).astype(np.float32) for t in lengths]


def run_threads(worker, n: int) -> None:
    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [False, True])
def test_captured_engine_equals_eager_bit_for_bit(cuda, delta):
    captured, eager = make(True, delta), make(False, delta)
    many = series(5)
    pages = -(-len(plan_windows([len(s) for s in many], W)) // 8)
    assert pages >= 8
    for integrate in (True, False):
        got = captured.predict_series_many(many, integrate=integrate)
        want = eager.predict_series_many(many, integrate=integrate)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(2).random((11, W, F)).astype(np.float32)
    np.testing.assert_array_equal(captured.apply_windows(x),
                                  eager.apply_windows(x))
    stats = captured.graphs.stats()
    assert stats["captured"] and stats["captures"] == len(stats["rungs"])
    assert stats["replays"] > stats["captures"]
    assert eager.graphs.stats()["captures"] == 0


@pytest.mark.cuda
def test_warm_captures_every_rung_and_none_after(cuda):
    pred = make(True, True, coalesce_pages=2, coalesce_groups=2)
    stats = pred.warm()
    keys = len(pred.ladder.ladder) + 2 * len(pred.fused.rungs)
    assert stats["captures"] == keys == pred.jit_cache_size()
    pred.predict_series_many(series(5))
    pred.predict_series(series(1)[0], integrate=False)
    pred.apply_windows(np.zeros((13, W, F), np.float32))
    after = pred.jit_cache_stats()
    assert after["captures"] == keys and after["captures_after_warmup"] == 0


@pytest.mark.cuda
def test_launch_ledger_counts_replays(cuda):
    pred = make(True, False)
    pred.warm()
    before = cuda_gru.GRU_FWD.launches
    replays = pred.graphs.stats()["replays"]
    pred.predict_series_many(series(2))
    per_page = 2          # bidirectional: one K1 launch per direction
    pages = pred.graphs.stats()["replays"] - replays
    assert cuda_gru.GRU_FWD.launches - before == per_page * pages


@pytest.mark.cuda
def test_concurrent_ladder_replays_equal_sequential(cuda):
    pred = make(True, False)
    pred.warm()
    inputs = [np.random.default_rng(i).random((1 + i % 8, W, F)).astype(
        np.float32) for i in range(16)]
    want = [pred.apply_windows(x) for x in inputs]
    got = [None] * len(inputs)

    def worker(i):
        got[i] = pred.apply_windows(inputs[i])

    run_threads(worker, len(inputs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_concurrent_engine_replays_equal_sequential(cuda):
    """Threads replaying the fused rungs (with the delta carry chained
    between pages) and the ladder's rungs at once: every answer equals
    the sequential one bit for bit, so no thread reads another's static
    buffers or a pinned page before its copy landed."""
    pred = make(True, True)
    pred.warm()
    groups = [series(1 + i % 5, seed=i) for i in range(12)]
    windows = [np.random.default_rng(i).random((1 + i % 8, W, F)).astype(
        np.float32) for i in range(12)]
    want = [pred.predict_series_many(g, integrate=i % 3 != 0)
            for i, g in enumerate(groups)]
    want_w = [pred.apply_windows(x) for x in windows]
    got, got_w = [None] * len(groups), [None] * len(windows)

    def worker(i):
        for _ in range(3):
            got[i] = pred.predict_series_many(groups[i],
                                              integrate=i % 3 != 0)
            got_w[i] = pred.apply_windows(windows[i])

    run_threads(worker, len(groups))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got_w, want_w):
        np.testing.assert_array_equal(g, w)
    assert pred.graphs.stats()["captures_after_warmup"] == 0


@pytest.mark.cuda
def test_reload_captures_while_requests_replay(cuda):
    """A hot reload's warm-up captures a fresh predictor's graphs while
    request threads replay the served one's, then swaps it in: every
    answer equals the old or the new predictor's sequential answer bit
    for bit, and the fresh predictor captures nothing after its warm-up."""
    old, fresh = make(True, True), make(True, True, seed=1)
    bodies = series(5, seed=3)
    old.warm()
    want_old = [old.predict_series(s) for s in bodies]
    service = PredictionService(old)
    stop = threading.Event()
    answers = []

    def worker(i):
        k = i
        while not stop.is_set():
            body = bodies[k % len(bodies)]
            out = service.predict({"traffic": body.tolist()})
            answers.append((k % len(bodies),
                            np.asarray(out["predictions"], np.float32)))
            k += 1

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(8)]
    try:
        for t in threads:
            t.start()
        stats = fresh.warm()              # captures while others replay
        service.reload_from(fresh, reason="watch")
        served = len(answers)
        deadline = time.monotonic() + 60
        while len(answers) < served + 32 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        service.close()
    assert not any(t.is_alive() for t in threads)
    want_new = [fresh.predict_series(s) for s in bodies]
    assert stats["captures"] == len(stats["rungs"]) > 0
    assert fresh.graphs.stats()["captures_after_warmup"] == 0
    from_new = 0
    for k, got in answers:
        old_f32 = np.asarray(want_old[k], np.float32)
        new_f32 = np.asarray(want_new[k], np.float32)
        same_new = np.array_equal(got, new_f32)
        assert same_new or np.array_equal(got, old_f32)
        from_new += same_new
    assert from_new >= 16 and service.reloads == 1


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    graphs = RungGraphs(cuda)
    x = torch.ones((4,), device=cuda)
    with torch.inference_mode(), pytest.raises(GraphCaptureError,
                                               match="bad at rung 4"):
        graphs.run(("bad", 4), lambda t: t * float(t.sum().item()), (x,))
    assert graphs.stats()["captures"] == 0


def sparse_series(many, k=F):
    return [sparsify_rows(s, k)[:2] for s in many]


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [False, True])
def test_sparse_engine_equals_dense_bit_for_bit(cuda, delta):
    sparse = make(True, delta, sparse_feed=True, sparse_nnz_cap=F)
    eager_sparse = make(False, delta, sparse_feed=True, sparse_nnz_cap=F)
    dense = make(True, delta)
    many = series(5)
    coo = sparse_series(many)
    stats = sparse.warm()
    assert sparse.graphs.size("sparse") > 0 == stats["captures_after_warmup"]
    for integrate in (True, False):
        want = dense.predict_series_many(many, integrate=integrate)
        got = sparse.predict_series_many_sparse(coo, integrate=integrate)
        eager = eager_sparse.predict_series_many_sparse(
            coo, integrate=integrate)
        for g, e, w in zip(got, eager, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(e, w)
    cols = np.stack([c[:W] for c, _ in coo[:3]])
    vals = np.stack([v[:W] for _, v in coo[:3]])
    x = sparse.x_stats.apply(np.stack([s[:W] for s in many[:3]]))
    np.testing.assert_array_equal(sparse.apply_windows_sparse(cols, vals),
                                  dense.apply_windows(x.astype(np.float32)))
    assert sparse.jit_cache_stats()["captures_after_warmup"] == 0
    assert sparse.fused.stats()["sparse_pages"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_quantized_captured_equals_eager(cuda, quant):
    captured, eager = make(True, True, quant=quant), make(False, True,
                                                          quant=quant)
    assert captured.parity_envelope["mode"] == quant
    many = series(3)
    for g, w in zip(captured.predict_series_many(many),
                    eager.predict_series_many(many)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_exported_artifact_launches_k1_on_the_card(cuda, tmp_path):
    from deeprest_tpu_torch.serve.export import (
        ExportedPredictor, export_predictor,
    )

    pred = make(True, True)
    export_predictor(pred, str(tmp_path / "art"))
    art = ExportedPredictor.load(str(tmp_path / "art"), ladder=(4, 8),
                                 page_windows=8, coalesce_pages=1,
                                 device="cuda")
    art.warm()
    before = cuda_gru.GRU_FWD.launches
    many = series(3)
    for g, w in zip(art.predict_series_many(many),
                    pred.predict_series_many(many)):
        np.testing.assert_array_equal(g, w)
    assert cuda_gru.GRU_FWD.launches > before
    assert art.jit_cache_stats()["captures_after_warmup"] == 0


@pytest.mark.cuda
def test_verdict_sweeps_on_rung_graphs_equal_eager(cuda):
    """``/v1/verdict`` on the card: the quality monitor's sweeps go through
    the served predictor's rung graphs (a single window lands on the
    smallest rung, captured at warm-up, none after) and give the verdict an
    eager predictor gives on the same rows."""
    import json
    import urllib.request

    from deeprest_tpu_torch.config import QualityConfig
    from deeprest_tpu_torch.obs.metrics import MetricsRegistry
    from deeprest_tpu_torch.obs.quality import QualityMonitor
    from deeprest_tpu_torch.serve.server import PredictionServer

    rng = np.random.default_rng(3)
    rows = [(np.sort(rng.choice(F, 4, replace=False)).astype(np.int32),
             rng.poisson(4.0, 4).astype(np.float32) + 1.0,
             rng.uniform(0.0, 6.0, E).astype(np.float32))
            for _ in range(4 * W)]
    out = {}
    for graphs in (True, False):
        pred = make(graphs, delta=True, dtype="float32")
        pred.warm()
        qc = QualityConfig(enabled=True, sweep_every_buckets=W,
                           live_window=2 * W, min_sweep_buckets=W)
        monitor = QualityMonitor(pred.metric_names, qc,
                                 registry=MetricsRegistry())
        for i, (cols, vals, y) in enumerate(rows):
            monitor.observe(cols, vals, y)
            if i == 2 * W - 1:
                monitor.rebase_reference()
            if i >= 2 * W and (i + 1) % W == 0:
                assert monitor.sweep(pred)["armed"]
        svc = PredictionService(pred)
        svc.attach_quality(monitor)
        server = PredictionServer(svc, port=0).start()
        try:
            host, port = server.address
            with urllib.request.urlopen(
                    f"http://{host}:{port}/v1/verdict", timeout=60) as r:
                out[graphs] = json.loads(r.read())
            health = svc.healthz()
        finally:
            server.stop()
        if graphs:
            assert health["jit_cache"]["captures_after_warmup"] == 0
            assert health["jit_cache"]["replays"] > 0
    assert out[True]["sweeps"] == 2
    assert out[True] == out[False]
