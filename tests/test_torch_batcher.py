"""The port's MicroBatcher and extended ShapeLadder (serve/batcher.py), on
the CPU: concurrent submits coalesce and come back bit for bit equal to
per-request ``apply_windows``; super-rungs; the flush policy; ``close`` and
``BatcherClosed``; ``stats()`` keys equal to the JAX package's; and the
predictor's rung ledger (serve/graphs.py) with ``warm`` and the JAX names
``jit_cache_size`` / ``jit_cache_stats``.

The model is the JAX package's random init at tiny dims, loaded into the
port's Predictor: batching semantics do not depend on trained weights.
Every batcher started here is closed in a ``finally``; every wait has a
timeout and every thread is a daemon.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.models.qrnn import QuantileGRU as JaxQuantileGRU
from deeprest_tpu.serve.batcher import BatcherConfig as JaxBatcherConfig
from deeprest_tpu.serve.batcher import MicroBatcher as JaxMicroBatcher
from deeprest_tpu.serve.batcher import ShapeLadder as JaxShapeLadder
from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.serve.batcher import (
    BatcherClosed, BatcherConfig, MicroBatcher, ShapeLadder,
)
from deeprest_tpu_torch.serve.predictor import Predictor

F, E, H, W = 6, 3, 8, 8
TIMEOUT = 30


def make_predictor(ladder, coalesce_groups=1, delta=False):
    mc = dict(feature_dim=F, num_metrics=E, hidden_size=H, dropout_rate=0.0)
    params = JaxQuantileGRU(config=JaxModelConfig(**mc)).init(
        jax.random.PRNGKey(0), np.zeros((1, W, F), np.float32),
        deterministic=True)["params"]
    return Predictor(
        params_from_jax(params), ModelConfig(**mc),
        x_stats=MinMaxStats(min=np.float32(0.0), max=np.float32(1.0)),
        y_stats=MinMaxStats(min=np.zeros((E,), np.float32),
                            max=np.ones((E,), np.float32)),
        metric_names=[f"c{i}_cpu" for i in range(E)], window_size=W,
        delta_mask=np.array([False, True, False]) if delta else None,
        ladder=ladder, coalesce_groups=coalesce_groups, device="cpu")


def windows(n, seed):
    return np.random.default_rng(seed).random((n, W, F)).astype(np.float32)


def test_concurrent_submits_coalesce_bit_identical():
    """One rung (8), so coalesced and per-request dispatches run the same
    shape and must agree bit for bit."""
    pred = make_predictor((8,))
    sizes = [1, 3, 2, 1, 2, 4, 1, 3]
    inputs = [windows(n, i) for i, n in enumerate(sizes)]
    want = [pred.apply_windows(x) for x in inputs]
    mb = MicroBatcher(pred.ladder, BatcherConfig(max_batch=8,
                                                 max_linger_s=0.2))
    pred.attach_batcher(mb)
    got = [None] * len(inputs)
    barrier = threading.Barrier(len(inputs))

    def worker(i):
        barrier.wait(TIMEOUT)
        got[i] = pred.apply_windows(inputs[i])

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(inputs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        stats = mb.stats()
        assert stats["submitted"] == len(inputs)
        assert stats["coalesced_batches"] >= 1
        assert stats["batches"] < len(inputs)
    finally:
        pred.attach_batcher(None)
        mb.close()


def test_super_rungs_dispatch_one_fat_batch():
    seen = []

    def apply_fn(x):
        seen.append(len(x))
        return torch.from_numpy(x[:, :, :E, None].repeat(3, axis=-1).copy())

    ladder = ShapeLadder(apply_fn, (2, 4), coalesce_groups=3)
    assert ladder.ladder == (2, 4, 8, 12) and ladder.base_ladder == (2, 4)
    x = windows(10, 0)
    out = ladder(x)
    assert seen == [12]
    np.testing.assert_array_equal(out[..., 0], x[:, :, :E])
    ladder(windows(13, 1))
    assert seen == [12, 12, 2]
    stats = ladder.stats()
    assert stats["compiled_rungs"] == [2, 12]
    assert (stats["calls"], stats["windows"], stats["padded_windows"]) == (
        3, 23, 3)
    with pytest.raises(ValueError, match="coalesce_groups"):
        ShapeLadder(apply_fn, (2,), coalesce_groups=0)
    with pytest.raises(ValueError, match="bad shape ladder"):
        ShapeLadder(apply_fn, ())


def test_predictor_super_rungs_match_base_rungs():
    """Predictions through a top·G super-rung equal the base ladder's,
    and the fused engine keeps the base rungs (as in the JAX package)."""
    base = make_predictor((4, 8))
    wide = make_predictor((4, 8), coalesce_groups=3)
    assert wide.ladder.ladder == (4, 8, 16, 24)
    assert wide.fused.rungs == base.fused.rungs
    x = windows(20, 3)
    np.testing.assert_allclose(wide.apply_windows(x), base.apply_windows(x),
                               rtol=1e-6, atol=1e-7)
    assert wide.ladder.stats()["compiled_rungs"] == [24]


class _GatedApply:
    """Stub apply that can hold the worker inside a dispatch, so a test can
    stage a backlog."""

    def __init__(self):
        self.batches = []
        self.gate = threading.Event()
        self.gate.set()

    def __call__(self, x):
        self.gate.wait(timeout=TIMEOUT)
        self.batches.append(len(x))
        return torch.zeros((len(x), W, E, 3))


def test_flush_honors_max_batch():
    stub = _GatedApply()
    stub.gate.clear()
    mb = MicroBatcher(ShapeLadder(stub, (4,)),
                      BatcherConfig(max_batch=4, max_linger_s=0.01,
                                    max_queue=64))
    try:
        futs = [mb.submit(np.zeros((2, W, F), np.float32)) for _ in range(5)]
        stub.gate.set()
        for f in futs:
            assert f.result(timeout=TIMEOUT).shape == (2, W, E, 3)
        stats = mb.stats()
        assert stats["batches"] >= 3
        assert stats["max_batch_windows"] <= 4
        assert stats["coalesced_batches"] >= 1
        assert max(stub.batches) <= 4
    finally:
        mb.close()


def test_lone_request_flushes_at_linger_deadline():
    mb = MicroBatcher(ShapeLadder(_GatedApply(), (8,)),
                      BatcherConfig(max_batch=8, max_linger_s=0.15,
                                    max_queue=64))
    try:
        t0 = time.monotonic()
        mb.apply(np.zeros((2, W, F), np.float32))
        assert 0.10 <= time.monotonic() - t0 < 5.0
        assert mb.stats()["flush_linger"] >= 1
        t0 = time.monotonic()
        mb.apply(np.zeros((8, W, F), np.float32))
        assert time.monotonic() - t0 < 0.10
        assert mb.stats()["flush_full"] >= 1
    finally:
        mb.close()


def test_errors_reach_every_future():
    def boom(x):
        raise RuntimeError("device on fire")

    mb = MicroBatcher(ShapeLadder(boom, (8,)), BatcherConfig(max_linger_s=0.02))
    try:
        futs = [mb.submit(np.zeros((1, W, F), np.float32)) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device on fire"):
                f.result(timeout=TIMEOUT)
        assert mb.stats()["errors"] >= 1
    finally:
        mb.close()


def test_close_raises_batcher_closed_and_backend_falls_back():
    pred = make_predictor((8,))
    x = windows(3, 5)
    want = pred.apply_windows(x)
    mb = MicroBatcher(pred.ladder, BatcherConfig())
    pred.attach_batcher(mb)
    np.testing.assert_array_equal(pred.apply_windows(x), want)
    mb.close()
    with pytest.raises(BatcherClosed):
        mb.submit(x)
    # a request that lost the hot-reload race takes the direct ladder path
    np.testing.assert_array_equal(pred.apply_windows(x), want)
    with pytest.raises(ValueError, match="non-empty"):
        MicroBatcher(pred.ladder).submit(np.zeros((0, W, F), np.float32))


def test_config_validation_matches_jax():
    for kwargs in (dict(max_batch=64, max_queue=8), dict(max_batch=0),
                   dict(max_linger_s=-1.0)):
        with pytest.raises(ValueError) as got:
            BatcherConfig(**kwargs)
        with pytest.raises(ValueError) as want:
            JaxBatcherConfig(**kwargs)
        assert str(got.value) == str(want.value)


def test_stats_keys_match_jax():
    port = MicroBatcher(ShapeLadder(_GatedApply(), (2, 4), coalesce_groups=2),
                        BatcherConfig(max_batch=4))
    ref = JaxMicroBatcher(
        JaxShapeLadder(lambda x: np.zeros((len(x), W, E, 3), np.float32),
                       (2, 4), coalesce_groups=2),
        JaxBatcherConfig(max_batch=4))
    try:
        for mb in (port, ref):
            mb.apply(np.zeros((3, W, F), np.float32))
        got, want = port.stats(), ref.stats()
        assert set(got) == set(want)
        assert got["shape_ladder"] == want["shape_ladder"]
        for key in ("submitted", "batches", "windows", "max_batch",
                    "queue_depth_windows", "errors"):
            assert got[key] == want[key]
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("delta", [False, True])
def test_warm_dispatches_every_rung_and_nothing_after(delta):
    pred = make_predictor((2, 4, 8), delta=delta)
    assert pred.jit_cache_size() == 0
    stats = pred.warm()
    programs = 2 if delta else 1
    keys = len(pred.ladder.ladder) + programs * len(pred.fused.rungs)
    assert len(stats["rungs"]) == keys == pred.jit_cache_size()
    assert stats["captured"] is False and stats["captures"] == 0
    traffic = np.random.default_rng(0).random((23 * W + 5, F)).astype(
        np.float32)
    pred.predict_series(traffic)
    pred.predict_series(traffic, integrate=False)
    pred.apply_windows(windows(7, 2))
    assert pred.jit_cache_size() == keys
    cache = pred.jit_cache_stats()
    assert cache["apply"] == len(pred.ladder.ladder)
    assert cache["fused"] == programs * len(pred.fused.rungs)
    assert cache["captures_after_warmup"] == 0 and cache["apply_sparse"] is None
    fused = pred.fused.stats()
    assert fused["dispatched_rungs"] and fused["graphs"]["rungs"]


def test_fused_route_follows_the_batcher_as_in_jax():
    """With a batcher attached, series of at most ladder.max_rung windows
    go through it; longer ones take the fused engine."""
    pred = make_predictor((2, 4))
    mb = MicroBatcher(pred.ladder, BatcherConfig(max_batch=4))
    pred.attach_batcher(mb)
    rng = np.random.default_rng(1)
    try:
        pred.predict_series(rng.random((4 * W, F)).astype(np.float32))
        assert (mb.stats()["submitted"], pred.fused.stats()["pages"]) == (1, 0)
        pred.predict_series(rng.random((4 * W + 1, F)).astype(np.float32))
        assert mb.stats()["submitted"] == 1 and pred.fused.stats()["pages"]
    finally:
        pred.attach_batcher(None)
        mb.close()
