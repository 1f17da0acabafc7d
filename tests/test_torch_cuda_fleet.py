"""The fleet tier's shared rung graphs (serve/fleet.py, the bound slot of
serve/graphs.py) on the card.

Needs an NVIDIA GPU and nvcc (the graphs replay the K1 kernel, which has
no CPU mode); without CUDA every test here skips.  Run on the card (the
repository's conftest imports JAX, which the GPU machine does not have):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_fleet.py

A captured graph reads the addresses its program closed over at capture,
so tenants sharing one plane's graphs are each bound into its slot before
a replay.  Two tenants alternated on one plane must each answer bit for
bit as their own standalone predictor on its own graphs, with the plane's
graph count no larger than one predictor's and nothing captured after
warm-up; a spill to pinned host memory and a restore between replays
must change no bit.
"""

import numpy as np
import pytest
import torch

from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.models.qrnn import init_params
from deeprest_tpu_torch.ops.densify import sparsify_rows
from deeprest_tpu_torch.serve.fleet import PredictorPool
from deeprest_tpu_torch.serve.predictor import Predictor

F, E, H, W = 16, 5, 64, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs replay K1, which has "
                    "no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def make(scale: float, **kwargs) -> Predictor:
    cfg = ModelConfig(feature_dim=F, num_metrics=E, hidden_size=H,
                      compute_dtype="bfloat16", dropout_rate=0.0)
    rng = np.random.default_rng(0)
    y_min = rng.uniform(0.0, 1.0, E).astype(np.float32)
    params = {k: v * np.float32(scale)
              for k, v in init_params(cfg, seed=0).items()}
    return Predictor(
        params, cfg,
        x_stats=MinMaxStats(min=np.float32(0.0), max=np.float32(20.0)),
        y_stats=MinMaxStats(min=y_min, max=y_min + 5.0 * scale),
        metric_names=[f"c{i}" for i in range(E)], window_size=W,
        delta_mask=np.arange(E) % 2 == 1, ladder=(8, 16),
        coalesce_pages=2, device="cuda", **kwargs)


def series(n: int = 3, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [rng.poisson(rng.uniform(0.5, 10.0, F),
                        (int(rng.integers(W, 40 * W)), F)).astype(np.float32)
            for _ in range(n)]


def answers(pred, traffic, sparse: bool) -> list:
    out = list(pred.predict_series_many(traffic))
    out.append(pred.apply_windows(np.stack(
        [traffic[0][:W], traffic[0][W:2 * W]]) / 20.0))
    if sparse:
        cols, vals, _ = sparsify_rows(traffic[1], F)
        out.append(pred.predict_series_sparse(cols, vals))
    return out


def same(a: list, b: list) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", [False, True])
def test_alternated_tenants_equal_their_standalone_predictors(cuda, sparse):
    knobs = dict(sparse_feed=True, sparse_nnz_cap=F) if sparse else {}
    traffic = series()
    alone = {}
    for s in (1.0, 1.5):
        p = make(s, **knobs)
        graphs = p.warm()
        alone[s] = (answers(p, traffic, sparse), graphs["captures"])
        del p
    assert not same(alone[1.0][0], alone[1.5][0])
    pool = PredictorPool(hbm_budget=2, aot=False)
    pool.admit("a", make(1.0, **knobs))
    pool.admit("b", make(1.5, **knobs))
    a = pool.resolve("a").predictor()
    a.warm()
    pool.freeze()
    for _ in range(3):
        for name, s in (("a", 1.0), ("b", 1.5)):
            got = answers(pool.resolve(name).predictor(), traffic, sparse)
            assert same(got, alone[s][0]), (name, sparse)
    stats = a.plane.graphs.stats()
    assert stats["captured"] and stats["captures"] == alone[1.0][1]
    assert stats["captures_after_warmup"] == 0
    assert pool.assert_frozen() == a.plane.jit_cache_size()
    assert a.plane.graphs.slot.binds >= 5


@pytest.mark.cuda
def test_spill_and_restore_between_replays_change_no_bit(cuda):
    traffic = series(seed=2)
    pool = PredictorPool(hbm_budget=1, aot=False)
    pool.admit("a", make(1.0))
    pool.resolve("a").predictor().warm()
    ref_a = answers(pool.resolve("a").predictor(), traffic, False)
    held = pool.resolve("a").predictor()
    pool.admit("b", make(1.5))                   # spills a to pinned host
    ref_b = answers(pool.resolve("b").predictor(), traffic, False)
    spill = pool.peek("a")._tenant_spill
    assert all(t.device.type == "cpu" and t.is_pinned()
               for t in spill.values())
    # resolved before its spill: binds from pinned host memory
    assert same(answers(held, traffic, False), ref_a)
    for _ in range(2):
        assert same(answers(pool.resolve("a").predictor(), traffic, False),
                    ref_a)
        assert same(answers(pool.resolve("b").predictor(), traffic, False),
                    ref_b)
    st = pool.stats()
    assert st["spills"] >= 3 and st["restores"] >= 2
    assert held.plane.graphs.stats()["captures_after_warmup"] == 0
    # a spilled tenant holds no device tensor
    assert all(t.device.type == "cpu"
               for t in pool.peek("a").predictor().bound_state().values())
