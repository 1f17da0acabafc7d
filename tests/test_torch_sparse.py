"""The port's sparse (padded-COO) feed against the JAX package's, on the
CPU, at a small size (F=256 hashed columns, K=8, E=3, H=16, T=12, B=4).

- Densify: ``densify_coo`` and ``gather_densify_normalize`` bit-equal to
  JAX's; ``densify_rows``, ``sparsify_rows`` (with its overflow message)
  and ``sparse_minmax`` equal.
- Featurize: ``extract_sparse``, ``trace_columns_from_dict``,
  ``sparse_from_columns`` and ``parallel_extract_sparse_lines`` (serial and
  through a fork pool) equal to JAX's on the same traces.
- Trainer: the port's sparse-feed ``Trainer`` within 1e-5 of the JAX
  sparse-feed ``Trainer`` in per-step loss and 1e-4 of each leaf's largest
  magnitude in params (dropout 0, S=1 and "auto"); the port's sparse feed
  bit-identical to its own dense feed; the refusals with JAX's messages.
- Fused engine: port sparse against JAX sparse within 1e-5, with and
  without ``integrate``; port sparse against port dense bit for bit; a K
  mismatch raises; a row over the cap takes the warned-once dense path.
"""

import dataclasses
import json
import multiprocessing

import numpy as np
import pytest
import torch

from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data import featurize as jax_featurize
from deeprest_tpu.ops import densify as jax_densify
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.train.checkpoint import save_checkpoint
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu.workload import SCENARIOS as JAX_SCENARIOS
from deeprest_tpu.workload.simulator import simulate_corpus as jax_simulate
from deeprest_tpu_torch.config import Config, FeaturizeConfig, ModelConfig
from deeprest_tpu_torch.config import TrainConfig
from deeprest_tpu_torch.data import featurize
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.data.schema import Bucket
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.ops import densify
from deeprest_tpu_torch.serve import fused as port_fused
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer

F, K, E, H, W, B = 256, 8, 3, 16, 12, 4
NAMES = ["c0_cpu", "c1_usage", "c2_memory"]
SPACE = {"config": {"capacity": F, "round_to": 128, "hash_features": True,
                    "hash_seed": 0x5EED},
         "vocabulary": [], "frozen_capacity": F}


def coo_rows(n, seed=0, lo=1, hi=K):
    """``n`` dense rows of F columns, each lo..hi-1 nonzero counts."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n, F), np.float32)
    for row in x:
        m = int(rng.integers(lo, hi))
        row[rng.choice(F, m, replace=False)] = rng.integers(1, 40, m)
    return x


def corpora(minutes=150):
    """(JAX FeaturizedData, port FeaturizedData) of one seeded corpus of
    sparse call-path counts and E resource series."""
    traffic = coo_rows(minutes, seed=5)
    rng = np.random.default_rng(6)
    resources = {}
    for name in NAMES:
        level = traffic @ (rng.random(F) * (rng.random(F) < 0.3))
        if name.endswith("usage"):
            level = np.cumsum(level) / minutes
        resources[name] = (level + rng.normal(0, 0.1, minutes)).astype(
            np.float32)
    jax_data = jax_featurize.FeaturizedData(
        traffic=traffic, resources=dict(resources), invocations={},
        space=jax_featurize.CallPathSpace.from_dict(SPACE))
    port = FeaturizedData(traffic=traffic, resources=dict(resources),
                          invocations={},
                          space=CallPathSpace.from_dict(SPACE))
    return jax_data, port


# -- densify ----------------------------------------------------------------


def test_densify_coo_bit_equal_to_jax():
    dense = coo_rows(40, seed=1).reshape(5, 8, F)
    cols, vals, _ = jax_densify.sparsify_rows(dense, K)
    want = np.asarray(jax_densify.densify_coo(cols, vals, F))
    got = densify.densify_coo(torch.from_numpy(cols),
                              torch.from_numpy(vals), F).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, dense)


def test_gather_densify_normalize_bit_equal_to_jax():
    import jax.numpy as jnp

    dense = coo_rows(30, seed=2)
    cols, vals, _ = densify.sparsify_rows(dense, K)
    mn, rg = np.float32([0.5]), np.float32([37.0])
    idx = np.arange(3)[:, None] + np.arange(W)[None, :]
    jbase = jax_densify.SparseBase(cols=jnp.asarray(cols),
                                   vals=jnp.asarray(vals),
                                   mn=jnp.asarray(mn), rg=jnp.asarray(rg),
                                   capacity=F)
    want = np.asarray(jax_densify.gather_densify_normalize(
        jbase, jnp.asarray(idx)))
    base = densify.SparseBase(cols=torch.from_numpy(cols),
                              vals=torch.from_numpy(vals),
                              mn=torch.from_numpy(mn),
                              rg=torch.from_numpy(rg), capacity=F)
    got = densify.gather_densify_normalize(base,
                                           torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    zero = dataclasses.replace(base, rg=torch.zeros(1))
    np.testing.assert_array_equal(
        densify.gather_densify_normalize(zero, torch.from_numpy(idx)),
        dense[idx])


def test_host_twins_equal_jax():
    dense = coo_rows(50, seed=3).reshape(5, 10, F)
    got, want = densify.sparsify_rows(dense, K), \
        jax_densify.sparsify_rows(dense, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        densify.densify_rows(got[0], got[1], F),
        jax_densify.densify_rows(want[0], want[1], F))
    np.testing.assert_array_equal(densify.densify_rows(got[0], got[1], F),
                                  dense)
    flat = [a.reshape(50, -1) if a.ndim == 3 else a.reshape(50)
            for a in got]
    for span in (1, 17, 50):
        s_got = densify.sparse_minmax(*flat, span, F)
        s_want = jax_densify.sparse_minmax(*flat, span, F)
        np.testing.assert_array_equal(s_got.min, s_want.min)
        np.testing.assert_array_equal(s_got.max, s_want.max)
    assert densify.DEFAULT_NNZ_CAP == jax_densify.DEFAULT_NNZ_CAP
    fat = coo_rows(3, seed=4, lo=K + 1, hi=K + 2)
    with pytest.raises(ValueError) as port_err:
        densify.sparsify_rows(fat, K)
    with pytest.raises(ValueError) as jax_err:
        jax_densify.sparsify_rows(fat, K)
    assert str(port_err.value) == str(jax_err.value)


# -- featurize --------------------------------------------------------------


@pytest.fixture(scope="module")
def social():
    jax_buckets = jax_simulate(JAX_SCENARIOS["normal"](0), 12)
    port_buckets = [Bucket.from_dict(b.to_dict()) for b in jax_buckets]
    return jax_buckets, port_buckets


@pytest.mark.parametrize("hashed", [True, False], ids=["hash", "dict"])
def test_extract_sparse_equals_jax(social, hashed):
    jax_buckets, port_buckets = social
    cfg = dict(hash_features=True, capacity=F) if hashed else dict(
        round_to=8)
    jspace = jax_featurize.CallPathSpace.fit(jax_buckets,
                                             JaxFeaturizeConfig(**cfg))
    pspace = featurize.CallPathSpace.fit(port_buckets, FeaturizeConfig(**cfg))
    for jb, pb in zip(jax_buckets, port_buckets):
        for got, want in zip(pspace.extract_sparse(pb.traces),
                             jspace.extract_sparse(jb.traces)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        parts = [pspace.trace_columns_from_dict(t.to_dict())
                 for t in pb.traces]
        jparts = [jspace.trace_columns_from_dict(t.to_dict())
                  for t in jb.traces]
        for g, w in zip(parts, jparts):
            np.testing.assert_array_equal(g, w)
        for got, want in zip(pspace.sparse_from_columns(parts),
                             jspace.sparse_from_columns(jparts)):
            np.testing.assert_array_equal(got, want)
        cols, counts = pspace.extract_sparse(pb.traces)
        dense = np.zeros(pspace.capacity, np.float32)
        dense[cols] = counts
        np.testing.assert_array_equal(dense, pspace.extract(pb.traces))


def test_parallel_extract_sparse_lines_equals_jax(social):
    jax_buckets, _ = social
    lines = [json.dumps(b.to_dict()).encode() for b in jax_buckets]
    jspace = jax_featurize.CallPathSpace(
        config=JaxFeaturizeConfig(hash_features=True, capacity=F))
    want = jax_featurize.parallel_extract_sparse_lines(lines, jspace)
    pspace = featurize.CallPathSpace(
        config=FeaturizeConfig(hash_features=True, capacity=F))
    serial = featurize.parallel_extract_sparse_lines(lines, pspace)
    featurize.bind_pool_space(pspace)
    try:
        with multiprocessing.get_context("fork").Pool(2) as pool:
            pooled = featurize.parallel_extract_sparse_lines(
                lines, pspace, workers=2, pool=pool)
    finally:
        featurize._POOL_SPACE = None
    for got in (serial, pooled):
        assert len(got) == len(want)
        for ((gc, gv), gm), ((wc, wv), wm) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gv, wv)
            assert gm == wm


# -- trainer ----------------------------------------------------------------

TRAIN = dict(num_epochs=2, batch_size=B, window_size=W, eval_stride=W,
             eval_max_cycles=3, seed=0, log_every_steps=3, train_split=0.2)


def configs(sparse=True, **train):
    train = dict(TRAIN, sparse_feed=sparse, sparse_nnz_cap=K, **train)
    model = dict(hidden_size=H, dropout_rate=0.0)
    return (JaxConfig(model=JaxModelConfig(rnn_backend="scan", **model),
                      train=JaxTrainConfig(device_data="always", **train)),
            Config(model=ModelConfig(**model), train=TrainConfig(**train)))


@pytest.fixture(scope="module")
def corpus():
    return corpora()


@pytest.fixture(scope="module")
def init(corpus):
    jcfg, _ = configs()
    jb = jax_prepare_dataset(corpus[0], jcfg.train)
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    state = jt.init_state(jb.x_train[:1])
    return {k: np.array(v) for k, v in state.params.items()}


def port_fit(corpus, params, sparse=True, **train):
    _, cfg = configs(sparse, **train)
    bundle = prepare_dataset(corpus[1], cfg.train)
    trainer = Trainer(cfg, bundle.feature_dim, bundle.metric_names,
                      device="cpu")
    losses = []
    state, hist = trainer.fit(
        bundle, state=trainer.init_state(params_from_jax(params)),
        on_epoch=lambda r, s: losses.append(trainer.last_epoch_losses))
    return (np.concatenate(losses),
            {k: v.detach().numpy().copy() for k, v in state.params.items()},
            hist, bundle)


@pytest.mark.parametrize("superstep", [1, "auto"])
def test_sparse_trainer_matches_jax(corpus, init, superstep):
    got_losses, got_params, hist, bundle = port_fit(
        corpus, init, steps_per_superstep=superstep)
    assert bundle.is_sparse and bundle.x_cols.shape[1] == K
    jcfg, _ = configs(steps_per_superstep=superstep)
    jb = jax_prepare_dataset(corpus[0], jcfg.train)
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    losses = []
    state, jhist = jt.fit(
        jb, state=jt.init_state(jb.x_train[:1]),
        on_epoch=lambda r, s: losses.append(np.array(jt._last_epoch_losses)))
    want = np.concatenate(losses)
    assert len(got_losses) == len(want) > 4
    np.testing.assert_allclose(got_losses, want, rtol=1e-5, atol=0)
    for name, ref in state.params.items():
        ref = np.asarray(ref)
        err = np.abs(got_params[name] - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    np.testing.assert_allclose([h.test_loss for h in hist],
                               [h.test_loss for h in jhist], rtol=1e-5)


def test_sparse_feed_bit_identical_to_dense(corpus, init):
    s_losses, s_params, s_hist, _ = port_fit(corpus, init, sparse=True,
                                             steps_per_superstep="auto")
    d_losses, d_params, d_hist, _ = port_fit(corpus, init, sparse=False,
                                             steps_per_superstep="auto")
    np.testing.assert_array_equal(s_losses, d_losses)
    for name in d_params:
        np.testing.assert_array_equal(s_params[name], d_params[name])
    assert [h.test_loss for h in s_hist] == [h.test_loss for h in d_hist]
    assert s_hist[-1].report == d_hist[-1].report


def test_sparse_refusals_match_jax(corpus):
    jcfg, cfg = configs(sparse=False)
    _, scfg = configs(sparse=True)
    bundle = prepare_dataset(corpus[1], scfg.train)
    sparse_only = dataclasses.replace(bundle, x_base=None)
    trainer = Trainer(cfg, F, bundle.metric_names, device="cpu")
    with pytest.raises(ValueError) as port_err:
        trainer.stage_dataset(sparse_only)
    jb = jax_prepare_dataset(corpus[0], configs(sparse=True)[0].train)
    jt = JaxTrainer(jcfg, F, jb.metric_names)
    with pytest.raises(ValueError) as jax_err:
        jt.stage_dataset(dataclasses.replace(jb, x_base=None))
    assert str(port_err.value) == str(jax_err.value)
    for kw in (dict(sparse_nnz_cap=0),
               dict(sparse_feed=True, device_data="off")):
        with pytest.raises(ValueError) as port_err:
            TrainConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            JaxTrainConfig(**kw)
        assert str(port_err.value) == str(jax_err.value)
    tight = dataclasses.replace(scfg.train, device_data_max_bytes=10)
    over = Trainer(dataclasses.replace(scfg, train=tight), F,
                   bundle.metric_names, device="cpu")
    with pytest.raises(ValueError, match="no host-feed fallback"):
        over.stage_dataset(bundle)
    fat = dataclasses.replace(corpus[1], traffic=coo_rows(
        150, seed=9, lo=K + 1, hi=K + 2))
    with pytest.raises(ValueError, match="over the sparse nnz cap 8"):
        prepare_dataset(fat, scfg.train)


# -- fused engine -----------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, init):
    """A JAX-written checkpoint of the corpus's model."""
    directory = str(tmp_path_factory.mktemp("sparse_ckpt"))
    jcfg, _ = configs()
    trainer = JaxTrainer(jcfg, F, NAMES)
    state = trainer.init_state(np.zeros((1, W, F), np.float32), seed=3)
    extra = {
        "metric_names": NAMES,
        "x_stats": {"min": 0.0, "max": 39.0},
        "y_stats": {"min": [1.0, 0.0, 2.0], "max": [5.0, 9.0, 3.5]},
        "window_size": W, "feature_dim": F,
        "model_config": dataclasses.asdict(trainer.model_config),
        "space": SPACE, "delta_mask": [False, True, False],
    }
    save_checkpoint(directory, state, 4, extra)
    return directory


def sparse_series():
    dense = [coo_rows(t, seed=10 + t) for t in (5 * W + 3, W, 9 * W)]
    return dense, [densify.sparsify_rows(x, K)[:2] for x in dense]


@pytest.mark.parametrize("integrate", [True, False])
def test_sparse_engine_matches_jax_and_dense(ckpt, integrate):
    dense, coo = sparse_series()
    jpred = JaxPredictor.from_checkpoint(ckpt, sparse_feed=True,
                                         sparse_nnz_cap=K)
    port = Predictor.from_checkpoint(ckpt, sparse_feed=True,
                                     sparse_nnz_cap=K, device="cpu")
    plain = Predictor.from_checkpoint(ckpt, device="cpu")
    want = jpred.predict_series_many_sparse(coo, integrate=integrate)
    got = port.predict_series_many_sparse(coo, integrate=integrate)
    ref = plain.predict_series_many(dense, integrate=integrate)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g, r)
    one = port.predict_series_sparse(*coo[0], integrate=integrate)
    np.testing.assert_array_equal(one, got[0])
    # a dense call on a sparse-feed backend ships COO pages
    pages = port.fused.stats()["sparse_pages"]
    np.testing.assert_array_equal(
        port.predict_series(dense[0], integrate=integrate), got[0])
    assert port.fused.stats()["sparse_pages"] == pages + 1
    assert port.fused.stats()["sparse_nnz_cap"] == K
    # the ladder's sparse apply: RAW windows densified and normalized
    cols = np.stack([c[:W] for c, _ in coo])
    vals = np.stack([v[:W] for _, v in coo])
    x = plain.x_stats.apply(np.stack([d[:W] for d in dense]))
    np.testing.assert_array_equal(
        port.apply_windows_sparse(cols, vals),
        plain.apply_windows(x.astype(np.float32)))
    np.testing.assert_allclose(port.apply_windows_sparse(cols, vals),
                               jpred.apply_windows_sparse(cols, vals),
                               rtol=1e-5, atol=1e-5)
    stats = port.jit_cache_stats()
    assert stats["apply_sparse"] >= 1 and plain.jit_cache_stats()[
        "apply_sparse"] is None


def test_sparse_k_mismatch_and_fat_rows(ckpt, capsys, monkeypatch):
    _, coo = sparse_series()
    port = Predictor.from_checkpoint(ckpt, sparse_feed=True,
                                     sparse_nnz_cap=K, device="cpu")
    wide = [(np.pad(c, ((0, 0), (0, 1))), np.pad(v, ((0, 0), (0, 1))))
            for c, v in coo]
    with pytest.raises(ValueError, match="K=9 != engine nnz cap 8"):
        port.fused.predict_many_sparse(wide)
    # a K the engine does not take densifies on the host, same answer
    for g, w in zip(port.predict_series_many_sparse(wide),
                    port.predict_series_many_sparse(coo)):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(port_fused.FusedInferenceMixin, "_warned_fat_rows",
                        False)
    fat = coo_rows(2 * W, seed=11, lo=K + 1, hi=K + 3)
    pages = port.fused.stats()["sparse_pages"]
    plain = Predictor.from_checkpoint(ckpt, device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(port.predict_series(fat),
                                      plain.predict_series(fat))
    out = capsys.readouterr().out
    assert out.count("sparse-feed: dense fallback") == 1
    assert port.fused.stats()["sparse_pages"] == pages
    dense_engine = Predictor.from_checkpoint(ckpt, device="cpu").fused
    with pytest.raises(ValueError, match="sparse feed is not enabled"):
        dense_engine.predict_many_sparse(coo)
