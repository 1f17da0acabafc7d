"""The port's training path against the JAX package's, on the CPU.

- ``prepare_dataset`` and the batch plan: bit for bit.
- One model loss and gradient: f32 at 1e-5 (loss) and 2e-4 relative to
  each leaf's largest gradient (the JAX kernel tolerances).
- The port ``Trainer`` against the JAX ``Trainer`` from identical params
  with dropout 0, f32, H=8, on the ``make_series_buckets`` corpus (plus a
  delta-trained ``usage`` series): per-step losses within 1e-5 relative,
  final params within 1e-4 of each leaf's largest magnitude.  The JAX side
  runs its ``scan`` backend, which agrees with the kernels' f32 contract.
- ``evaluate``'s report within 1e-5 relative, a port-trained checkpoint
  served through both packages' ``Predictor`` (tolerances of
  tests/test_torch_predictor.py), the ``train`` CLI end to end, and
  seeded dropout.
"""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_series_buckets
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import FeaturizedData as JaxFeaturizedData
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.models import qrnn as jax_qrnn
from deeprest_tpu.ops.quantile import pinball_loss as jax_pinball_loss
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.models.qrnn import QuantileGRU, dropout
from deeprest_tpu_torch.ops.quantile import pinball_loss
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.train.checkpoint import load_sidecar
from deeprest_tpu_torch.train.data import eval_window_indices, prepare_dataset
from deeprest_tpu_torch.train.trainer import Trainer, dropout_generator

MODEL = dict(hidden_size=8, dropout_rate=0.0)
TRAIN = dict(num_epochs=3, batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=4, seed=0)


def _configs(model=None, train=None):
    model = dict(MODEL, **(model or {}))
    train = dict(TRAIN, **(train or {}))
    return (JaxConfig(model=JaxModelConfig(rnn_backend="scan", **model),
                      train=JaxTrainConfig(**train)),
            Config(model=ModelConfig(**model), train=TrainConfig(**train)))


@pytest.fixture(scope="module")
def corpus():
    """The trainer tests' corpus, with a disk-usage-like level series added
    so the delta path runs: (JAX FeaturizedData, port FeaturizedData)."""
    data = featurize_buckets(make_series_buckets(160, seed=2),
                             FeaturizeConfig(round_to=8))
    resources = dict(data.resources)
    resources["store-db_usage"] = np.cumsum(
        np.abs(resources["store-db_wiops"])).astype(np.float32)
    jdata = JaxFeaturizedData(traffic=data.traffic, resources=resources,
                              invocations=data.invocations, space=data.space)
    port = FeaturizedData(traffic=data.traffic, resources=resources,
                          invocations=data.invocations,
                          space=CallPathSpace.from_dict(data.space.to_dict()))
    return jdata, port


@pytest.fixture(scope="module")
def bundles(corpus):
    jcfg, cfg = _configs()
    return (jax_prepare_dataset(corpus[0], jcfg.train),
            prepare_dataset(corpus[1], cfg.train))


def _jax_params(trainer, bundle):
    state = trainer.init_state(bundle.x_train[:1])
    return {k: np.array(v) for k, v in state.params.items()}


def test_prepare_dataset_matches_jax_bit_for_bit(bundles):
    jb, pb = bundles
    for name in ("x_train", "y_train", "x_test", "y_test", "x_base",
                 "y_base", "raw_targets", "delta_mask"):
        a, b = getattr(jb, name), getattr(pb, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for stats in ("x_stats", "y_stats"):
        assert getattr(jb, stats).to_dict() == getattr(pb, stats).to_dict()
    assert (jb.split, jb.window_size, jb.metric_names, jb.space_dict) == (
        pb.split, pb.window_size, pb.metric_names, pb.space_dict)
    assert pb.delta_mask.tolist() == [False, False, True]
    np.testing.assert_array_equal(
        eval_window_indices(pb.num_test_windows, 12, 4),
        importlib.import_module("deeprest_tpu.train.data")
        .eval_window_indices(jb.num_test_windows, 12, 4))


@pytest.mark.parametrize("n", [59, 7])
def test_batches_draw_the_same_selections(bundles, n):
    jcfg, cfg = _configs()
    jb, pb = bundles
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    pt = Trainer(cfg, pb.feature_dim, pb.metric_names, device="cpu")
    want = list(jt._batches(n, np.random.default_rng(3)))
    got = list(pt._batches(n, np.random.default_rng(3)))
    assert len(got) == len(want) == -(-n // 16)
    for (s1, w1), (s2, w2) in zip(got, want):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(w1, w2)


def test_model_value_and_grad_matches_jax():
    f, e, h, b, t = 12, 3, 16, 4, 7
    kw = dict(feature_dim=f, num_metrics=e, hidden_size=h, num_layers=1,
              bidirectional=True, dropout_rate=0.0)
    jmodel = jax_qrnn.QuantileGRU(config=JaxModelConfig(rnn_backend="scan",
                                                        **kw))
    rng = np.random.default_rng(0)
    x = rng.random((b, t, f)).astype(np.float32)
    y = rng.random((b, t, e)).astype(np.float32)
    w = np.asarray([1, 1, 1, 0], np.float32)
    tree = jmodel.init(jax.random.PRNGKey(1), x, deterministic=True)["params"]
    tree = {k: np.array(v) for k, v in tree.items()}

    def jax_loss(params):
        preds = jmodel.apply({"params": params}, x, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(2)})
        return jax_pinball_loss(preds, y, (0.05, 0.5, 0.95), sample_weight=w)

    want, want_grads = jax.value_and_grad(jax_loss)(
        {k: jnp.asarray(v) for k, v in tree.items()})
    model = QuantileGRU(ModelConfig(**kw)).load_params(params_from_jax(tree))
    model.requires_grad_(True)
    preds = model(torch.from_numpy(x), deterministic=False,
                  generator=torch.Generator().manual_seed(0))
    loss = pinball_loss(preds, torch.from_numpy(y), (0.05, 0.5, 0.95),
                        sample_weight=torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for name, p in model.named_parameters():
        g, ref = p.grad.numpy(), np.asarray(want_grads[name])
        scale = np.abs(ref).max()
        assert np.abs(g - ref).max() <= 2e-4 * scale, name


def test_dropout_is_seeded_and_changes_the_loss():
    x = torch.ones((64, 50), dtype=torch.bfloat16)
    out = dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert out.dtype == torch.bfloat16
    assert set(out.float().unique().tolist()) <= {0.0, float(
        torch.tensor(1 / 0.75, dtype=torch.bfloat16))}
    assert 0.70 < float((out != 0).float().mean()) < 0.80
    assert torch.equal(out, dropout(x, 0.25, torch.Generator().manual_seed(0)))
    assert not torch.equal(out, dropout(x, 0.25,
                                        torch.Generator().manual_seed(1)))
    assert dropout(x, 0.0, None) is x

    cfg = ModelConfig(feature_dim=6, num_metrics=3, hidden_size=8,
                      dropout_rate=0.5)
    from deeprest_tpu_torch.models.qrnn import init_params
    model = QuantileGRU(cfg).load_params(
        {k: torch.from_numpy(v) for k, v in init_params(cfg, 0).items()})
    xb = torch.rand((4, 5, 6), generator=torch.Generator().manual_seed(2))

    def run(**kw):
        return model(xb, **kw)

    gen = lambda step: dropout_generator(torch.device("cpu"), 0, step)
    assert torch.equal(run(deterministic=False, generator=gen(3)),
                       run(deterministic=False, generator=gen(3)))
    assert not torch.equal(run(deterministic=False, generator=gen(3)),
                           run(deterministic=False, generator=gen(4)))
    assert not torch.equal(run(deterministic=False, generator=gen(3)), run())
    with pytest.raises(ValueError, match="Generator"):
        run(deterministic=False)
    # seeded training is reproducible, and dropout changes its losses
    losses = []
    for rate in (0.5, 0.5, 0.0):
        _, pcfg = _configs(model=dict(dropout_rate=rate, hidden_size=4))
        trainer = Trainer(pcfg, 6, ["a_cpu", "b_cpu"], device="cpu")
        state = trainer.init_state(seed=1)
        staged = (torch.rand((40, 6), generator=torch.Generator()
                             .manual_seed(5)),
                  torch.rand((40, 2), generator=torch.Generator()
                             .manual_seed(6)))
        losses.append([float(trainer.train_step(
            state, staged, np.arange(16) + i, np.ones(16, np.float32)))
            for i in range(3)])
    assert losses[0] == losses[1]
    assert losses[0][1:] != losses[2][1:]


def test_trainer_matches_jax_trainer(corpus, bundles):
    jcfg, cfg = _configs()
    jb, pb = bundles
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    params = _jax_params(jt, jb)
    want_losses = []
    jstate, jhist = jt.fit(jb, state=jt.init_state(jb.x_train[:1]),
                           on_epoch=lambda r, s: want_losses.append(
                               np.array(jt._last_epoch_losses)))
    pt = Trainer(cfg, pb.feature_dim, pb.metric_names, device="cpu")
    got_losses = []
    pstate, phist = pt.fit(pb, state=pt.init_state(params_from_jax(params)),
                           on_epoch=lambda r, s: got_losses.append(
                               pt.last_epoch_losses))
    assert pstate.step == int(jstate.step) == 3 * 4
    np.testing.assert_allclose(np.concatenate(got_losses),
                               np.concatenate(want_losses), rtol=1e-5)
    for name, value in pstate.params.items():
        ref = np.asarray(jstate.params[name])
        err = np.abs(value.detach().numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)
    np.testing.assert_allclose([h.train_loss for h in phist],
                               [h.train_loss for h in jhist], rtol=1e-5)


def _report_values(report):
    return np.array([[s[k] for k in ("median", "p95", "p99", "max")]
                     for methods in report.values() for s in methods.values()])


def test_evaluate_report_matches_jax(bundles):
    jcfg, cfg = _configs()
    jb, pb = bundles
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    jstate = jt.init_state(jb.x_train[:1])
    fake = jb.denorm_targets(jb.y_test) + 1.0      # a constant-error baseline
    want_loss, want = jt.evaluate(jstate, jb, {"resrc": fake})
    pt = Trainer(cfg, pb.feature_dim, pb.metric_names, device="cpu")
    pstate = pt.init_state(params_from_jax(
        {k: np.array(v) for k, v in jstate.params.items()}))
    got_loss, got = pt.evaluate(pstate, pb, {"resrc": fake})
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(_report_values(got), _report_values(want),
                               rtol=1e-5)


def test_port_checkpoint_serves_identically_through_both_predictors(
        bundles, tmp_path):
    _, cfg = _configs(train=dict(checkpoint_dir=str(tmp_path / "ckpt")))
    _, pb = bundles
    pt = Trainer(cfg, pb.feature_dim, pb.metric_names, device="cpu")
    state, _ = pt.fit(pb, num_epochs=1)
    sidecar = load_sidecar(str(tmp_path / "ckpt"))
    assert sidecar["delta_mask"] == [False, False, True]
    jax_pred = JaxPredictor.from_checkpoint(str(tmp_path / "ckpt"))
    port = Predictor.from_checkpoint(str(tmp_path / "ckpt"), device="cpu")
    for name, value in state.params.items():
        np.testing.assert_array_equal(np.asarray(jax_pred.params[name]),
                                      value.detach().numpy())
    x = np.random.default_rng(4).random((5 * 12 + 7, pb.feature_dim)
                                        ).astype(np.float32) * 4
    got, want = port.predict_series(x), jax_pred.predict_series(x)
    nd = ~np.asarray(sidecar["delta_mask"])
    np.testing.assert_allclose(got[:, nd], want[:, nd], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, ~nd], want[:, ~nd], rtol=1e-5, atol=0)


def test_train_cli_runs_end_to_end_on_cpu(corpus, tmp_path, capsys):
    cli = importlib.import_module("deeprest_tpu_torch.cli")
    feats = corpus[1].save(str(tmp_path / "input"))
    ckpt = str(tmp_path / "ckpt")
    args = ["train", "--features", feats, "--epochs", "2", "--batch-size",
            "16", "--window", "12", "--hidden-size", "8",
            "--compute-dtype", "bfloat16", "--ckpt-dir", ckpt,
            "--device", "cpu"]
    assert cli.main(args + ["--no-baselines"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {m for methods in report["report"].values() for m in methods} \
        == {"deepr"}
    steps_per_epoch = -(-int((160 - 12) * 0.4) // 16)
    assert report["steps"] == 2 * steps_per_epoch
    assert [len(s) for s in report["step_losses"]] == [steps_per_epoch] * 2
    assert np.isfinite(report["step_losses"]).all()
    assert report["device"] == "cpu"
    assert report["kernel_launches"] == {"gru_fwd": 0, "gru_fwd_train": 0,
                                         "gru_bwd": 0}
    assert np.isfinite(_report_values(report["report"])).all()
    sidecar = load_sidecar(ckpt)
    assert sidecar["model_config"]["compute_dtype"] == "bfloat16"
    assert cli.main(["predict", "--ckpt-dir", ckpt, "--features", feats,
                     "--out", str(tmp_path / "preds"), "--device",
                     "cpu"]) == 0
    with np.load(tmp_path / "preds.npz") as z:
        preds = z["predictions"]
    assert preds.shape == (160, 3, 3) and np.isfinite(preds).all()
    # with the baselines (the default), the report gains their columns
    assert cli.main(args[:-4] + ["--ckpt-dir", str(tmp_path / "ckpt2"),
                                 "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for methods in report["report"].values():
        assert set(methods) == {"deepr", "resrc", "comp"}
    assert np.isfinite(_report_values(report["report"])).all()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_dense_base_over_the_budget_raises_under_auto(bundles, compute):
    """Under "auto" a dense base over device_data_max_bytes is no longer
    refused: ``stage_dataset`` returns None, as the reference's does, and
    the epoch streams its windows from the host.  The bytes are counted as
    the reference counts them (x at 2 bytes an element in bf16, before the
    cast, plus y): one byte under the count host-feeds, the count itself
    stages, and "always" stages whatever the budget.  The host-fed epoch
    equals the staged one bit for bit."""
    pb = bundles[1]
    x_bytes = pb.x_base.size * 2 if compute == "bfloat16" else \
        pb.x_base.nbytes
    total = x_bytes + pb.y_base.nbytes

    def trainer(budget, device_data="auto"):
        _, cfg = _configs(model=dict(compute_dtype=compute), train=dict(
            device_data=device_data, device_data_max_bytes=budget))
        return Trainer(cfg, pb.feature_dim, pb.metric_names, device="cpu")

    assert trainer(total - 1).stage_dataset(pb) is None
    for staged in (trainer(total).stage_dataset(pb),
                   trainer(total - 1, "always").stage_dataset(pb)):
        x, y = staged
        assert x.dtype == getattr(torch, compute)
        assert tuple(x.shape) == pb.x_base.shape
        assert y.dtype == torch.float32
    runs = {}
    for label, device_data in (("host", "auto"), ("staged", "always")):
        tr = trainer(total - 1, device_data)
        state, hist = tr.fit(pb, num_epochs=1)
        runs[label] = (tr, state, hist)
    (host, s_h, h_h), (staged, s_s, h_s) = runs["host"], runs["staged"]
    assert (host.feed, staged.feed) == ("host", "staged")
    np.testing.assert_array_equal(host.last_epoch_losses,
                                  staged.last_epoch_losses)
    assert h_h[0].test_loss == h_s[0].test_loss
    for name, value in s_s.params.items():
        assert torch.equal(s_h.params[name], value), name


def test_unported_train_features_raise_and_device_defaults_to_cuda(
        monkeypatch):
    """The host-streamed feed is ported ("off" is accepted, an unknown
    value raises); elastic remeshing is ported and, as JAX's, needs a
    snapshot cadence."""
    with pytest.raises(ValueError,
                       match="elastic=True requires snapshot_every_steps"):
        TrainConfig(elastic=True)
    assert TrainConfig(elastic=True, snapshot_every_steps=1).elastic
    assert TrainConfig(device_data="off").device_data == "off"
    with pytest.raises(ValueError, match="'auto', 'always', or 'off'"):
        TrainConfig(device_data="sometimes")
    assert TrainConfig().prefetch_depth == JaxTrainConfig().prefetch_depth
    TrainConfig(device_data="always")
    # the sparse feed is ported (tests/test_torch_sparse.py)
    assert TrainConfig(sparse_feed=True).sparse_nnz_cap == 64
    # supersteps and accumulation are ported; the JAX defaults hold
    assert TrainConfig().steps_per_superstep == "auto"
    assert TrainConfig(grad_accum_windows=2).grad_accum_mode == "exact"
    for name in ("steps_per_superstep", "grad_accum_windows",
                 "grad_accum_mode", "snapshot_every_steps", "snapshot_keep"):
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name)
    for kw, msg in ((dict(steps_per_superstep=0), "steps_per_superstep=0: "
                     "must be 'auto', 'epoch', or an int >= 1"),
                    (dict(steps_per_superstep=True), "steps_per_superstep"),
                    (dict(grad_accum_windows=0), "grad_accum_windows=0: "
                     "must be an int >= 1"),
                    (dict(grad_accum_mode="x"), "grad_accum_mode='x': must "
                     "be 'exact', 'flat', or 'loop'"),
                    (dict(snapshot_every_steps=-1), "snapshot_every_steps"),
                    (dict(snapshot_keep=-1), "snapshot_keep=-1: must be an "
                     "int >= 0"),
                    (dict(sparse_nnz_cap=0), "sparse_nnz_cap=0: must be an "
                     "int >= 1")):
        with pytest.raises(ValueError) as port_err:
            TrainConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            JaxTrainConfig(**kw)
        assert msg in str(port_err.value)
        assert str(port_err.value) == str(jax_err.value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(Config(), 4, ["a_cpu"])
    cfg = dataclasses.replace(Config().model, feature_dim=4, num_metrics=1)
    assert Trainer(Config(), 4, ["a_cpu"], device="cpu").model_config == cfg
