"""The port's ``train --plots-dir`` / ``--report-every`` and its
``train/plots.py`` against the JAX package's, on the CPU.

- The port's ``train --device cpu --plots-dir D --report-every 1`` writes
  the file names JAX's ``train --plots-dir D --report-every 1`` writes on
  the same features (the learning curve and one PNG a metric) and prints
  the MAE table after every epoch, as JAX's does.
- ``prediction_arrays`` (the median, the quantile band and the level-space
  truth the plots draw) equals the arrays JAX's CLI builds within 1e-5 on
  shared params, f32, delta column included.
- Without matplotlib, ``--plots-dir`` fails before the corpus loads, and
  the error names matplotlib.
"""

import importlib
import os
import sys

import numpy as np
import pytest

from conftest import make_series_buckets
from deeprest_tpu.cli import main as jax_cli_main
from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import FeaturizedData as JaxFeaturizedData
from deeprest_tpu.data.featurize import featurize_buckets
from deeprest_tpu.train.data import eval_window_indices
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.config import Config, ModelConfig, TrainConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace, FeaturizedData
from deeprest_tpu_torch.interop import params_from_jax
from deeprest_tpu_torch.train.data import prepare_dataset
from deeprest_tpu_torch.train.plots import prediction_arrays
from deeprest_tpu_torch.train.trainer import Trainer

TRAIN = dict(batch_size=16, window_size=12, eval_stride=12,
             eval_max_cycles=4, seed=0)
ARGS = ["--epochs", "2", "--batch-size", "16", "--window", "12",
        "--hidden-size", "8", "--no-baselines", "--report-every", "1"]


@pytest.fixture(scope="module")
def corpus():
    """The trainer tests' corpus with a delta-trained usage series."""
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


def test_train_cli_writes_jax_plot_files_and_reports_every_epoch(
        corpus, tmp_path, capsys):
    cli = importlib.import_module("deeprest_tpu_torch.cli")
    feats = corpus[0].save(str(tmp_path / "input"))
    assert jax_cli_main(["train", "--features", feats, *ARGS,
                         "--plots-dir", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    assert cli.main(["train", "--features", feats, *ARGS,
                     "--plots-dir", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert "learning_curve.png" in names and len(names) == 1 + 3
    assert all(os.path.getsize(tmp_path / "port" / n) > 0 for n in names)
    # two epochs' tables and the final one, a header per metric each
    for out in (jax_out, port_out):
        assert out.count("===== gateway_cpu =====") == 3
        assert out.count("DEEPR =>") == 3 * 3
    assert f"plots written to {tmp_path / 'port'}" in port_out


def test_prediction_arrays_match_jax(corpus):
    jcfg = JaxConfig(model=JaxModelConfig(hidden_size=8, rnn_backend="scan"),
                     train=JaxTrainConfig(**TRAIN))
    cfg = Config(model=ModelConfig(hidden_size=8), train=TrainConfig(**TRAIN))
    jb = jax_prepare_dataset(corpus[0], jcfg.train)
    pb = prepare_dataset(corpus[1], cfg.train)
    jt = JaxTrainer(jcfg, jb.feature_dim, jb.metric_names)
    jstate = jt.init_state(jb.x_train[:1])
    # what JAX's `train --plots-dir` draws (deeprest_tpu/cli.py)
    idx = eval_window_indices(len(jb.x_test), jcfg.train.eval_stride,
                              jcfg.train.eval_max_cycles)
    preds = jt.predict(jstate, jb.x_test[idx])
    denorm = lambda q: jb.integrate_test_preds(  # noqa: E731
        jb.denorm_targets(np.maximum(preds[..., q], 1e-6)), idx)
    want = {"median": denorm(jt.model.median_index()), "lo": denorm(0),
            "hi": denorm(preds.shape[-1] - 1), "truth": jb.level_labels(idx)}
    trainer = Trainer(cfg, pb.feature_dim, pb.metric_names, device="cpu")
    state = trainer.init_state(params_from_jax(
        {k: np.array(v) for k, v in jstate.params.items()}))
    got = prediction_arrays(trainer, state, pb)
    np.testing.assert_array_equal(got["idx"], idx)
    assert pb.delta_mask.any()
    for key, value in want.items():
        assert got[key].shape == value.shape == (4, 12, 3), key
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def test_plots_dir_without_matplotlib_fails_before_training(
        tmp_path, monkeypatch, capsys):
    cli = importlib.import_module("deeprest_tpu_torch.cli")
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import fails
    missing = str(tmp_path / "no-such-features.npz")
    with pytest.raises(SystemExit) as exit_:
        cli.main(["train", "--features", missing, "--plots-dir",
                  str(tmp_path / "plots"), "--device", "cpu"])
    # it failed on matplotlib before it tried to read the corpus
    assert "--plots-dir" in str(exit_.value)
    assert "needs matplotlib" in str(exit_.value)
    assert not os.path.exists(tmp_path / "plots")
