"""The port's serving path against the JAX package's, on the CPU, from one
checkpoint the JAX package wrote.

Tolerances: non-delta columns at rtol/atol 1e-5 (the f32 model agrees to
~1e-7; the host invert is the same numpy on both sides); delta columns at
1e-5 relative (both sides integrate with a prefix sum whose float32
association differs from the host loop's).
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.train.checkpoint import save_checkpoint
from deeprest_tpu.train.trainer import Trainer
from deeprest_tpu_torch.serve.predictor import (
    Predictor, rolled_prediction_reference,
)

F, E, H, W = 6, 3, 8, 8
DELTA = np.array([True, False, True])
NAMES = ["c0_usage", "c1_cpu", "c2_usage"]
VOCAB = [f"svc /op{i}" for i in range(F)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want):
    nd = ~DELTA
    np.testing.assert_allclose(got[:, nd], want[:, nd], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[:, DELTA], want[:, DELTA], rtol=1e-5,
                               atol=0)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX-written checkpoint: Trainer-initialized state plus the sidecar
    Trainer.save writes."""
    directory = str(tmp_path_factory.mktemp("jax_ckpt"))
    cfg = JaxConfig(model=JaxModelConfig(feature_dim=F, num_metrics=E,
                                         hidden_size=H, num_layers=2,
                                         dropout_rate=0.0))
    trainer = Trainer(cfg, F, NAMES)
    state = trainer.init_state(np.zeros((1, W, F), np.float32), seed=3)
    extra = {
        "metric_names": NAMES,
        "x_stats": {"min": 0.2, "max": 0.9},
        "y_stats": {"min": np.linspace(1, 2, E).tolist(),
                    "max": np.linspace(3, 7, E).tolist()},
        "window_size": W, "feature_dim": F,
        "model_config": dataclasses.asdict(trainer.model_config),
        "space": {"vocabulary": VOCAB},
        "delta_mask": DELTA.tolist(),
    }
    save_checkpoint(directory, state, 5, extra)
    return directory


@pytest.fixture(scope="module")
def pair(ckpt):
    return (JaxPredictor.from_checkpoint(ckpt),
            Predictor.from_checkpoint(ckpt, device="cpu"))


@pytest.mark.parametrize("length", [W, W + 3, 20 * W + 7])
def test_predict_series_matches_jax(pair, length):
    jax_pred, port = pair
    assert port.fused is not None
    x = np.random.default_rng(length).random((length, F)).astype(np.float32)
    got = port.predict_series(x)
    assert got.shape == (length, E, 3) and got.dtype == np.float32
    _close(got, jax_pred.predict_series(x))
    np.testing.assert_allclose(port.predict_series(x, integrate=False),
                               jax_pred.predict_series(x, integrate=False),
                               rtol=1e-5, atol=1e-5)


def test_predict_series_many_matches_jax_and_per_series(pair):
    jax_pred, port = pair
    rng = np.random.default_rng(11)
    series = [rng.random((n, F)).astype(np.float32)
              for n in (3 * W + 1, W, 9 * W)]
    got = port.predict_series_many(series)
    want = jax_pred.predict_series_many(series)
    assert len(got) == 3
    for g, w_, s in zip(got, want, series):
        _close(g, w_)
        _close(g, port.predict_series(s))
    assert port.predict_series_many([]) == []


def test_fused_path_matches_host_loop(ckpt):
    """The port's own contract: fused engine against its host loop."""
    port = Predictor.from_checkpoint(ckpt, device="cpu")
    host = Predictor.from_checkpoint(ckpt, device="cpu", fused=False)
    assert host.fused is None
    x = np.random.default_rng(2).random((13 * W + 2, F)).astype(np.float32)
    ref = rolled_prediction_reference(
        port.apply_windows, port.x_stats, port.y_stats, W, x,
        delta_mask=DELTA, median_index=port.median_index())
    got = port.predict_series(x)
    np.testing.assert_array_equal(got[:, ~DELTA], ref[:, ~DELTA])
    np.testing.assert_allclose(got[:, DELTA], ref[:, DELTA], rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(host.predict_series(x), ref)
    # explicit pages: 2-window pages, 3 pages per call
    paged = Predictor.from_checkpoint(ckpt, device="cpu", page_windows=2,
                                      coalesce_pages=3)
    assert paged.fused.page_windows == 2 and 6 in paged.fused.rungs
    _close(paged.predict_series(x), got)
    with pytest.raises(ValueError, match="window_size"):
        port.predict_series(x[:W - 1])


def test_cli_predict_matches_jax_cli(ckpt, tmp_path, capsys):
    jax_cli = importlib.import_module("deeprest_tpu.cli")
    port_cli = importlib.import_module("deeprest_tpu_torch.cli")
    x = np.random.default_rng(7).random((5 * W + 3, F)).astype(np.float32)
    feats = str(tmp_path / "input.npz")
    np.savez(feats, traffic=x, space_json=np.frombuffer(
        json.dumps({"vocabulary": VOCAB}).encode(), dtype=np.uint8))
    assert jax_cli.main(["predict", "--ckpt-dir", ckpt, "--features", feats,
                         "--out", str(tmp_path / "jax")]) == 0
    assert port_cli.main(["predict", "--ckpt-dir", ckpt, "--features", feats,
                          "--out", str(tmp_path / "port"),
                          "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu" and report["steps"] == len(x)
    assert report["kernel_launches"] == {"gru_fwd": 0, "gru_fwd_train": 0,
                                         "gru_bwd": 0}
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert list(b["metric_names"]) == NAMES
        _close(b["predictions"], a["predictions"])
    # the host-loop path of the CLI agrees too
    assert port_cli.main(["predict", "--ckpt-dir", ckpt, "--features", feats,
                          "--out", str(tmp_path / "host"), "--device", "cpu",
                          "--no-fused-infer"]) == 0
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "host.npz") as b:
        _close(b["predictions"], a["predictions"])


def _ckpt_with_space(ckpt, directory, space):
    """A copy of ``ckpt`` whose sidecar carries ``space``."""
    import shutil

    shutil.copytree(ckpt, directory)
    (sidecar,) = [os.path.join(root, "host_state.json")
                  for root, _, files in os.walk(directory)
                  if "host_state.json" in files]
    with open(sidecar, encoding="utf-8") as fh:
        extra = json.load(fh)
    extra["space"] = space
    with open(sidecar, "w", encoding="utf-8") as fh:
        json.dump(extra, fh)
    return str(directory)


def test_cli_refuses_another_vocabulary_and_raw(ckpt, tmp_path, capsys):
    """``--features`` from another vocabulary is refused; ``--raw`` is
    featurized against the checkpoint's space (and predicts what the same
    traffic through ``--features`` predicts), and refused with the JAX
    package's message when the checkpoint has no space."""
    from deeprest_tpu_torch.data.featurize import CallPathSpace
    from deeprest_tpu_torch.data.schema import (
        Bucket, Span, save_raw_data_jsonl,
    )

    port_cli = importlib.import_module("deeprest_tpu_torch.cli")
    feats = str(tmp_path / "other.npz")
    np.savez(feats, traffic=np.zeros((W, F), np.float32),
             space_json=np.frombuffer(json.dumps(
                 {"vocabulary": VOCAB[::-1]}).encode(), dtype=np.uint8))
    with pytest.raises(SystemExit, match="vocabulary"):
        port_cli.main(["predict", "--ckpt-dir", ckpt, "--features", feats,
                       "--device", "cpu"])

    space = CallPathSpace()
    space.index = {(f"gw_/op{i}",): i for i in range(F)}
    space.frozen_capacity = F
    with_space = _ckpt_with_space(ckpt, tmp_path / "spaced", space.to_dict())
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4, (3 * W + 2, F))
    buckets = [Bucket(traces=[Span("gw", f"/op{i}") for i in range(F)
                              for _ in range(n[i])] + [Span("gw", "/new")])
               for n in counts]
    raw = str(tmp_path / "raw.jsonl")
    save_raw_data_jsonl(buckets, raw)
    np.savez(feats, traffic=counts.astype(np.float32),
             space_json=np.frombuffer(json.dumps(space.to_dict()).encode(),
                                      dtype=np.uint8))
    for source, path in (("--raw", raw), ("--features", feats)):
        assert port_cli.main(["predict", "--ckpt-dir", with_space, source,
                              path, "--out", str(tmp_path / source[2:]),
                              "--device", "cpu"]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]
                          )["steps"] == len(counts)
    with np.load(tmp_path / "raw.npz") as a, \
            np.load(tmp_path / "features.npz") as b:
        np.testing.assert_array_equal(a["predictions"], b["predictions"])

    no_space = _ckpt_with_space(ckpt, tmp_path / "bare", None)
    with pytest.raises(SystemExit, match="checkpoint has no feature space; "
                                         "featurize the raw corpus"):
        port_cli.main(["predict", "--ckpt-dir", no_space, "--raw", raw,
                       "--device", "cpu"])


def test_default_device_is_cuda_and_raises_without_it(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor.from_checkpoint(ckpt)
    with pytest.raises(RuntimeError, match="is_available"):
        Predictor.from_checkpoint(ckpt, device="cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deeprest_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import tempfile, numpy as np\n"
        "from deeprest_tpu_torch.config import ModelConfig, TrainConfig\n"
        "from deeprest_tpu_torch.data.windows import MinMaxStats\n"
        "from deeprest_tpu_torch.models.qrnn import init_params\n"
        "from deeprest_tpu_torch.serve.predictor import Predictor\n"
        "from deeprest_tpu_torch.serve import export\n"
        "TrainConfig(sparse_feed=True)\n"
        "cfg = ModelConfig(feature_dim=8, num_metrics=2, hidden_size=8)\n"
        "st = MinMaxStats(min=np.float32(0), max=np.float32(1))\n"
        "p = Predictor(init_params(cfg), cfg, st, st, ['a_cpu', 'b_cpu'], "
        "4, sparse_feed=True, quant='int8', device='cpu')\n"
        "p.predict_series(np.ones((9, 8), np.float32))\n"
        "d = tempfile.mkdtemp()\n"
        "export.export_predictor(p, d)\n"
        "export.ExportedPredictor.load(d, quant='int8', device='cpu')"
        ".predict_series(np.ones((9, 8), np.float32))\n"
        "from deeprest_tpu_torch.config import (Config, FeaturizeConfig, "
        "QualityConfig)\n"
        "from deeprest_tpu_torch.data.schema import Bucket, MetricSample, "
        "Span\n"
        "from deeprest_tpu_torch.train.stream import (DriftController, "
        "StreamConfig, StreamingTrainer)\n"
        "st = StreamingTrainer(Config(model=ModelConfig(hidden_size=4), "
        "train=TrainConfig(batch_size=4, window_size=4, eval_stride=1, "
        "log_every_steps=0)), StreamConfig(refresh_buckets=16, "
        "finetune_epochs=1, eval_holdout=2), ckpt_dir=d + '/s', "
        "feature_config=FeaturizeConfig(hash_features=True, capacity=8), "
        "device='cpu')\n"
        "DriftController(st, QualityConfig(enabled=True, "
        "sweep_every_buckets=4, live_window=4, min_sweep_buckets=4, "
        "reference_window=8))\n"
        "for i in range(40):\n"
        "    st.ingest(Bucket([MetricSample('a', 'cpu', float(i % 5))], "
        "[Span('a', '/x')] * (i % 5)))\n"
        "    st.refresh() if st.ready() else None\n"
        "assert st.quality.stats['sweeps'] > 0, st.quality.stats\n"
        "from deeprest_tpu_torch.serve.router import ReplicaRouter\n"
        "q = Predictor(init_params(cfg), cfg, MinMaxStats(min=np.float32(0), "
        "max=np.float32(1)), MinMaxStats(min=np.zeros(2, np.float32), "
        "max=np.ones(2, np.float32)), ['a_cpu', 'b_cpu'], 4, device='cpu')\n"
        "router = ReplicaRouter.build(q, 2)\n"
        "x = np.ones((9, 8), np.float32)\n"
        "assert (router.predict_series(x) == q.predict_series(x)).all()\n"
        "router.close()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'deeprest_tpu'))\n"
        "need = {'graphs', 'obs', 'obs.metrics', 'obs.spans', "
        "'obs.export', 'serve.batcher', 'serve.graphs', 'serve.surface', "
        "'serve.server', 'ops.densify', 'ops.quantize', 'serve.export', "
        "'obs.quality', 'data.wire', 'train.stream', 'serve.replica', "
        "'serve.router', 'obs.profiler', 'benchmarks.serve_bench'}\n"
        "missing = sorted(need - {n.split('.', 1)[1] for n in names})\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 54 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
