"""The port's exported artifacts (serve/export.py) against the in-process
port predictor and the JAX package's artifacts, on the CPU, from one
checkpoint the JAX package wrote (F=16, E=3, H=16, W=12).

- The artifact's predictions equal the in-process port predictor's bit
  for bit (quant off, int8, bf16) and the JAX ``ExportedPredictor``'s on
  the same checkpoint within 1e-5 (relative; 1e-5 absolute near 0).
- The program runs the recurrence through the registered operator
  ``deeprest_torch::gru_fwd``, one node per direction, and no op of the
  plain loop; its batch dimension is dynamic.
- The manifest carries the JAX manifest's keys plus the recurrence
  settings; a JAX artifact directory and a quant mismatch each raise.
- The ``export`` and ``serve --artifact`` CLIs answer with the JAX
  package's messages; a ``PredictionService`` over the artifact answers
  ``/v1/predict`` as JAX's does over its artifact.
"""

import dataclasses
import importlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.serve.export import ExportedPredictor as JaxExported
from deeprest_tpu.serve.export import export_predictor as jax_export
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.server import PredictionService as JaxService
from deeprest_tpu.train.checkpoint import save_checkpoint
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.serve import export
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.server import PredictionService

F, E, H, W = 16, 3, 16, 12
NAMES = ["c0_cpu", "c1_usage", "c2_memory"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("export_ckpt"))
    cfg = JaxConfig(model=JaxModelConfig(feature_dim=F, num_metrics=E,
                                         hidden_size=H, dropout_rate=0.0))
    trainer = JaxTrainer(cfg, F, NAMES)
    state = trainer.init_state(np.zeros((1, W, F), np.float32), seed=11)
    extra = {
        "metric_names": NAMES,
        "x_stats": {"min": 0.0, "max": 8.0},
        "y_stats": {"min": [1.0, 0.0, 2.0], "max": [5.0, 9.0, 3.5]},
        "window_size": W, "feature_dim": F,
        "model_config": dataclasses.asdict(trainer.model_config),
        "space": {"config": {"capacity": 0, "round_to": 8,
                             "hash_features": False, "hash_seed": 0x5EED},
                  "vocabulary": [["svc", f"/op{i}"] for i in range(F)],
                  "frozen_capacity": F},
        "delta_mask": [False, True, False],
    }
    save_checkpoint(directory, state, 3, extra)
    return directory


def series():
    rng = np.random.default_rng(4)
    return [rng.poisson(2.5, (t, F)).astype(np.float32)
            for t in (9 * W + 5, W, 3 * W)]


@pytest.fixture(scope="module")
def artifacts(ckpt, tmp_path_factory):
    """The port's artifact per quant mode, and JAX's at off."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for mode in ("off", "int8", "bf16"):
        pred = Predictor.from_checkpoint(ckpt, quant=mode, device="cpu")
        out[mode] = export.export_predictor(pred, str(root / mode))
    out["jax"] = jax_export(JaxPredictor.from_checkpoint(ckpt),
                            str(root / "jax"))
    return out


@pytest.mark.parametrize("mode", ["off", "int8", "bf16"])
def test_artifact_equals_in_process_predictor(ckpt, artifacts, mode):
    pred = Predictor.from_checkpoint(ckpt, quant=mode, device="cpu")
    art = export.ExportedPredictor.load(artifacts[mode], quant=mode,
                                        device="cpu")
    assert art.quant == mode
    assert art.parity_envelope == pred.parity_envelope
    for integrate in (True, False):
        for g, w in zip(art.predict_series_many(series(), integrate=integrate),
                        pred.predict_series_many(series(),
                                                 integrate=integrate)):
            np.testing.assert_array_equal(g, w)
    x = np.random.default_rng(5).random((5, W, F)).astype(np.float32)
    np.testing.assert_array_equal(art.apply_windows(x), pred.apply_windows(x))
    assert art.jit_cache_stats()["quant"] == mode


def test_artifact_matches_jax_artifact(artifacts):
    art = export.ExportedPredictor.load(artifacts["off"], device="cpu")
    jart = JaxExported.load(artifacts["jax"])
    for integrate in (True, False):
        for g, w in zip(art.predict_series_many(series(), integrate=integrate),
                        jart.predict_series_many(series(),
                                                 integrate=integrate)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert art.median_index() == jart.median_index()
    assert art.space().to_dict() == jart.space().to_dict()
    with open(os.path.join(artifacts["off"], "manifest.json")) as fh:
        manifest = json.load(fh)
    with open(os.path.join(artifacts["jax"], "manifest.json")) as fh:
        jax_manifest = json.load(fh)
    assert set(jax_manifest) <= set(manifest)
    assert set(manifest) - set(jax_manifest) == {"bidir_fused",
                                                 "stash_gates"}
    assert manifest["format"] == "torch.export/pt2"
    for key in ("metric_names", "window_size", "feature_dim", "quantiles",
                "x_stats", "y_stats", "model_config", "space", "delta_mask",
                "quant"):
        assert manifest[key] == jax_manifest[key], key


def test_program_runs_the_registered_operator(artifacts):
    program = torch.export.load(os.path.join(artifacts["off"], "model.pt2"))
    ops = export.graph_ops(program)
    assert ops.count(export.GRU_OP) == 2          # one per direction
    assert not [o for o in ops if o.startswith(("aten.sigmoid",
                                                "aten.tanh"))]
    module = program.module()
    for b in (1, 3, 70):
        out = module(torch.zeros((b, W, F)))
        assert tuple(out.shape) == (b, W, E, 3)


def test_refusals_match_jax(artifacts):
    with pytest.raises(ValueError, match="unknown artifact format "
                       "'jax.export/stablehlo'"):
        export.ExportedPredictor.load(artifacts["jax"], device="cpu")
    with pytest.raises(ValueError) as port_err:
        export.ExportedPredictor.load(artifacts["int8"], quant="off",
                                      device="cpu")
    with open(os.path.join(artifacts["int8"], "manifest.json")) as fh:
        manifest = json.load(fh)
    manifest["format"] = "jax.export/stablehlo"
    with pytest.raises(ValueError) as jax_err:
        JaxExported(None, manifest, quant="off")
    assert str(port_err.value) == str(jax_err.value)


def _exit_message(cli, argv):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    return exc.value.code


def test_cli_export_and_serve_artifact_messages(ckpt, artifacts, tmp_path,
                                                capsys):
    port_cli = importlib.import_module("deeprest_tpu_torch.cli")
    jax_cli = importlib.import_module("deeprest_tpu.cli")
    for argv in (["serve", "--ckpt-dir", ckpt, "--artifact",
                  artifacts["off"]],
                 ["serve"],
                 ["serve", "--artifact", artifacts["off"], "--watch", "1"]):
        assert _exit_message(port_cli, argv) == _exit_message(jax_cli, argv)
    # --aot writes the fleet's sidecar next to (a copy of) the checkpoint
    aot_ckpt = str(tmp_path / "aot_ckpt")
    shutil.copytree(ckpt, aot_ckpt)
    capsys.readouterr()
    assert port_cli.main(["export", "--ckpt-dir", aot_ckpt, "--out",
                          str(tmp_path / "a"), "--aot", "--device",
                          "cpu"]) == 0
    sidecar = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sidecar["aot"]["executables"] == 0 and sidecar["aot"]["graphs"]
    assert os.path.exists(os.path.join(aot_ckpt, "aot", "manifest.json"))
    assert port_cli.main(["export", "--ckpt-dir", ckpt, "--out",
                          str(tmp_path / "port")]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(["export", "--ckpt-dir", ckpt, "--out",
                         str(tmp_path / "jax")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "out"} == {
        k: v for k, v in want.items() if k != "out"}
    art = export.ExportedPredictor.load(got["out"], device="cpu")
    pred = Predictor.from_checkpoint(ckpt, device="cpu")
    np.testing.assert_array_equal(art.predict_series(series()[0]),
                                  pred.predict_series(series()[0]))


def test_service_over_artifact_matches_jax(artifacts):
    port = PredictionService(export.ExportedPredictor.load(
        artifacts["off"], device="cpu"), backend="artifact")
    jax_service = JaxService(JaxExported.load(artifacts["jax"]),
                             backend="artifact")
    try:
        body = {"traffic": series()[0].tolist()}
        got, want = port.predict(body), jax_service.predict(body)
        assert got.keys() == want.keys()
        np.testing.assert_allclose(got["predictions"], want["predictions"],
                                   rtol=1e-5, atol=1e-5)
        health = port.healthz()
        assert health["quant"] == {"mode": "off"}
        assert health["fleet"]["tenants"]["default"]["params_digest"] is None
    finally:
        port.close()
        jax_service.close()
