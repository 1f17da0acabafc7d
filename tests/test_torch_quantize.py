"""The port's quantized serving (ops/quantize.py) against the JAX
package's, on the CPU, from one checkpoint the JAX package wrote (F=24,
E=3, H=16, W=12).

- ``quantize_leaf_int8``: int8 bytes and f32 scales equal to JAX's (both
  round half to even); ``dequantize`` is the identity on plain tensors;
  ``weight_bytes`` equal; the JAX tree converted by
  ``interop.quant_params_from_jax`` is the port's, byte for byte.
- ``Predictor.from_checkpoint(quant="int8"|"bf16")`` within 1e-5 of JAX's
  (relative; 1e-5 absolute near 0), its ``params_digest`` equal to JAX's
  and different across modes.
- The envelope file: written by JAX, read and re-gated by the port (and
  the other way round); a tightened budget raises ``QuantParityError``.
- ``/healthz`` and the surface cache key carry the mode.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import InferConfig as JaxInferConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.ops import quantize as jax_quant
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.train.checkpoint import save_checkpoint
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu_torch.config import InferConfig, SurfaceConfig
from deeprest_tpu_torch.interop import quant_params_from_jax
from deeprest_tpu_torch.models.qrnn import resolve_params
from deeprest_tpu_torch.ops import quantize
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.server import PredictionService
from deeprest_tpu_torch.serve.surface import CapacitySurfaceManager

F, E, H, W = 24, 3, 16, 12
NAMES = ["c0_cpu", "c1_usage", "c2_memory"]
DELTA = np.array([False, True, False])


@pytest.fixture(scope="module")
def ckpt_src(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("quant_src"))
    cfg = JaxConfig(model=JaxModelConfig(feature_dim=F, num_metrics=E,
                                         hidden_size=H, dropout_rate=0.0))
    trainer = JaxTrainer(cfg, F, NAMES)
    state = trainer.init_state(np.zeros((1, W, F), np.float32), seed=7)
    extra = {
        "metric_names": NAMES,
        "x_stats": {"min": 0.0, "max": 9.0},
        "y_stats": {"min": [1.0, 0.0, 2.0], "max": [5.0, 9.0, 3.5]},
        "window_size": W, "feature_dim": F,
        "model_config": dataclasses.asdict(trainer.model_config),
        "space": None, "delta_mask": DELTA.tolist(),
    }
    save_checkpoint(directory, state, 2, extra)
    return directory


@pytest.fixture
def ckpt(ckpt_src, tmp_path):
    """A fresh copy per test: the envelope files land next to it."""
    directory = str(tmp_path / "ckpt")
    shutil.copytree(ckpt_src, directory)
    return directory


def traffic(t=7 * W + 5, seed=0):
    return np.random.default_rng(seed).poisson(
        3.0, (t, F)).astype(np.float32)


def test_quantize_leaf_int8_bytes_and_scales_equal_jax():
    rng = np.random.default_rng(1)
    for shape in ((E, F, 3 * H), (E, H, 3 * H), (E, 2 * H, 3), (5, 7)):
        w = rng.normal(0, 0.3, shape).astype(np.float32)
        w[..., 0] = 0.0                       # an all-zero output channel
        w.reshape(-1)[3] = 0.5 * np.abs(w).max() / 127 * 3   # a half step
        want = jax_quant.quantize_leaf_int8(w)
        got = quantize.quantize_leaf_int8(torch.from_numpy(w))
        assert got.data.dtype == torch.int8
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        np.testing.assert_array_equal(
            quantize.dequantize(got).numpy(),
            np.asarray(jax_quant.dequantize(want)))
    with pytest.raises(ValueError, match="int8 quantization needs"):
        quantize.quantize_leaf_int8(torch.ones(3))
    plain = torch.ones(2, 3)
    assert quantize.dequantize(plain) is plain
    assert quantize.QUANT_MODES == jax_quant.QUANT_MODES
    assert quantize.WEIGHT_FRAGMENTS == jax_quant.WEIGHT_FRAGMENTS
    with pytest.raises(ValueError, match="not in"):
        quantize.quantize_params({"w_ih": plain}, "int4")


@pytest.mark.parametrize("mode", ["off", "int8", "bf16"])
def test_trees_weight_bytes_and_conversion_equal_jax(ckpt, mode):
    jpred = JaxPredictor.from_checkpoint(ckpt, quant=mode)
    port = Predictor.from_checkpoint(ckpt, quant=mode, device="cpu")
    assert quantize.weight_bytes(port.params) == jax_quant.weight_bytes(
        jpred.params)
    converted = quant_params_from_jax(
        {k: (jax_quant.QuantTensor(np.asarray(v.data), np.asarray(v.scale))
             if isinstance(v, jax_quant.QuantTensor) else v)
         for k, v in jpred.params.items()})
    assert converted.keys() == port.params.keys()
    for name, leaf in port.params.items():
        other = converted[name]
        pairs = (zip(leaf, other) if isinstance(leaf, quantize.QuantTensor)
                 else [(leaf, other)])
        for a, b in pairs:
            assert a.dtype == b.dtype, name
            assert torch.equal(a, b), name
    # the port's model on the JAX-quantized bytes is the port predictor
    x = torch.from_numpy(quantize.probe_batch(W, F))
    with torch.inference_mode():
        a = port.model(x, params=resolve_params(converted)) \
            if mode != "off" else port.model(x)
    np.testing.assert_array_equal(a.numpy(), port._apply(x).numpy())


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_predictions_match_jax(ckpt, mode):
    jpred = JaxPredictor.from_checkpoint(ckpt, quant=mode)
    port = Predictor.from_checkpoint(ckpt, quant=mode, device="cpu")
    off = Predictor.from_checkpoint(ckpt, device="cpu")
    series = [traffic(seed=s) for s in range(3)]
    for integrate in (True, False):
        got = port.predict_series_many(series, integrate=integrate)
        want = jpred.predict_series_many(series, integrate=integrate)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert not np.array_equal(got[0], off.predict_series_many(
        series, integrate=False)[0])
    np.testing.assert_allclose(port.predict_series(series[0]),
                               jpred.predict_series(series[0]),
                               rtol=1e-5, atol=1e-5)
    assert port.jit_cache_stats()["quant"] == mode
    env, jenv = port.parity_envelope, jpred.parity_envelope
    assert env["mode"] == jenv["mode"] == mode
    assert env["measured"].keys() == jenv["measured"].keys()
    for key, val in jenv["measured"].items():
        assert abs(env["measured"][key] - val) <= 1e-5 * max(1.0, val)
    # the model module holds no f32 copy beside the narrow tree
    assert all(p.device.type == "meta" for p in port.model.parameters())


def test_params_digest_equals_jax_and_differs_across_modes(ckpt):
    digests = {}
    for mode in ("off", "int8", "bf16"):
        port = Predictor.from_checkpoint(ckpt, quant=mode, device="cpu")
        digests[mode] = port.params_digest()
        assert digests[mode] == JaxPredictor.from_checkpoint(
            ckpt, quant=mode).params_digest()
    assert len(set(digests.values())) == 3


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_envelope_file_crosses_packages_and_gates(ckpt, writer):
    path = os.path.join(ckpt, "quant_parity_int8.json")
    if writer == "jax":
        JaxPredictor.from_checkpoint(ckpt, quant="int8")
    else:
        Predictor.from_checkpoint(ckpt, quant="int8", device="cpu")
    with open(path, encoding="utf-8") as fh:
        stored = json.load(fh)
    assert stored["step"] == 2 and stored["mode"] == "int8"
    port = Predictor.from_checkpoint(ckpt, quant="int8", device="cpu")
    jax_pred = JaxPredictor.from_checkpoint(ckpt, quant="int8")
    assert port.parity_envelope["budget"] == stored["budget"]
    assert jax_pred.parity_envelope["budget"] == stored["budget"]
    assert not quantize.check_envelope(port.parity_envelope["measured"],
                                       stored["budget"])
    tight = dict(stored, budget={k: v / 4 for k, v in
                                 stored["measured"].items()})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(tight, fh)
    with pytest.raises(quantize.QuantParityError) as port_err:
        Predictor.from_checkpoint(ckpt, quant="int8", device="cpu")
    with pytest.raises(jax_quant.QuantParityError) as jax_err:
        JaxPredictor.from_checkpoint(ckpt, quant="int8")
    assert str(port_err.value).split(":")[0] == str(jax_err.value).split(
        ":")[0]
    missing = dict(stored, budget={})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(missing, fh)
    with pytest.raises(quantize.QuantParityError,
                       match="no stored budget for this cell"):
        Predictor.from_checkpoint(ckpt, quant="int8", device="cpu")


def test_envelope_helpers_equal_jax():
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(quantize.probe_batch(W, F),
                                  jax_quant.probe_batch(W, F))
    ref = rng.random((4, W, E, 3)).astype(np.float32)
    got = ref + rng.normal(0, 1e-3, ref.shape).astype(np.float32)
    got[..., 0, 1] = ref[..., 0, 1]
    m = quantize.parity_envelope(ref, got, NAMES, (0.05, 0.5, 0.95))
    assert m == jax_quant.parity_envelope(ref, got, NAMES, (0.05, 0.5, 0.95))
    b = quantize.budget_from_measured(m)
    assert b == jax_quant.budget_from_measured(m)
    bad = dict(m, **{"c1_usage|q0.5": 1.0})
    assert quantize.check_envelope(bad, b) == jax_quant.check_envelope(
        bad, b)


def test_config_healthz_and_surface_key_carry_the_mode(ckpt):
    assert InferConfig(quant="int8").quant == "int8"
    for kw in (dict(quant="int4"), dict(sparse_nnz_cap=0)):
        with pytest.raises(ValueError) as port_err:
            InferConfig(**kw)
        with pytest.raises(ValueError) as jax_err:
            JaxInferConfig(**kw)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="quant mode 'int4' not in"):
        Predictor.from_checkpoint(ckpt, quant="int4", device="cpu")
    pred = Predictor.from_checkpoint(ckpt, quant="int8", device="cpu")
    service = PredictionService(pred)
    try:
        health = service.healthz()
    finally:
        service.close()
    assert health["quant"]["mode"] == "int8"
    assert health["quant"]["parity_max"] == max(
        pred.parity_envelope["measured"].values())
    assert health["quant"]["parity_cells"] == E * 3
    assert health["fleet"]["tenants"]["default"]["quant"] == "int8"
    assert health["jit_cache"]["quant"] == "int8"
    mgr = CapacitySurfaceManager(SurfaceConfig(enabled=True))
    off = Predictor.from_checkpoint(ckpt, device="cpu")
    k_off, k_q = mgr.params_hash_of(off), mgr.params_hash_of(pred)
    assert k_off != k_q and k_q.endswith(":int8")
