"""The port's what-if estimator against the JAX package's, on the CPU, over
one checkpoint that both packages' ``Predictor`` load.

The checkpoint is written by the JAX ``Trainer`` (seeded params, dropout
0) with the sidecar of a featurized simulated social-network corpus, cut
to three components so the model stays small; its call-path space rides
in the sidecar.  Synthesis is numpy in both packages, so the synthetic
traffic is identical and the estimates differ only by the f32 model:
within 1e-5 relative (and 1e-5 absolute where a value is near 0), the
tolerance of tests/test_torch_predictor.py.
"""

import importlib
import json

import numpy as np
import pytest

from deeprest_tpu.config import Config as JaxConfig
from deeprest_tpu.config import FeaturizeConfig as JaxFeaturizeConfig
from deeprest_tpu.config import ModelConfig as JaxModelConfig
from deeprest_tpu.config import TrainConfig as JaxTrainConfig
from deeprest_tpu.data.featurize import featurize_buckets as jax_featurize
from deeprest_tpu.data.synthesize import TraceSynthesizer as JaxSynth
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.serve.whatif import WhatIfEstimator as JaxWhatIf
from deeprest_tpu.train.data import prepare_dataset as jax_prepare_dataset
from deeprest_tpu.train.trainer import Trainer as JaxTrainer
from deeprest_tpu.workload import SCENARIOS
from deeprest_tpu.workload.simulator import simulate_corpus
from deeprest_tpu_torch.data.schema import load_raw_data, save_raw_data_jsonl
from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
from deeprest_tpu_torch.serve.predictor import Predictor
from deeprest_tpu_torch.serve.whatif import WhatIfEstimator

W, H = 12, 8
COMPONENTS = ("compose-post-service", "nginx-thrift", "post-storage-mongodb")


def simulated_corpus(path, scenario="normal", buckets=36, seed=0,
                     anomalies=None):
    """A simulated social-network corpus at a quarter of the scenario's
    calls per user, keeping the metrics of COMPONENTS (cpu, memory, and the
    store's write-iops, write-tp and disk usage), written as JSONL to
    ``path``; returns the JAX buckets."""
    program = SCENARIOS[scenario](seed)
    program.calls_per_user /= 4
    out = simulate_corpus(program, buckets, anomalies=anomalies)
    for b in out:
        b.metrics = [m for m in b.metrics if m.component in COMPONENTS]
    save_raw_data_jsonl(out, str(path))
    return out


def write_checkpoint(directory, buckets, seed=3):
    """A JAX-written checkpoint over ``buckets``: Trainer-initialized params
    and the sidecar Trainer.save writes (stats, space, delta mask)."""
    data = jax_featurize(buckets, JaxFeaturizeConfig(round_to=8))
    cfg = JaxConfig(model=JaxModelConfig(hidden_size=H, dropout_rate=0.0),
                    train=JaxTrainConfig(window_size=W, eval_stride=W))
    bundle = jax_prepare_dataset(data, cfg.train)
    trainer = JaxTrainer(cfg, bundle.feature_dim, bundle.metric_names)
    trainer.save(str(directory), trainer.init_state(bundle.x_train[:1],
                                                    seed=seed), bundle)
    return str(directory)


def assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def assert_json_close(got, want):
    """Equal structure, equal strings and ints, floats within 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_json_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_json_close(a, b)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5)
    else:
        assert got == want


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("whatif")
    raw = d / "raw.jsonl"
    buckets = simulated_corpus(raw)
    ckpt = write_checkpoint(d / "ckpt", buckets)
    jax_pred = JaxPredictor.from_checkpoint(ckpt)
    port = Predictor.from_checkpoint(ckpt, device="cpu")
    space = port.space()
    assert space.to_dict() == jax_pred.space().to_dict()
    jax_est = JaxWhatIf(jax_pred, JaxSynth(jax_pred.space()).fit(buckets))
    est = WhatIfEstimator(port, TraceSynthesizer(space).fit(
        load_raw_data(str(raw))))
    assert est.endpoints == jax_est.endpoints and len(est.endpoints) == 7
    assert port.delta_mask.any() and not port.delta_mask.all()
    return dict(ckpt=ckpt, raw=str(raw), est=est, jax_est=jax_est)


def programs(endpoints, lengths):
    rng = np.random.default_rng(len(lengths))
    return [[{ep: int(rng.integers(0, 30)) for ep in endpoints[:5]}
             for _ in range(n)] for n in lengths]


def assert_bands_close(got, want):
    assert list(got) == list(want)
    for metric in want:
        assert list(got[metric]) == list(want[metric]) == ["q05", "q50",
                                                           "q95"]
        for q in want[metric]:
            assert_close(got[metric][q], want[metric][q])


def test_estimate_and_estimate_many_match_jax(setup):
    est, jax_est = setup["est"], setup["jax_est"]
    (program,) = programs(est.endpoints, [3 * W + 5])
    assert_bands_close(est.estimate(program, seed=2),
                       jax_est.estimate(program, seed=2))
    mixed = programs(est.endpoints, [W, 3 * W + 5, 2 * W + 1, 5 * W])
    got = est.estimate_many(mixed, seed=4)
    want = jax_est.estimate_many(mixed, seed=4)
    assert len(got) == len(want) == 4
    for g, w_, p in zip(got, want, mixed):
        assert_bands_close(g, w_)
        assert len(next(iter(g.values()))["q50"]) == len(p)
    raws = est.estimate_many_raw(mixed, seeds=[1, 2, 3, 4], cache=False)
    for r, w_ in zip(raws, jax_est.estimate_many_raw(mixed, seeds=[1, 2, 3, 4],
                                                     cache=False)):
        assert r.shape == w_.shape
        assert_close(r, w_)
    with pytest.raises(ValueError, match="seeds"):
        est.estimate_many_raw(mixed, seeds=[1])


def test_sweep_and_scaling_factor_match_jax(setup):
    est, jax_est = setup["est"], setup["jax_est"]
    base, hypo = programs(est.endpoints, [4 * W, 4 * W])
    factors = [0.5, 1.0, 2.0, 4.0]
    got = est.sweep(base, factors, seed=5)
    want = jax_est.sweep(base, factors, seed=5)
    assert [r["factor"] for r in got] == factors
    assert_json_close(got, want)
    assert_json_close(est.scaling_factor(base, hypo, seed=6),
                      jax_est.scaling_factor(base, hypo, seed=6))
    with pytest.raises(ValueError, match="at least one factor"):
        est.sweep(base, [])


def test_memo_counts_as_jax_and_returns_read_only_arrays(setup):
    port = Predictor.from_checkpoint(setup["ckpt"], device="cpu")
    jax_est = setup["jax_est"]
    fresh = [WhatIfEstimator(port, setup["est"].synthesizer),
             JaxWhatIf(jax_est.predictor, jax_est.synthesizer)]
    base, hypo = programs(fresh[0].endpoints, [2 * W, 3 * W])
    counts = []
    for est in fresh:
        est.scaling_factor(base, hypo)
        est.scaling_factor(base, hypo)
        est.sweep(base, [1.0, 2.0])
        first = est.estimate_many_raw([base, hypo], seeds=[0, 1])
        second = est.estimate_many_raw([base, hypo], seeds=[0, 1])
        assert all(a is b for a, b in zip(first, second))
        assert not any(a.flags.writeable for a in first)
        with pytest.raises(ValueError):
            first[0][0, 0, 0] = 1.0
        counts.append((est.raw_cache_hits, est.raw_cache_misses))
    assert counts[0] == counts[1] and counts[0][0] > 0


def run_cli(module, argv, capsys):
    cli = importlib.import_module(module)
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("sweep", [None, "0.5,1,2,4"])
def test_whatif_cli_matches_jax_cli(setup, tmp_path, capsys, sweep):
    eps = setup["est"].endpoints
    mix = json.dumps({eps[0]: 12, eps[2]: 30, eps[6]: 3})
    common = ["whatif", "--ckpt-dir", setup["ckpt"], "--raw", setup["raw"],
              "--mix", mix, "--ticks", str(2 * W + 3), "--seed", "1"]
    if sweep:
        common += ["--sweep", sweep]
    want = run_cli("deeprest_tpu.cli",
                   common + ["--out", str(tmp_path / "jax.json")], capsys)
    got = run_cli("deeprest_tpu_torch.cli",
                  common + ["--out", str(tmp_path / "port.json"),
                            "--device", "cpu"], capsys)
    assert got.pop("device") == "cpu"
    assert set(got.pop("seconds")) == {"load", "fit", "estimate"}
    assert got.pop("kernel_launches") == {"gru_fwd": 0, "gru_fwd_train": 0,
                                          "gru_bwd": 0}
    assert got.pop("out").endswith("port.json") and want.pop("out")
    assert_json_close(got, want)
    assert_json_close(json.loads((tmp_path / "port.json").read_text()),
                      json.loads((tmp_path / "jax.json").read_text()))
    with pytest.raises(SystemExit, match="unknown API endpoints"):
        importlib.import_module("deeprest_tpu_torch.cli").main(
            common[:5] + ["--mix", '{"nope": 1}', "--device", "cpu"])


@pytest.mark.parametrize("from_ckpt", [True, False])
def test_synthesize_cli_matches_jax_cli(setup, tmp_path, capsys, from_ckpt):
    eps = setup["est"].endpoints
    args = ["synthesize", "--raw", setup["raw"], "--ticks", "9", "--seed",
            "3", "--mix", json.dumps({eps[1]: 20, eps[4]: 2})]
    args += ["--ckpt-dir", setup["ckpt"]] if from_ckpt else ["--round-to", "16"]
    want = run_cli("deeprest_tpu.cli", args + ["--out", str(tmp_path / "j")],
                   capsys)
    got = run_cli("deeprest_tpu_torch.cli",
                  args + ["--out", str(tmp_path / "p")], capsys)
    assert got.pop("out") == str(tmp_path / "p.npz")
    want.pop("out")
    assert got == want and got["capacity"] == 64
    with np.load(tmp_path / "p.npz") as a, np.load(tmp_path / "j.npz") as b:
        np.testing.assert_array_equal(a["traffic"], b["traffic"])
        np.testing.assert_array_equal(a["space_json"], b["space_json"])
