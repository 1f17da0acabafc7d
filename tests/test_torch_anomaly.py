"""The port's anomaly detector against the JAX package's, on the CPU, over
one JAX-written checkpoint (as in tests/test_torch_whatif.py), for a
crypto corpus with an injected cryptojacking burner and for a clean one.

Verdicts are held equal (flagged set, ``first_flag_index``); scores,
per-step excess and the aligned bands within 1e-5 relative (1e-5 absolute
near 0).  The checkpoint's delta mask (disk usage) and the re-anchored
memory series run the detector's increment-space and re-anchoring
branches.
"""

import importlib
import json

import numpy as np
import pytest

from deeprest_tpu.data.featurize import featurize_buckets as jax_featurize
from deeprest_tpu.serve.anomaly import AnomalyDetector as JaxDetector
from deeprest_tpu.serve.predictor import Predictor as JaxPredictor
from deeprest_tpu.workload.telemetry import Anomaly
from deeprest_tpu_torch.serve.anomaly import AlignedBands, AnomalyDetector
from deeprest_tpu_torch.serve.predictor import Predictor
from test_torch_whatif import assert_close, simulated_corpus, write_checkpoint

SETTINGS = [(0.10, 5), (0.0, 2)]      # (tolerance, min_run): default, eager


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("anomaly")
    train = simulated_corpus(d / "train.jsonl", buckets=36, seed=1)
    ckpt = write_checkpoint(d / "ckpt", train, seed=5)
    corpora = {
        "crypto": simulated_corpus(
            d / "crypto.jsonl", "crypto", buckets=40, seed=2,
            anomalies=[Anomaly("cryptojacking", "compose-post-service", 15,
                               30)]),
        "clean": simulated_corpus(d / "clean.jsonl", "normal", buckets=40,
                                  seed=3),
    }
    jax_pred = JaxPredictor.from_checkpoint(ckpt)
    port = Predictor.from_checkpoint(ckpt, device="cpu")
    data = {k: jax_featurize(v, space=jax_pred.space())
            for k, v in corpora.items()}
    assert port.delta_mask.any()
    assert any(m.endswith("_memory") for m in port.metric_names)
    return dict(ckpt=ckpt, dir=d, jax_pred=jax_pred, port=port, data=data)


@pytest.mark.parametrize("tolerance,min_run", SETTINGS)
@pytest.mark.parametrize("corpus", ["crypto", "clean"])
def test_check_and_aligned_bands_match_jax(setup, corpus, tolerance, min_run):
    data = setup["data"][corpus]
    traffic, observed = data.traffic, data.targets()
    det = AnomalyDetector(setup["port"], tolerance=tolerance, min_run=min_run)
    jdet = JaxDetector(setup["jax_pred"], tolerance=tolerance,
                       min_run=min_run)
    bands, jbands = det.aligned(traffic, observed), jdet.aligned(traffic,
                                                                 observed)
    assert isinstance(bands, AlignedBands)
    for name in ("preds", "observed", "upper", "scale"):
        assert_close(getattr(bands, name), getattr(jbands, name))
    # the delta columns were compared in increment space
    dm = setup["port"].delta_mask
    np.testing.assert_array_equal(bands.observed[1:, dm],
                                  np.diff(observed[:, dm], axis=0))
    got, want = det.check(traffic, observed), jdet.check(traffic, observed)
    assert [r.metric for r in got] == [r.metric for r in want]
    assert [r.metric for r in got if r.flagged] == \
        [r.metric for r in want if r.flagged]
    assert [r.first_flag_index for r in got] == \
        [r.first_flag_index for r in want]
    assert_close([r.score for r in got], [r.score for r in want])
    for g, w_ in zip(got, want):
        assert_close(g.excess, w_.excess)
        assert repr(g).split(",")[0] == repr(w_).split(",")[0]
    if (tolerance, min_run) == (0.0, 2):
        assert any(r.flagged for r in got)      # the verdict path is taken


def test_anomaly_cli_last_line_matches_jax(setup, capsys):
    raw = str(setup["dir"] / "crypto.jsonl")
    lines = {}
    for name in ("deeprest_tpu", "deeprest_tpu_torch"):
        cli = importlib.import_module(f"{name}.cli")
        argv = ["anomaly", "--ckpt-dir", setup["ckpt"], "--raw", raw,
                "--tolerance", "0.0", "--min-run", "2"]
        if name == "deeprest_tpu_torch":
            argv += ["--device", "cpu"]
        assert cli.main(argv) == 0
        lines[name] = capsys.readouterr().out.strip().splitlines()
        assert cli.main(argv + ["--fail-on-anomaly"]) == 1
        capsys.readouterr()
    got, want = lines["deeprest_tpu_torch"], lines["deeprest_tpu"]
    assert json.loads(got[-1]) == json.loads(want[-1])
    assert json.loads(got[-1])["flagged"]
    detail = json.loads(got[-2])
    assert detail["device"] == "cpu"
    assert [r["metric"] for r in detail["reports"] if r["flagged"]] == \
        json.loads(got[-1])["flagged"]
    det = JaxDetector(setup["jax_pred"], tolerance=0.0, min_run=2)
    data = setup["data"]["crypto"]
    want_reports = det.check(data.traffic, data.targets())
    assert [r["first_flag_index"] for r in detail["reports"]] == \
        [r.first_flag_index for r in want_reports]
    assert_close([r["score"] for r in detail["reports"]],
                 [r.score for r in want_reports])
