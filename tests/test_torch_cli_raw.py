"""Raw telemetry to what-if answers and anomaly verdicts through the port's
CLI alone, on the CPU: ``simulate`` → ``featurize`` → ``train`` (baselines
on) → ``predict --raw`` (equal to ``predict --features``) → ``whatif
--sweep`` → ``anomaly``, each subcommand's last line one JSON object."""

import importlib
import json

import numpy as np


def test_raw_chain_through_the_port_cli(tmp_path, capsys):
    cli = importlib.import_module("deeprest_tpu_torch.cli")

    def run(*argv, code=0):
        assert cli.main([str(a) for a in argv]) == code
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    raw, ckpt = tmp_path / "raw.jsonl", tmp_path / "ckpt"
    sim = run("simulate", "--ticks", 40, "--seed", 1, "--out", raw)
    assert sim == {"scenario": "normal", "buckets": 40, "app": "social",
                   "out": str(raw)}
    feats = run("featurize", "--raw", raw, "--out", tmp_path / "input",
                "--workers", 2)
    assert (feats["capacity"], feats["observed_paths"],
            len(feats["metrics"])) == (128, 60, 88)

    train = run("train", "--raw", raw, "--epochs", 1, "--window", 12,
                "--batch-size", 8, "--hidden-size", 8, "--ckpt-dir", ckpt,
                "--device", "cpu")
    assert train["steps"] == 2 and np.isfinite(train["step_losses"]).all()
    assert all(set(m) == {"deepr", "resrc", "comp"}
               for m in train["report"].values())

    by_raw = run("predict", "--ckpt-dir", ckpt, "--raw", raw, "--out",
                 tmp_path / "by_raw", "--device", "cpu")
    by_feats = run("predict", "--ckpt-dir", ckpt, "--features",
                   feats["out"], "--out", tmp_path / "by_feats", "--device",
                   "cpu")
    assert by_raw["steps"] == by_feats["steps"] == 40
    with np.load(by_raw["out"]) as a, np.load(by_feats["out"]) as b:
        assert a["predictions"].shape == (40, 88, 3)
        np.testing.assert_array_equal(a["predictions"], b["predictions"])

    mix = {"nginx-thrift_/wrk2-api/post/compose": 20,
           "nginx-thrift_/wrk2-api/home-timeline/read": 60}
    whatif = run("whatif", "--ckpt-dir", ckpt, "--raw", raw, "--mix",
                 json.dumps(mix), "--ticks", 30, "--sweep", "0.5,1,2",
                 "--device", "cpu")
    assert [r["factor"] for r in whatif["sweep"]] == [0.5, 1.0, 2.0]
    for record in whatif["sweep"]:
        assert len(record["peaks"]) == 88
        assert all(np.isfinite(list(q.values())).all()
                   for q in record["peaks"].values())

    verdict = run("anomaly", "--ckpt-dir", ckpt, "--raw", raw, "--device",
                  "cpu")
    assert set(verdict) == {"flagged"}
    assert set(verdict["flagged"]) <= set(feats["metrics"])
