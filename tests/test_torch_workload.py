"""The port's workload simulator against the JAX package's, on the CPU.

The simulator is numpy only, so the same scenario and seeds give the same
corpus in both packages, bucket for bucket (``to_dict()`` equality), and
the ``simulate`` CLIs write byte-identical JSONL.
"""

import importlib
import json

import pytest

from deeprest_tpu import workload as jax_workload
from deeprest_tpu.workload import simulator as jax_simulator
from deeprest_tpu.workload import telemetry as jax_telemetry
from deeprest_tpu_torch import workload
from deeprest_tpu_torch.workload import simulator, telemetry

BUCKETS = 16


def anomalies(module):
    """A cryptojacking burner and a ransomware writer, inside the run."""
    return [module.Anomaly("cryptojacking", "compose-post-service", 5, 12),
            module.Anomaly("ransomware", "post-storage-mongodb", 8, 15, 0.5)]


def as_dicts(buckets):
    return [b.to_dict() for b in buckets]


@pytest.mark.parametrize("name", sorted(workload.SCENARIOS))
def test_simulate_corpus_matches_jax_bucket_for_bucket(name):
    assert sorted(workload.SCENARIOS) == sorted(jax_workload.SCENARIOS)
    scenario = workload.SCENARIOS[name](3)
    want = jax_simulator.simulate_corpus(
        jax_workload.SCENARIOS[name](3), BUCKETS,
        anomalies=anomalies(jax_telemetry))
    got = simulator.simulate_corpus(scenario, BUCKETS,
                                    anomalies=anomalies(telemetry))
    assert len(got) == BUCKETS and as_dicts(got) == as_dicts(want)
    # the burner adds ~400 to its component's cpu inside its window only
    clean = simulator.simulate_corpus(workload.SCENARIOS[name](3), BUCKETS)

    def cpu(buckets):
        return [next(m.value for m in b.metrics
                     if m.key == "compose-post-service_cpu") for b in buckets]

    extra = [a - b for a, b in zip(cpu(got), cpu(clean))]
    assert all(d > 300 for d in extra[5:12])
    assert all(d == 0 for d in extra[:5] + extra[15:])


def test_synthetic_app_and_streaming_corpora_match_jax():
    def run(sim, scenarios):
        scenario = scenarios["normal"](1)
        app, endpoints = sim.build_synthetic_app(scenario, 12, 5, seed=2)
        mem = sim.simulate_corpus(scenario, 12, app=app, endpoints=endpoints)
        streamed = list(sim.simulate_corpus_iter(scenario, 12, app=app,
                                                 endpoints=endpoints))
        shifted = scenarios["normal"](1)
        before, after, eps = sim.build_shifted_app(shifted, 8, 12, 5, seed=2)
        drift = list(sim.simulate_drift_corpus_iter(shifted, 10, 4, before,
                                                    after, eps))
        social = list(sim.simulate_corpus_iter(scenarios["composition"](2), 6,
                                               discovery_buckets=4))
        return [as_dicts(c) for c in (mem, streamed, drift, social)]

    got = run(simulator, workload.SCENARIOS)
    want = run(jax_simulator, jax_workload.SCENARIOS)
    assert got == want
    assert got[0] == got[1]          # streamed == in-memory for declared apps
    assert simulator.parse_anomaly("ransomware:user-mongodb:3:9:2.5") == \
        telemetry.Anomaly("ransomware", "user-mongodb", 3, 9, 2.5)
    with pytest.raises(ValueError, match="unknown anomaly kind"):
        telemetry.Anomaly("mining", "x", 0, 1)


@pytest.mark.parametrize("app", ["social", "synthetic"])
def test_simulate_cli_writes_the_jax_cli_jsonl(tmp_path, capsys, app):
    jax_cli = importlib.import_module("deeprest_tpu.cli")
    port_cli = importlib.import_module("deeprest_tpu_torch.cli")
    lines = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        out = str(tmp_path / f"{name}.jsonl")
        args = ["simulate", "--scenario", "crypto", "--ticks", "12",
                "--seed", "4", "--out", out, "--app", app]
        if app == "synthetic":
            args += ["--services", "10", "--endpoints", "4"]
        assert cli.main(args) == 0
        lines[name] = json.loads(capsys.readouterr().out.strip()
                                 .splitlines()[-1])
    assert lines["port"] == dict(lines["jax"],
                                 out=str(tmp_path / "port.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "jax.jsonl").read_bytes()
