"""The port's fleet bench (``deeprest_tpu_torch/benchmarks/fleet_bench.py``)
on the CPU: its ``--quick`` arms run end to end (12 apps through one
PredictorPool behind one plane), their gates hold, and ``--headline``
prints JAX's keys.  The quick bench runs ONCE per module, in a subprocess
with a time limit; its record and headline line feed every test below.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet_bench") / "fleet_bench.json"
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch.benchmarks.fleet_bench",
         "--quick", "--headline", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    return json.loads(out.read_text()), proc.stdout


def test_fleet_bench_quick_ledger_flat(quick_run):
    rec, _ = quick_run
    assert rec["mode"] == "quick" and rec["device"] == "cpu"
    led = rec["ledger"]
    assert led["ok"]
    assert led["per_app_compiles"] == 0 and led["captures_after_warmup"] == 0
    assert led["jit_cache_after_all_apps"] == led["jit_cache_after_warmup"]
    assert led["apps"] > led["hbm_budget"]   # the storm is real
    assert led["spilled"] == led["apps"] - led["hbm_budget"]
    assert led["slot_bytes"] > 0 and led["spill_host_bytes"] > 0
    assert led["admit_ms_per_app"] > 0


def test_fleet_bench_quick_churn_honest_and_bit_exact(quick_run):
    rec, _ = quick_run
    ch = rec["churn"]
    assert ch["ok"]
    assert ch["spills"] > 0 and ch["restores"] > 0
    assert ch["post_storm_bit_exact"]
    assert ch["p99_over_median"] <= rec["p99_factor"]
    # the host tier is an LRU, not a leak: residency stays at budget
    assert ch["resident"] == rec["shapes"]["hbm_budget"]
    for key in ("bind_ms_median", "bind_ms_p99", "spill_ms_median",
                "spill_ms_p99", "restore_copy_ms_median",
                "restore_copy_ms_p99"):
        assert ch[key] is not None and ch[key] >= 0, key


def test_fleet_bench_quick_isolation_and_aot(quick_run):
    rec, _ = quick_run
    iso = rec["isolation"]
    assert iso["ok"]
    assert iso["solo_bit_identical"] and iso["concurrent_bit_identical"]
    assert iso["b_reload_took_effect"]
    assert iso["b_invalidations"] == {"storm-reload": 1}
    aot = rec["aot"]
    assert aot["ok"] and aot["bit_identical"]
    side, bare = aot["with_sidecar"], aot["without_sidecar"]
    assert side["aot"]["loaded"] == 0            # nothing labelled loaded
    assert side["aot"]["last_reason"].startswith("manifest verified")
    assert side["aot"]["compile_fallbacks"] == aot["manifest_graphs"]
    assert bare["aot"]["last_reason"] == "no artifacts"
    assert set(side["seconds"]) == {"admit", "warm", "warm_eager",
                                    "warm_capture", "first_request"}
    assert aot["stale"]["reason"] == \
        "fingerprint mismatch: ['ladder', 'torch']"


def test_headline_emits_jax_keys(quick_run):
    _, stdout = quick_run
    rec = json.loads(stdout.strip().splitlines()[-1])
    assert set(rec) == {"fleet_apps", "fleet_cold_start_ms",
                        "fleet_spill_restore_ms"}
    assert rec["fleet_apps"] == 12
    assert rec["fleet_cold_start_ms"] > 0
    assert rec["fleet_spill_restore_ms"] > 0
