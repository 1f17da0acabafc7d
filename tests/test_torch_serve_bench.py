"""The port's serve bench stays runnable on the CPU
(tests/test_serve_bench.py's counterpart): ``--quick --device cpu`` drives
the single-engine cells and the process-replica sweep behind admission,
with its clients in two processes, and emits one JSON document whose
cells served every request, split the load across both replicas, and
captured nothing after warm-up."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serve_bench_quick_cpu(tmp_path):
    out = tmp_path / "serve_bench.json"
    proc = subprocess.run(
        [sys.executable, "-m", "deeprest_tpu_torch.benchmarks.serve_bench",
         "--quick", "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(out.read_text())
    assert doc["schema_version"] == 2
    assert doc["metric"] == "serve_predict_rps"
    assert doc["device"]["platform"] == "cpu"
    assert doc["router"]["replica_mode"] == "process"

    modes = {r["mode"] for r in doc["results"]}
    assert modes == {"batched", "per_request"}
    assert all(r["requests"] > 0 and r["errors"] == 0
               for r in doc["results"])

    assert {r["replicas"] for r in doc["replica_results"]} == {1, 2}
    for cell in doc["replica_results"]:
        assert cell["mode"] == "replicated"
        assert cell["requests"] > 0 and cell["errors"] == 0
        assert cell["client_procs"] == 2
        assert len(cell["per_replica_served"]) == cell["replicas"]
        assert cell["admission"]["depth"] == 8
        assert cell["admission"]["admitted"] >= cell["requests"]
        assert cell["in_plane_p99_ms"] is not None
        assert cell["p50_ms"] <= cell["p99_ms"]
    # two replicas really split the work, least outstanding first
    for cell in (c for c in doc["replica_results"] if c["replicas"] == 2):
        served = cell["per_replica_served"]
        assert min(served) > 0 and min(served) >= 0.2 * max(served), served

    assert doc["replica_sweep"]["rps_by_replicas"]["1"] > 0
    assert "speedup_2_vs_1" in doc["replica_sweep"]
    assert doc["admission_at_max"]["replicas"] == 2
    assert doc["new_graphs_after_warmup"] == 0
    assert doc["replica_new_graphs_after_warmup"] == 0
