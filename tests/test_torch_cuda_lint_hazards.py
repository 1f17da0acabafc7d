"""The hazards the analyzer's TX001, TX004 and JX007 name, run on the card.

Needs an NVIDIA GPU (CUDA graphs have no CPU mode); without CUDA every test
here skips.  Run on the card (the repository's conftest imports JAX, which
the GPU machine does not have):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_lint_hazards.py

Each runtime fixture of ``deeprest_tpu_torch/analysis/torch_fixtures.py``
runs its module's ``demo("cuda")`` in a process of its own (a refused
capture cannot poison the others): TX001's replay after the weight was
rebound answers with the old weight, bit for bit, and its ``copy_`` twin
with the new one; TX004's output held across a second run of the same
graphs is the second call's answer, and its ``.clone()`` twin keeps the
first; JX007's ``.item()`` inside the captured body makes ``graphs.capture``
raise ``GraphCaptureError`` naming the line the rule names, and its twin's
replay equals eager bit for bit.  On the card the three take about 60 s
(their six processes start torch); here they skip in under a second.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from deeprest_tpu_torch.analysis import lint_sources
from deeprest_tpu_torch.analysis.torch_fixtures import (
    DEMO_CHILD, PAIRS, RUNTIME,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def run_demo(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")

    def run(case: str, twin: str) -> dict:
        _, bad, good = PAIRS[case]
        rel = RUNTIME[case]
        path = tmp_path / twin / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text((bad if twin == "bad" else good)[rel])
        out = subprocess.run(
            [sys.executable, "-c", DEMO_CHILD, str(path)], cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
            text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        got = json.loads(out.stdout.strip().splitlines()[-1])
        if "values" in got:
            got["values"] = [torch.tensor(v) for v in got["values"]]
        return got

    return run


@pytest.mark.cuda
def test_tx001_replay_reads_the_rebound_weights_old_storage(run_demo):
    replay, old, new = run_demo("TX001", "bad")["values"]
    assert torch.equal(replay, old) and not torch.equal(replay, new)
    replay, _, new = run_demo("TX001", "good")["values"]
    assert torch.equal(replay, new)


@pytest.mark.cuda
def test_tx004_held_output_becomes_the_second_calls_answer(run_demo):
    ya, yb, a2, b2 = run_demo("TX004", "bad")["values"]
    assert torch.equal(ya, b2) and torch.equal(yb, b2)
    assert not torch.equal(ya, a2)
    ya, yb, a2, b2 = run_demo("TX004", "good")["values"]
    assert torch.equal(ya, a2) and torch.equal(yb, b2)


@pytest.mark.cuda
def test_jx007_capture_is_refused_at_the_line_the_rule_names(run_demo):
    rule, bad, _ = PAIRS["JX007 capture"]
    rel = RUNTIME["JX007 capture"]
    (finding,) = [f for f in lint_sources(bad).findings if f.rule == rule]
    got = run_demo("JX007 capture", "bad")
    assert got["error"] == "GraphCaptureError"
    assert f"{os.path.basename(rel)}:{finding.line} " in got["message"]
    replay, eager = run_demo("JX007 capture", "good")["values"]
    assert torch.equal(replay, eager)
