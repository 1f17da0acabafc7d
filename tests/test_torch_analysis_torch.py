"""The analyzer's torch vocabulary: the TX pack (CUDA-graph counterparts of
JX001/JX002/JX004/JX005/JX006) and JX007/QT001 on torch code.

Every pair of ``deeprest_tpu_torch/analysis/torch_fixtures.py`` fires its
rule on the bad project and nothing on the good one, across modules too
(a capture in ``serve/`` reaching a helper in ``ops/``); the good twins
are clean under every rule.  The JAX package's analyzer finds nothing on
the same fixtures (the vocabulary is the port's), and on the JAX package's
own fixtures the port's JX007 and QT001 give JAX's findings.  The captured
code of the port's tree holds the trainer's update and every serving
program, and the fixtures the card runs (``RUNTIME``) name the line their
runtime error names.  About 8 s alone, 8.7 s under pytest-xdist's ``-n 6
--dist loadfile`` (junit).
"""

import os

import pytest

import deeprest_tpu.analysis as jax_lint
import deeprest_tpu_torch
import deeprest_tpu_torch.analysis as port_lint
from deeprest_tpu_torch.analysis.captured import captured_scope
from deeprest_tpu_torch.analysis.torch_fixtures import PAIRS, RUNTIME

from test_torch_analysis_parity import FIXTURES, _projects, port_wording

PACKAGE_DIR = os.path.dirname(os.path.abspath(deeprest_tpu_torch.__file__))
TX_IDS = {"TX001", "TX002", "TX004", "TX005", "TX006"}


def _lint(sources, rule=None):
    rules = None if rule is None else [port_lint.all_rules()[rule]]
    return port_lint.lint_sources(sources, rules=rules).findings


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_pair_fires_on_bad_and_is_silent_on_good(name):
    rule, bad, good = PAIRS[name]
    fired = _lint(bad, rule)
    assert fired, f"{name}: {rule} must fire on the bad fixture"
    assert {f.rule for f in _lint(bad)} == {rule}, name
    assert not _lint(good), f"{name}: the good twin is not clean"


def test_every_rule_of_the_vocabulary_has_pairs_across_modules():
    rules = {rule for rule, _, _ in PAIRS.values()}
    assert rules == TX_IDS | {"JX007", "QT001"}
    for rule in TX_IDS:
        assert f"{rule} across modules" in PAIRS
    assert "JX007 capture across modules" in PAIRS
    for name, (rule, bad, good) in PAIRS.items():
        if "across modules" in name:
            assert len(bad) > 1
            # each finding lands in one module of the project
            assert len({f.path for f in _lint(bad, rule)}) == 1


def test_cross_module_capture_reaches_the_ops_helper():
    _, bad, _ = PAIRS["JX007 capture across modules"]
    (f,) = _lint(bad, "JX007")
    assert (f.path, f.line) == ("ops/stats.py", 5)
    assert "captured code" in f.message
    assert "torch.cuda.synchronize()" in f.message


def test_tx001_names_the_captured_read_as_its_witness():
    _, bad, _ = PAIRS["TX001 across modules"]
    (f,) = _lint(bad, "TX001")
    assert (f.path, f.line) == ("serve/plane.py", 12)
    assert f.related == (("ops/program.py", 3, 19, "captured read"),)


def test_tx004_names_the_release_and_the_later_run():
    _, bad, _ = PAIRS["TX004"]
    messages = [f.message for f in _lint(bad, "TX004")]
    assert len(messages) == 2
    assert "`with self.graphs.lock` block" in messages[0]
    assert "later run or replay of self.graphs" in messages[1]


def test_qt001_sees_torch_int8_through_a_call():
    _, bad, _ = PAIRS["QT001"]
    found = [(f.line, f.message.split("(", 1)[1].split(")")[0])
             for f in _lint(bad, "QT001")]
    assert found == [(10, "matmul"), (15, "to:f32")]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_jax_analyzer_finds_nothing_on_the_torch_fixtures(name):
    """The vocabulary is the port's: JAX's rules (JX007 and QT001 among
    them) see none of these hazards."""
    _, bad, _ = PAIRS[name]
    assert not jax_lint.lint_sources(bad).findings


@pytest.mark.parametrize("rule", ["JX007", "QT001"])
def test_torch_vocabulary_keeps_jaxs_findings_on_jaxs_fixtures(rule):
    for name, value in FIXTURES.items():
        for sources in _projects(value):
            want = [(f.path, f.line, f.col, port_wording(f.message))
                    for f in jax_lint.lint_sources(
                        sources,
                        rules=[jax_lint.all_rules()[rule]]).findings]
            got = [(f.path, f.line, f.col, f.message)
                   for f in _lint(sources, rule)]
            assert got == want, (name, sorted(sources))


def test_captured_scope_of_the_port():
    project = port_lint.load_project([PACKAGE_DIR])
    names = {str(k) for k in captured_scope(project).keys}
    for key in ("train/trainer.py::Trainer._update",
                "serve/predictor.py::Predictor._apply",
                "serve/predictor.py::RungServing._apply_sparse",
                "serve/fused.py::FusedRolledEngine._program",
                "serve/fused.py::FusedRolledEngine._program_sparse",
                "serve/export.py::ExportedPredictor._apply",
                "ops/quantile.py::pinball_loss"):
        assert key in names, key
    # obs/profiler.capture is a trace window, not a graph capture
    assert not any(k.startswith("obs/") for k in names)
    assert not any(k.startswith("serve/server.py") for k in names)


@pytest.mark.parametrize("name", sorted(RUNTIME))
def test_runtime_fixtures_are_programs(name):
    """The modules the card runs define ``demo(device)`` in both twins and
    compile; the JX007 one fires at the line its capture error names."""
    rule, bad, good = PAIRS[name]
    rel = RUNTIME[name]
    for sources in (bad, good):
        code = compile(sources[rel], rel, "exec")
        assert "demo" in code.co_names
    lines = {f.line for f in _lint(bad, rule) if f.path == rel}
    assert lines
    if name == "JX007 capture":
        assert bad[rel].splitlines()[min(lines) - 1].strip() == (
            "total = x.sum().item()")
