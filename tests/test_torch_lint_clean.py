"""The port lints clean against an empty baseline, and the JAX package's
analyzer agrees.

The counterpart of tests/test_lint_clean.py for deeprest_tpu_torch: the
port's own tree gives 0 findings under the port's analyzer with the
checked-in baseline empty, the JAX package's analyzer gives the same result
(but for the port's torch vocabulary, which it has not got) and the same
suppression inventory on that tree, the JAX package's tree
gives 0 findings under the port's analyzer, every suppression states its
reason, and the generated suppression table of
deeprest_tpu_torch/analysis/ANALYSIS.md matches the code.  No wall-clock
budget is asserted: the seconds are recorded in PERF.md instead.
"""

import os
from collections import Counter

import pytest

import deeprest_tpu.analysis as jax_lint
import deeprest_tpu_torch
import deeprest_tpu_torch.analysis as port_lint

PACKAGE_DIR = os.path.dirname(os.path.abspath(deeprest_tpu_torch.__file__))
DOC = os.path.join(PACKAGE_DIR, "analysis", "ANALYSIS.md")


# the port's own pack (rules_torch.py), which the JAX package does not have
TX_IDS = {"TX001", "TX002", "TX004", "TX005", "TX006"}


class _Recorded:
    """A rule that also keeps what it finds (every finding, suppressed or
    not), so one lint pass yields both the result and what the in-code
    suppressions silenced."""

    def __init__(self, rule, sink: list):
        self.id, self.title, self.guards = rule.id, rule.title, rule.guards
        self._rule, self._sink = rule, sink

    def run(self, project):
        for finding in self._rule.run(project):
            self._sink.append(finding)
            yield finding


def _lint(lint, baseline=None):
    """``(result, the findings its suppressions silence by site)`` of
    the port's tree under ``lint``."""
    project = lint.load_project([PACKAGE_DIR])
    raw: list = []
    result = lint.lint_project(
        project, rules=[_Recorded(r, raw) for r in lint.all_rules().values()],
        baseline_keys=baseline)
    return result, Counter((f.rule, f.path, f.line, f.col) for f in raw
                           if project.by_rel[f.path].suppressed(f))


@pytest.fixture(scope="module")
def port_tree():
    """The port's tree under each analyzer, linted once for this file,
    with the findings each analyzer's suppressions silence."""
    baseline = port_lint.load_baseline(port_lint.default_baseline_path())
    port_result, port_quiet = _lint(port_lint, baseline)
    jax_result, jax_quiet = _lint(jax_lint)
    return baseline, port_result, jax_result, port_quiet, jax_quiet


def test_port_lints_clean_with_empty_baseline(port_tree):
    baseline, result = port_tree[:2]
    assert baseline == [], (
        "the port's baseline must stay EMPTY: repair findings (or "
        f"suppress them in code with a reason); found {baseline}")
    assert result.files >= 95, "package walk looks truncated"
    assert not result.findings, "\n" + port_lint.render_text(result)
    assert not result.baselined


def test_jax_analyzer_gives_the_ports_result(port_tree):
    """JAX's analyzer finds on the port what the port's own finds, but for
    the torch vocabulary JAX's has not got: its only findings are GL002 on
    the suppressions that name a TX rule, and the port's suppressions
    silence exactly JAX's findings plus TX findings and JX007/QT001
    findings on torch values."""
    _, port_result, jax_result, port_quiet, jax_quiet = port_tree
    assert jax_result.files == port_result.files
    assert port_result.findings == []
    tx_sites = sorted(
        (e.path, e.line) for e in port_lint.suppression_inventory(
            port_lint.load_project([PACKAGE_DIR])) if e.rule in TX_IDS)
    assert tx_sites, "no TX suppression: the GL002 arm is vacuous"
    assert sorted((f.path, f.line) for f in jax_result.findings) == tx_sites
    assert all(f.rule == "GL002" and any(t in f.message for t in TX_IDS)
               for f in jax_result.findings)
    assert not jax_quiet - port_quiet, "a JAX finding the port misses"
    extra = port_quiet - jax_quiet
    assert all(rule in TX_IDS or rule in ("JX007", "QT001")
               for rule, *_ in extra), sorted(extra)
    assert port_result.suppressed_count == sum(port_quiet.values())
    assert jax_result.suppressed_count == sum(jax_quiet.values()) > 0
    assert (port_result.suppressed_count - jax_result.suppressed_count
            == sum(extra.values()))


@pytest.fixture(scope="module")
def jax_tree_under_port():
    """The JAX package's tree through the port's analyzer, once."""
    import deeprest_tpu

    root = os.path.dirname(os.path.abspath(deeprest_tpu.__file__))
    return root, port_lint.lint_paths([root])


def test_jax_tree_lints_clean_under_the_port(jax_tree_under_port):
    root, result = jax_tree_under_port
    assert result.files >= 85
    assert not result.findings, "\n" + port_lint.render_text(result)
    assert result.suppressed_count > 0
    assert ([e.to_dict() for e in port_lint.suppression_inventory(
        port_lint.load_project([root]))]
        == [e.to_dict() for e in jax_lint.suppression_inventory(
            jax_lint.load_project([root]))])


def test_suppression_inventories_agree():
    port = port_lint.suppression_inventory(
        port_lint.load_project([PACKAGE_DIR]))
    jax = jax_lint.suppression_inventory(jax_lint.load_project([PACKAGE_DIR]))
    assert [e.to_dict() for e in port] == [e.to_dict() for e in jax]
    assert port


def test_suppressions_all_carry_reasons():
    # GL001 (a disable without its reason) through the meta rules alone,
    # and every inventory row with a reason of its own
    result = port_lint.lint_paths([PACKAGE_DIR], rules=[])
    assert not [f for f in result.findings if f.rule == "GL001"]
    entries = port_lint.suppression_inventory(
        port_lint.load_project([PACKAGE_DIR]))
    assert all(len(e.reason.split()) >= 3 for e in entries), [
        e for e in entries if len(e.reason.split()) < 3]


def test_analysis_md_suppression_table_matches_live_inventory():
    """The table is generated (``python -m deeprest_tpu_torch lint
    --list-suppressions --format markdown``); regenerate the block between
    the markers after adding or removing a suppression."""
    content = open(DOC, encoding="utf-8").read()
    begin, end = "<!-- suppressions:begin -->", "<!-- suppressions:end -->"
    assert begin in content and end in content, \
        "ANALYSIS.md lost its generated-suppressions markers"
    committed = content.split(begin, 1)[1].split(end, 1)[0].strip()
    live = port_lint.render_suppressions_markdown(
        port_lint.suppression_inventory(
            port_lint.load_project([PACKAGE_DIR]))).strip()
    assert committed == live, (
        "deeprest_tpu_torch/analysis/ANALYSIS.md's suppression table "
        "drifted from the code; regenerate it:\n  python -m "
        "deeprest_tpu_torch lint --list-suppressions --format markdown")


def test_cli_lints_the_installed_port_by_default(capsys, tmp_path,
                                                 monkeypatch):
    """``lint`` with no paths is the port's tree (cache under tmp)."""
    from deeprest_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    assert main(["lint", "--rules", "HY001,HY002", "--jobs", "1",
                 "--cache-dir", str(tmp_path / "cache")]) == 0
    out = capsys.readouterr().out
    assert out.startswith("clean: 0 findings")
    files = int(out.rsplit("across ", 1)[1].split()[0])
    assert files >= 95
