"""The port lints clean against an empty baseline, and the JAX package's
analyzer agrees.

The counterpart of tests/test_lint_clean.py for deeprest_tpu_torch: the
port's own tree gives 0 findings under the port's analyzer with the
checked-in baseline empty, the JAX package's analyzer gives the same result
and the same suppression inventory on that tree, the JAX package's tree
gives 0 findings under the port's analyzer, every suppression states its
reason, and the generated suppression table of
deeprest_tpu_torch/analysis/ANALYSIS.md matches the code.  No wall-clock
budget is asserted: the seconds are recorded in PERF.md instead.
"""

import os

import pytest

import deeprest_tpu.analysis as jax_lint
import deeprest_tpu_torch
import deeprest_tpu_torch.analysis as port_lint

PACKAGE_DIR = os.path.dirname(os.path.abspath(deeprest_tpu_torch.__file__))
DOC = os.path.join(PACKAGE_DIR, "analysis", "ANALYSIS.md")


@pytest.fixture(scope="module")
def port_tree():
    """The port's tree under each analyzer, linted once for this file."""
    baseline = port_lint.load_baseline(port_lint.default_baseline_path())
    return (baseline,
            port_lint.lint_paths([PACKAGE_DIR], baseline_keys=baseline),
            jax_lint.lint_paths([PACKAGE_DIR]))


def test_port_lints_clean_with_empty_baseline(port_tree):
    baseline, result, _ = port_tree
    assert baseline == [], (
        "the port's baseline must stay EMPTY: repair findings (or "
        f"suppress them in code with a reason); found {baseline}")
    assert result.files >= 95, "package walk looks truncated"
    assert not result.findings, "\n" + port_lint.render_text(result)
    assert not result.baselined


def test_jax_analyzer_gives_the_ports_result(port_tree):
    _, port_result, jax_result = port_tree
    assert jax_result.files == port_result.files
    assert jax_result.findings == port_result.findings == []
    assert jax_result.suppressed_count == port_result.suppressed_count > 0


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
