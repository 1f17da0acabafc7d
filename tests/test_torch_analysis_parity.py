"""The port's analyzer (deeprest_tpu_torch/analysis) held against the JAX
package's (deeprest_tpu/analysis), finding for finding.

Every module-level fixture of tests/test_analysis.py (its strings and its
dicts of ``{path: source}``) goes through all rules of both analyzers: the
findings must agree in rule, path, line, column and message, and so must
the suppression inventories.  The registries must agree rule for rule, and
the text, JSON and SARIF renderings of one result must agree.

The texts are compared after two mechanical rewrites of the JAX side, the
only ways the port's texts may differ: the package name (``deeprest_tpu/``
becomes ``deeprest_tpu_torch/``, and the SARIF ``informationUri`` names the
port's ANALYSIS.md), and the JAX package's history tags, which the port
words as the fix they name (:data:`HISTORY`).
"""

import ast
import importlib.util
import json
import os
import re

import pytest

import deeprest_tpu.analysis as jax_lint
import deeprest_tpu_torch.analysis as port_lint
from deeprest_tpu.analysis import cache as jax_cache
from deeprest_tpu_torch.analysis import cache as port_cache

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE_TESTS = os.path.join(HERE, "test_analysis.py")

# the JAX package's history tags (by change number) and the port's words
HISTORY = {"4": "mask-drift fix", "2-4": "early readback fixes",
           "7": "sharding-table fix"}
_TAG = re.compile(r"\bPRs? (\d+(?:-\d+)?)")
_PACKAGE = re.compile(r"\bdeeprest_tpu/")

# lint-root-relative paths each string fixture is linted at: every
# directory a rule scopes to (hot modules, watchlists, zones)
RELS = ("mod.py", "serve/mod.py", "ops/mod.py", "train/trainer.py",
        "train/stream.py", "obs/mod.py", "data/featurize.py",
        "parallel/mod.py")


def port_wording(text: str) -> str:
    """What the port says where the JAX package says ``text``."""
    text = _TAG.sub(lambda m: HISTORY[m.group(1)], text)
    return _PACKAGE.sub("deeprest_tpu_torch/", text)


def _reference_fixtures() -> dict:
    """The module-level fixtures of tests/test_analysis.py: names from its
    AST, values from importing it (one dict is built from another)."""
    tree = ast.parse(open(REFERENCE_TESTS, encoding="utf-8").read())
    names = [n.targets[0].id for n in tree.body
             if isinstance(n, ast.Assign) and len(n.targets) == 1
             and isinstance(n.targets[0], ast.Name)]
    spec = importlib.util.spec_from_file_location(
        "_reference_analysis_tests", REFERENCE_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {}
    for name in names:
        value = getattr(mod, name)
        if isinstance(value, str) or (
                isinstance(value, dict)
                and all(isinstance(k, str) and isinstance(v, str)
                        for k, v in value.items())):
            out[name] = value
    return out


FIXTURES = _reference_fixtures()


def _projects(value) -> list[dict]:
    if isinstance(value, dict):
        return [value]
    return [{rel: value} for rel in RELS]


def _findings(lint, sources: dict, rename=lambda s: s) -> list[tuple]:
    result = lint.lint_sources(sources)
    return [(f.rule, f.path, f.line, f.col, rename(f.message),
             [(p, ln, c, rename(m)) for p, ln, c, m in f.related])
            for f in result.findings] + [("suppressed",
                                          result.suppressed_count)]


def _inventory(lint, sources: dict) -> list[tuple]:
    project = lint.Project.from_sources(sources)
    return [(e.rule, e.path, e.line, e.reason)
            for e in lint.suppression_inventory(project)]


def test_reference_fixtures_all_collected():
    strings = [n for n, v in FIXTURES.items() if isinstance(v, str)]
    dicts = [n for n, v in FIXTURES.items() if isinstance(v, dict)]
    assert len(strings) >= 69 and len(dicts) >= 3, (strings, dicts)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_agree(name):
    for sources in _projects(FIXTURES[name]):
        want = _findings(jax_lint, sources, rename=port_wording)
        got = _findings(port_lint, sources)
        assert got == want, (name, sorted(sources))
        assert _inventory(port_lint, sources) == _inventory(jax_lint,
                                                            sources)


def test_fixtures_fire_the_rules_they_exercise():
    """The sweep is not vacuous: the fixtures fire most of the registry."""
    fired = set()
    for value in FIXTURES.values():
        for sources in _projects(value):
            fired |= {f.rule
                      for f in port_lint.lint_sources(sources).findings}
    assert len(fired) >= 28, sorted(fired)


# the port's own pack (rules_torch.py): the CUDA-graph counterparts of the
# JX rules with the same numbers, which the JAX package does not have
TX_IDS = {"TX001", "TX002", "TX004", "TX005", "TX006"}


def test_registries_agree():
    """Every JAX rule is the port's, rule for rule; the port's only other
    rules are the TX pack's."""
    from deeprest_tpu_torch.analysis import rules_torch

    jax_rules, port_rules = jax_lint.all_rules(), port_lint.all_rules()
    assert len(jax_rules) == 31 and len(port_rules) == 36
    assert sorted(set(port_rules) & set(jax_rules)) == sorted(jax_rules)
    assert set(port_rules) - set(jax_rules) == TX_IDS
    for rid, rule in jax_rules.items():
        mine = port_rules[rid]
        assert type(mine).__name__ == type(rule).__name__
        assert mine.title == port_wording(rule.title), rid
        assert mine.guards == port_wording(rule.guards), rid
    for rid in TX_IDS:
        assert type(port_rules[rid]).__module__ == rules_torch.__name__
        assert port_rules[rid].title and port_rules[rid].guards, rid


def _rule_blocks(rendered: str) -> dict:
    """``--list-rules`` text → ``{id: its lines}``."""
    blocks: dict = {}
    rid = None
    for line in rendered.splitlines():
        head = line.split(" ", 1)[0]
        if re.fullmatch(r"[A-Z]{2}\d{3}", head):
            rid = head
        blocks.setdefault(rid, []).append(line)
    return blocks


def test_render_rules_agrees():
    """The catalog is JAX's, line for line, once the TX pack's entries are
    taken out."""
    port = _rule_blocks(port_lint.render_rules())
    jax = _rule_blocks(port_wording(jax_lint.render_rules()))
    assert set(port) - set(jax) == TX_IDS
    assert list(jax) == [rid for rid in port if rid not in TX_IDS]
    assert all(port[rid] == jax[rid] for rid in jax)


def _busy_project() -> dict:
    """Every string fixture in one project under serve/ (so the scoped
    rules fire), plus the dict fixtures: findings of most rules at once."""
    sources = {f"serve/{name.lower()}.py": v
               for name, v in FIXTURES.items() if isinstance(v, str)}
    for name, value in FIXTURES.items():
        if isinstance(value, dict):
            sources.update({f"{name.lower()}/{rel}": src
                            for rel, src in value.items()})
    return sources


@pytest.fixture(scope="module")
def busy_results():
    sources = _busy_project()
    return (jax_lint.lint_sources(sources), port_lint.lint_sources(sources))


def test_render_text_and_json_agree(busy_results):
    jax_result, port_result = busy_results
    assert len({f.rule for f in port_result.findings}) >= 20
    assert port_lint.render_text(port_result) == port_wording(
        jax_lint.render_text(jax_result))
    assert port_lint.render_json(port_result) == port_wording(
        jax_lint.render_json(jax_result))


def test_render_sarif_agrees(busy_results):
    jax_result, port_result = busy_results
    want = json.loads(port_wording(jax_lint.render_sarif(jax_result)))
    want["runs"][0]["tool"]["driver"]["informationUri"] = (
        "deeprest_tpu_torch/analysis/ANALYSIS.md")
    assert json.loads(port_lint.render_sarif(port_result)) == want


def test_suppression_renderings_agree():
    sources = {f"m{i}.py": src for i, src in enumerate(
        v for v in FIXTURES.values() if isinstance(v, str))}
    sources["s.py"] = ("# graftlint: disable=HY001 -- doc example\n"
                       "import os\nprint(1)\n")
    entries = {lint: lint.suppression_inventory(
        lint.Project.from_sources(sources))
        for lint in (jax_lint, port_lint)}
    assert entries[port_lint]
    for render in ("render_suppressions_text", "render_suppressions_json",
                   "render_suppressions_markdown"):
        assert (getattr(port_lint, render)(entries[port_lint])
                == getattr(jax_lint, render)(entries[jax_lint])), render


def test_cache_entries_of_the_two_analyzers_never_collide():
    """Both share .graftlint_cache/: each keys on its own sources."""
    assert port_cache.pack_version() != jax_cache.pack_version()
    assert port_cache.DEFAULT_CACHE_DIR == jax_cache.DEFAULT_CACHE_DIR


def test_lint_parsers_agree():
    """``lint`` takes the JAX CLI's positional, flags, defaults and
    choices, and nothing more (no ``--device``)."""
    import argparse

    from deeprest_tpu.cli import build_parser as jax_parser
    from deeprest_tpu_torch.cli import build_parser as port_parser

    def lint_actions(build):
        sub = next(a for a in build()._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {(a.dest, tuple(a.option_strings), a.nargs, a.default,
                 a.choices, type(a).__name__)
                for a in sub.choices["lint"]._actions}

    assert lint_actions(port_parser) == lint_actions(jax_parser)

