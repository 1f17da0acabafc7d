"""Rule pack HY: basic hygiene (unused imports, unreachable code).

Not the point of graftlint — generic linters do this too — but the
framework needs a cheap, unambiguous rule pack to exercise the
suppression/baseline machinery, and dead imports in the serving modules
are real startup cost (every ``import jax`` at module scope delays the
CLI).  Swept once by hand across the package so the checked-in baseline
starts (and stays) empty.

Both rules are mechanically fixable, so they back ``lint
--fix`` (analysis/autofix.py): the helpers below are shared between the
reporting rule and the rewriter, which keeps "what fires" and "what
gets fixed" the same predicate by construction.
"""

from __future__ import annotations

import ast
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    Finding, Project, Rule, SourceFile, register,
)


def import_bindings(sf: SourceFile) -> list[tuple[str, ast.stmt, str]]:
    """Every import-bound name in the module: ``(bound, stmt, original)``
    — `__future__` and ``*`` imports excluded (never reportable)."""
    out: list[tuple[str, ast.stmt, str]] = []
    if sf.tree is None:
        return out
    for node in sf.walk():
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = a.asname or a.name.split(".")[0]
                out.append((bound, node, a.name))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                bound = a.asname or a.name
                out.append((bound, node, a.name))
    return out


def used_names(sf: SourceFile) -> set[str]:
    """Names loaded anywhere in the module, plus ``__all__`` strings
    (re-exports count as uses)."""
    used: set[str] = set()
    if sf.tree is None:
        return used
    for node in sf.walk():
        if isinstance(node, ast.Name):
            used.add(node.id)
    for node in sf.walk():
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)
                and isinstance(node.value, (ast.List, ast.Tuple))):
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and isinstance(
                        e.value, str):
                    used.add(e.value)
    return used


def unused_import_bindings(sf: SourceFile,
                           ) -> list[tuple[str, ast.stmt, str]]:
    """The HY001 predicate, shared with the autofixer: import-bound
    names never used in the module (one entry per (line, bound))."""
    if sf.rel.endswith("__init__.py"):
        return []
    bindings = import_bindings(sf)
    if not bindings:
        return []
    used = used_names(sf)
    seen_lines: set[tuple[int, str]] = set()
    out = []
    for bound, node, original in bindings:
        if bound in used or (node.lineno, bound) in seen_lines:
            continue
        seen_lines.add((node.lineno, bound))
        out.append((bound, node, original))
    return out


def unreachable_tails(sf: SourceFile,
                      ) -> list[tuple[ast.stmt, ast.stmt, list[ast.stmt]]]:
    """The HY002 predicate, shared with the autofixer: per block, the
    ``(terminator, first_unreachable, all_unreachable)`` triple (one
    per block, like the rule reports)."""
    out = []
    if sf.tree is None:
        return out
    for node in sf.walk():
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if not isinstance(block, list):
                continue
            for i, (prev, stmt) in enumerate(zip(block, block[1:])):
                if isinstance(prev, HY002UnreachableCode._TERMINATORS):
                    out.append((prev, stmt, block[i + 1:]))
                    break             # one finding per block
    return out


@register
class HY001UnusedImport(Rule):
    id = "HY001"
    title = "imported name is never used in the module"
    guards = ("dead imports hide real dependencies and slow cold starts "
              "(the CLI lazy-imports jax for exactly this reason); "
              "__init__.py re-export surfaces are exempt")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            for bound, node, original in unused_import_bindings(sf):
                yield sf.finding(
                    node, self.id,
                    f"import {original!r} (bound as {bound!r}) is never "
                    "used; delete it")


@register
class HY002UnreachableCode(Rule):
    id = "HY002"
    title = "statement is unreachable (follows return/raise/break/continue)"
    guards = ("dead statements after a terminator are either a logic bug "
              "or leftovers that mislead the next reader of a hot path")

    _TERMINATORS = (ast.Return, ast.Raise, ast.Break, ast.Continue)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            for prev, stmt, _tail in unreachable_tails(sf):
                yield sf.finding(
                    stmt, self.id,
                    "unreachable: the preceding "
                    f"{type(prev).__name__.lower()} exits "
                    "this block")
