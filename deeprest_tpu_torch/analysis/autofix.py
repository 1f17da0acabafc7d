"""``lint --fix``: safe mechanical rewrites for HY001/HY002.

Only the two hygiene rules are fixable — their fixes are provably
behavior-preserving (deleting a never-used import binding, deleting
statements no control flow can reach).  Everything else graftlint flags
is a *design* violation whose fix needs a human (or stays as a reasoned
suppression).

Contract (pinned by tests/test_analysis.py):

- fix → re-lint reports zero HY001/HY002 → a second fix pass is a
  byte-identical no-op (idempotency);
- suppressed findings are REFUSED, never rewritten — an in-code
  ``graftlint: disable=HY001 -- reason`` documents a deliberate
  deviation and the fixer must not undo a documented decision;
- a rewrite that would leave a file unparsable is aborted for that
  file (original bytes kept) and reported, never written.

Mechanics: fixes are computed from the same predicates the rules run
(rules_hygiene.unused_import_bindings / unreachable_tails — one
predicate, two consumers), applied as whole-line edits bottom-up so
line numbers stay valid, and the pass loops until stable because one
fix can expose another (deleting unreachable code can orphan the
import it was the only user of).
"""

from __future__ import annotations

import ast
import dataclasses
import os

from deeprest_tpu_torch.analysis.core import Finding, SourceFile
from deeprest_tpu_torch.analysis.rules_hygiene import (
    unreachable_tails, unused_import_bindings,
)

_MAX_PASSES = 10


@dataclasses.dataclass(frozen=True)
class FixEdit:
    """One applied (or refused) rewrite."""

    path: str
    rule: str
    line: int
    action: str        # "deleted import", "trimmed import", ...


@dataclasses.dataclass
class FixReport:
    applied: list[FixEdit] = dataclasses.field(default_factory=list)
    refused: list[FixEdit] = dataclasses.field(default_factory=list)
    passes: int = 0

    def summary(self) -> str:
        lines = [f"{e.path}:{e.line}: fixed {e.rule} ({e.action})"
                 for e in self.applied]
        lines += [f"{e.path}:{e.line}: REFUSED {e.rule} ({e.action})"
                  for e in self.refused]
        lines.append(f"{len(self.applied)} fix(es) applied, "
                     f"{len(self.refused)} refused, "
                     f"{self.passes} pass(es)")
        return "\n".join(lines)


# -- per-file fix computation ----------------------------------------------


@dataclasses.dataclass
class _LineEdit:
    """Replace lines [start, end] (1-based, inclusive) with ``repl``
    (a list of replacement lines; empty list = pure deletion)."""

    start: int
    end: int
    repl: list[str]
    rule: str
    action: str


def _stmt_lines_exclusive(sf: SourceFile, node: ast.stmt) -> bool:
    """True when ``node``'s source lines are not shared with any OTHER
    statement (the semicolon guard: rewriting shared lines would eat
    the neighbor).  Enclosing blocks necessarily span the node's lines
    and don't count; an import has no statement descendants, so every
    other overlapping statement is a genuine line-sharer."""
    lo, hi = node.lineno, node.end_lineno or node.lineno
    ancestors = set(map(id, sf.ancestors(node)))
    for other in ast.walk(sf.tree):
        if other is node or not isinstance(other, ast.stmt):
            continue
        if id(other) in ancestors:
            continue
        o_lo = getattr(other, "lineno", None)
        if o_lo is None:
            continue
        o_hi = other.end_lineno or o_lo
        if o_lo <= hi and o_hi >= lo:
            return False
    return True


def _parent_block(sf: SourceFile, node: ast.stmt) -> list[ast.stmt]:
    parent = sf.parents().get(node)
    for field in ("body", "orelse", "finalbody"):
        block = getattr(parent, field, None)
        if isinstance(block, list) and node in block:
            return block
    for h in getattr(parent, "handlers", None) or []:
        if node in h.body:
            return h.body
    return []


def _indent_of(sf: SourceFile, node: ast.stmt) -> str:
    text = sf.lines[node.lineno - 1]
    return text[:len(text) - len(text.lstrip())]


def _render_import(node: ast.stmt, keep: list[ast.alias],
                   indent: str) -> list[str]:
    def one(a: ast.alias) -> str:
        return a.name + (f" as {a.asname}" if a.asname else "")

    if isinstance(node, ast.Import):
        line = indent + "import " + ", ".join(one(a) for a in keep)
        if len(line) <= 79:
            return [line]
        return [indent + "import " + one(a) for a in keep]
    mod = "." * node.level + (node.module or "")
    line = indent + f"from {mod} import " + ", ".join(one(a) for a in keep)
    if len(line) <= 79:
        return [line]
    out = [indent + f"from {mod} import ("]
    out += [indent + "    " + one(a) + "," for a in keep]
    out.append(indent + ")")
    return out


def _import_edits(sf: SourceFile, report: FixReport) -> list[_LineEdit]:
    unused = unused_import_bindings(sf)
    if not unused:
        return []
    by_stmt: dict[int, list[str]] = {}
    node_of: dict[int, ast.stmt] = {}
    for bound, node, _original in unused:
        by_stmt.setdefault(id(node), []).append(bound)
        node_of[id(node)] = node
    edits: list[_LineEdit] = []
    for nid, bounds in by_stmt.items():
        node = node_of[nid]
        probe = Finding(sf.rel, node.lineno, node.col_offset, "HY001", "")
        if sf.suppressed(probe):
            report.refused.append(FixEdit(
                sf.rel, "HY001", node.lineno,
                "suppressed in code — a documented deviation"))
            continue
        if not _stmt_lines_exclusive(sf, node):
            report.refused.append(FixEdit(
                sf.rel, "HY001", node.lineno,
                "import shares source lines with another statement"))
            continue
        gone = set(bounds)

        def alias_bound(a: ast.alias) -> str:
            if isinstance(node, ast.Import):
                return a.asname or a.name.split(".")[0]
            return a.asname or a.name
        keep = [a for a in node.names if alias_bound(a) not in gone]
        end = node.end_lineno or node.lineno
        if keep:
            edits.append(_LineEdit(
                node.lineno, end,
                _render_import(node, keep, _indent_of(sf, node)),
                "HY001", f"trimmed import ({', '.join(sorted(gone))})"))
        else:
            block = _parent_block(sf, node)
            # deleting a block's only statement must leave `pass`, not
            # an unparsable empty body
            repl = ([_indent_of(sf, node) + "pass"]
                    if len(block) == 1 else [])
            edits.append(_LineEdit(
                node.lineno, end, repl, "HY001",
                f"deleted import ({', '.join(sorted(gone))})"))
    return edits


def _unreachable_edits(sf: SourceFile,
                       report: FixReport) -> list[_LineEdit]:
    edits: list[_LineEdit] = []
    for prev, first, tail in unreachable_tails(sf):
        probe = Finding(sf.rel, first.lineno, first.col_offset,
                        "HY002", "")
        if sf.suppressed(probe):
            report.refused.append(FixEdit(
                sf.rel, "HY002", first.lineno,
                "suppressed in code — a documented deviation"))
            continue
        prev_end = prev.end_lineno or prev.lineno
        if prev_end >= first.lineno:
            report.refused.append(FixEdit(
                sf.rel, "HY002", first.lineno,
                "unreachable code shares a line with its terminator"))
            continue
        last = tail[-1]
        edits.append(_LineEdit(
            first.lineno, last.end_lineno or last.lineno, [],
            "HY002",
            f"deleted {len(tail)} unreachable statement(s) after "
            f"{type(prev).__name__.lower()}"))
    return edits


def _apply_edits(source: str, edits: list[_LineEdit]) -> str | None:
    """Apply non-overlapping whole-line edits bottom-up; overlapping
    edits are dropped (the next fix pass reconsiders them)."""
    lines = source.splitlines(keepends=True)
    taken: list[tuple[int, int]] = []
    for e in sorted(edits, key=lambda e: e.start, reverse=True):
        if any(e.start <= hi and e.end >= lo for lo, hi in taken):
            continue
        taken.append((e.start, e.end))
        repl = [r + "\n" for r in e.repl]
        lines[e.start - 1:e.end] = repl
    return "".join(lines)


def fix_file(path: str, rel: str, report: FixReport) -> bool:
    """One fix pass over one on-disk file; True when bytes changed."""
    with open(path, encoding="utf-8") as f:
        source = f.read()
    sf = SourceFile(rel, source)
    if sf.tree is None:
        return False
    edits = _import_edits(sf, report) + _unreachable_edits(sf, report)
    if not edits:
        return False
    fixed = _apply_edits(source, edits)
    if fixed is None or fixed == source:
        return False
    try:
        ast.parse(fixed)
    except SyntaxError:
        report.refused.append(FixEdit(
            rel, edits[0].rule, edits[0].start,
            "rewrite would not parse — file left untouched"))
        return False
    with open(path, "w", encoding="utf-8") as f:
        f.write(fixed)
    for e in edits:
        report.applied.append(FixEdit(rel, e.rule, e.start, e.action))
    return True


def fix_paths(paths) -> FixReport:
    """Fix HY001/HY002 across directories/files, looping until stable
    (one fix can expose another: unreachable code may be the only user
    of an import).  Bounded by ``_MAX_PASSES``."""
    from deeprest_tpu_torch.analysis.core import collect_py_files

    report = FixReport()
    for _ in range(_MAX_PASSES):
        report.passes += 1
        # refusal sites re-announce identically every pass — keep only
        # the current pass's so the report lists each site once
        report.refused = []
        changed = False
        for rel, full in collect_py_files(paths):
            if not os.path.isfile(full):
                continue
            changed |= fix_file(full, rel, report)
        if not changed:
            break
    return report
