"""graftlint output renderers: human text, machine JSON, SARIF for CI
code-review annotation, and the suppression-inventory views."""

from __future__ import annotations

import json

from deeprest_tpu_torch.analysis.core import (
    GL_RULES, LintResult, SuppressionEntry, all_rules,
)


def render_text(result: LintResult) -> str:
    lines = []
    for f in result.findings:
        lines.append(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}")
    n = len(result.findings)
    summary = (f"{n} finding{'s' if n != 1 else ''} "
               f"({len(result.baselined)} baselined, "
               f"{result.suppressed_count} suppressed) "
               f"across {result.files} files")
    lines.append(summary if n else f"clean: {summary}")
    return "\n".join(lines)


def render_json(result: LintResult,
                timings: dict | None = None) -> str:
    payload = {
        "version": 1,
        "files": result.files,
        "counts": {
            "findings": len(result.findings),
            "baselined": len(result.baselined),
            "suppressed": result.suppressed_count,
        },
        "findings": [f.to_dict() for f in result.findings],
        "baselined": [f.to_dict() for f in result.baselined],
    }
    if timings is not None:
        payload["timings"] = {k: round(v, 4)
                              for k, v in timings.items()}
    return json.dumps(payload, indent=2, sort_keys=True)


def render_timings(timings: dict) -> str:
    """``lint --timings``: the per-pack wall-time breakdown, slowest
    first.  Lazy shared infrastructure (call graph, value-flow and
    lockset fixpoints) is charged to the first pack that touches it."""
    total = sum(timings.values())
    lines = ["pack timings (wall):"]
    for key, secs in sorted(timings.items(),
                            key=lambda kv: (-kv[1], kv[0])):
        lines.append(f"  {key:<6} {secs * 1000.0:8.1f} ms")
    lines.append(f"  {'total':<6} {total * 1000.0:8.1f} ms")
    return "\n".join(lines)


def render_rules() -> str:
    """``lint --list-rules``: the catalog with the historical
    incident each rule guards against."""
    lines = []
    for rid, rule in sorted(all_rules().items()):
        lines.append(f"{rid}  {rule.title}")
        if rule.guards:
            lines.append(f"       guards: {rule.guards}")
    for rid, title in sorted(GL_RULES.items()):
        lines.append(f"{rid}  {title} (framework meta-rule)")
    return "\n".join(lines)


def render_sarif(result: LintResult) -> str:
    """SARIF 2.1.0 — the format CI/code-review systems (GitHub code
    scanning among them) consume to annotate findings inline on the
    diff.  Live findings only: baselined/suppressed entries are by
    definition not actionable on a review."""
    registry = all_rules()
    used = sorted({f.rule for f in result.findings})
    rules_meta = []
    for rid in used:
        rule = registry.get(rid)
        desc = rule.title if rule is not None else GL_RULES.get(rid, rid)
        meta = {"id": rid, "shortDescription": {"text": desc}}
        if rule is not None and rule.guards:
            meta["help"] = {"text": f"guards: {rule.guards}"}
        rules_meta.append(meta)
    results = []
    for f in result.findings:
        entry = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": max(1, f.line),
                               "startColumn": f.col + 1},
                },
            }],
        }
        if f.related:
            # two-site race witnesses (the RC pack): the second access
            # site annotates the same review inline
            entry["relatedLocations"] = [{
                "physicalLocation": {
                    "artifactLocation": {"uri": rpath},
                    "region": {"startLine": max(1, rline),
                               "startColumn": rcol + 1},
                },
                "message": {"text": rmsg},
            } for rpath, rline, rcol, rmsg in f.related]
        results.append(entry)
    return json.dumps({
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri": "deeprest_tpu_torch/analysis/ANALYSIS.md",
                "rules": rules_meta,
            }},
            "results": results,
        }],
    }, indent=2, sort_keys=True)


# -- suppression inventory views --------------------------------------------


def render_suppressions_text(entries: list[SuppressionEntry]) -> str:
    lines = [f"{e.rule}  {e.path}:{e.line}  -- {e.reason}"
             for e in entries]
    lines.append(f"{len(entries)} suppressions across "
                 f"{len({e.path for e in entries})} files")
    return "\n".join(lines)


def render_suppressions_json(entries: list[SuppressionEntry]) -> str:
    return json.dumps({
        "version": 1,
        "count": len(entries),
        "suppressions": [e.to_dict() for e in entries],
    }, indent=2, sort_keys=True)


def render_suppressions_markdown(entries: list[SuppressionEntry]) -> str:
    """The generated ANALYSIS.md table.  Line numbers are deliberately
    omitted (rows would churn on every unrelated edit); identity is
    (rule, file, reason) with a count — tests/test_torch_lint_clean.py
    pins this rendering against the committed block of
    deeprest_tpu_torch/analysis/ANALYSIS.md, so doc and code cannot
    drift."""
    grouped: dict[tuple[str, str, str], int] = {}
    for e in entries:
        key = (e.rule, e.path, e.reason)
        grouped[key] = grouped.get(key, 0) + 1
    lines = ["| Rule | Site | n | Reason |", "|---|---|---|---|"]
    for (rule, path, reason), n in sorted(grouped.items()):
        safe = reason.replace("|", "\\|")
        lines.append(f"| {rule} | `{path}` | {n} | {safe} |")
    lines.append("")
    lines.append(f"{len(entries)} suppressions across "
                 f"{len({e.path for e in entries})} files.")
    return "\n".join(lines)
