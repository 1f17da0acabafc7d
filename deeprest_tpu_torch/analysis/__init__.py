"""graftlint: the repo's JAX- and concurrency-aware static analyzer.

Run it via ``python -m deeprest_tpu_torch lint`` (cli.py), ``python -m
deeprest_tpu_torch.analysis``, or programmatically::

    from deeprest_tpu_torch.analysis import lint_paths
    result = lint_paths(["deeprest_tpu_torch"])
    assert not result.findings

Rule packs: JX (JAX compile/readback/donation/dtype invariants —
rules_jax), TH (threading — rules_threading), HY (hygiene —
rules_hygiene), OB (observability — rules_obs), DN (sparse-first data
plane — rules_data), RS (resource lifecycle — rules_lifecycle), EX
(exception safety — rules_exceptions), RC (interprocedural lockset
races — rules_races), TX (CUDA-graph capture and torch.compile
invariants, the port's own — rules_torch), GL (framework meta-rules —
core).  The
whole-program symbol table / call graph and the path-sensitive
paired-operation walker live in core (CallGraph, ObligationWalker);
the interprocedural value-flow engine (dtype x denseness x
host/device lattice, bounded summaries — behind
DN001/DN002/JX006/JX007) lives in dataflow (ValueFlow); the
interprocedural lockset engine (held-lock sets, entry-lock fixpoint,
thread roots, guarded-by inference — behind RC001-RC004) lives in
locksets (LocksetAnalysis, "graftrace").  The
incremental cache is cache (lint_paths_cached), the HY001/HY002
autofixer is autofix (fix_paths).  ANALYSIS.md (beside this file) is
the human catalog.

The port of ``deeprest_tpu/analysis``: the same rules, ids and findings
on JAX code, and the TX pack and torch vocabulary (device values, host
syncs, ``torch.int8``) on the port's.  It parses source text and imports
no JAX.
"""

from deeprest_tpu_torch.analysis.core import (
    CallGraph, Finding, FuncKey, LintResult, ObligationWalker, Project,
    Rule, SuppressionEntry, all_rules, analyze_project, apply_baseline,
    default_baseline_path, lint_paths, lint_project, lint_sources,
    load_baseline, load_project, save_baseline, suppression_inventory,
    transitive_closure,
)
from deeprest_tpu_torch.analysis.dataflow import AbsVal, ValueFlow
from deeprest_tpu_torch.analysis.locksets import ClassLocks, LocksetAnalysis
from deeprest_tpu_torch.analysis.cache import LintCache, lint_paths_cached
from deeprest_tpu_torch.analysis.autofix import FixReport, fix_paths
from deeprest_tpu_torch.analysis.reporters import (
    render_json, render_rules, render_sarif, render_suppressions_json,
    render_suppressions_markdown, render_suppressions_text, render_text,
    render_timings,
)

__all__ = [
    "AbsVal", "CallGraph", "ClassLocks", "Finding", "FixReport",
    "FuncKey", "LintCache", "LintResult", "LocksetAnalysis",
    "ObligationWalker", "Project", "Rule", "SuppressionEntry",
    "ValueFlow", "all_rules", "analyze_project", "apply_baseline",
    "default_baseline_path", "fix_paths", "lint_paths",
    "lint_paths_cached", "lint_project", "lint_sources", "load_baseline",
    "load_project", "save_baseline", "suppression_inventory",
    "transitive_closure", "render_json", "render_rules", "render_sarif",
    "render_suppressions_json", "render_suppressions_markdown",
    "render_suppressions_text", "render_text", "render_timings",
]
