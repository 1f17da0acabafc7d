"""Incremental lint cache: per-file parse pickles + whole-tree findings.

The dataflow engine (graftflow) made a full lint a whole-program
analysis: parse everything, build the call graph, run the value-flow
fixpoint, then every rule pack.  That cost is content-determined, so it
caches — but at TWO distinct granularities, because the two layers have
different soundness boundaries:

- **Parse layer (truly per-file)**: a pickled :class:`SourceFile` keyed
  by the file's content hash.  A one-file edit re-parses one file; the
  other N-1 load from the cache.
- **Findings layer (whole-tree key, per-run payload)**: the
  interprocedural rules mean one file's edit can change findings in
  ANOTHER file (that is the point of graftflow), so per-file findings
  entries would be unsound.  The findings payload is therefore keyed by
  the digest of the ENTIRE manifest — (rule-pack version, rule subset,
  every file's content hash) — and stores the *raw* analysis result
  (post-suppression, pre-baseline).  The baseline file can change
  independently of the tree, so the baseline split is re-applied on
  every load.

Both layers are keyed by :func:`pack_version` — a digest of the
analysis package's own sources — so editing any rule, the engine, or
this cache invalidates everything without a hand-bumped version
constant.  Every cache failure (corrupt pickle, truncated JSON,
permission error) silently falls back to a fresh computation: the lint
gate must never fail *because of* its cache.  ``lint
--no-cache`` is the escape hatch; the default cache root is
``.graftlint_cache/`` under the working directory (gitignored).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import sys
from typing import Iterable

from deeprest_tpu_torch.analysis.core import (
    Finding, LintResult, Rule, SourceFile, apply_baseline,
    analyze_project, collect_py_files, lint_project, Project,
)

_PACK_VERSION: str | None = None

# bounded cache footprint: oldest entries beyond these caps are pruned
# on save (a lint cache that grows forever is a disk leak with extra
# steps — the RS pack would flag the runtime equivalent)
_MAX_RESULT_ENTRIES = 8
_MAX_PARSE_ENTRIES = 512

DEFAULT_CACHE_DIR = ".graftlint_cache"


def pack_version() -> str:
    """Digest of the analysis package's own source files (rule packs,
    engine, this cache).  Any change to the linter invalidates every
    cache entry — no hand-maintained version constant to forget."""
    global _PACK_VERSION
    if _PACK_VERSION is None:
        here = os.path.dirname(os.path.abspath(__file__))
        h = hashlib.sha256()
        h.update(f"py{sys.version_info[0]}.{sys.version_info[1]}"
                 .encode())
        for name in sorted(os.listdir(here)):
            if not name.endswith(".py"):
                continue
            with open(os.path.join(here, name), "rb") as f:
                h.update(name.encode())
                h.update(f.read())
        _PACK_VERSION = h.hexdigest()[:16]
    return _PACK_VERSION


def _file_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:24]


class LintCache:
    """One cache root: ``ast/`` parse pickles, ``results/`` findings."""

    def __init__(self, cache_dir: str):
        self.root = cache_dir
        self.ast_dir = os.path.join(cache_dir, "ast")
        self.results_dir = os.path.join(cache_dir, "results")
        self.parse_hits = 0
        self.parse_misses = 0
        self.result_hit = False

    # -- parse layer ------------------------------------------------------

    def load_sources(self, manifest: list[tuple[str, str, str]],
                     ) -> list[SourceFile]:
        """Parse (or load) every ``(rel, full, digest)`` entry; cache
        misses parse fresh and store."""
        out: list[SourceFile] = []
        for rel, full, digest in manifest:
            sf = self._load_ast(rel, digest)
            if sf is None:
                with open(full, encoding="utf-8") as f:
                    sf = SourceFile(rel, f.read())
                self.parse_misses += 1
                self._store_ast(digest, sf)
            else:
                self.parse_hits += 1
            out.append(sf)
        return out

    def _ast_path(self, digest: str) -> str:
        return os.path.join(self.ast_dir, f"{digest}.pkl")

    def _load_ast(self, rel: str, digest: str) -> SourceFile | None:
        try:
            with open(self._ast_path(digest), "rb") as f:
                sf = pickle.load(f)
            if isinstance(sf, SourceFile) and sf.rel == rel:
                return sf
        except Exception:
            pass
        return None

    def _store_ast(self, digest: str, sf: SourceFile) -> None:
        try:
            os.makedirs(self.ast_dir, exist_ok=True)
            # the parents map rebuilds lazily; pickling it would double
            # the entry size for nothing
            sf._parents = None
            tmp = self._ast_path(digest) + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                pickle.dump(sf, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self._ast_path(digest))
            self._prune(self.ast_dir, _MAX_PARSE_ENTRIES)
        except Exception:
            pass

    # -- findings layer ---------------------------------------------------

    @staticmethod
    def project_key(manifest: list[tuple[str, str, str]],
                    rule_ids: list[str] | None) -> str:
        h = hashlib.sha256()
        h.update(pack_version().encode())
        h.update(json.dumps(rule_ids or "ALL").encode())
        for rel, _full, digest in manifest:
            h.update(rel.encode())
            h.update(digest.encode())
        return h.hexdigest()[:24]

    def _result_path(self, key: str) -> str:
        return os.path.join(self.results_dir, f"{key}.json")

    def load_result(self, key: str) -> tuple[list[Finding], int] | None:
        try:
            with open(self._result_path(key), encoding="utf-8") as f:
                data = json.load(f)
            if data.get("pack") != pack_version():
                return None
            kept = [Finding(**d) for d in data["findings"]]
            # freshen the mtime so pruning is LRU-ish
            os.utime(self._result_path(key))
            self.result_hit = True
            return kept, int(data["suppressed"])
        except Exception:
            return None

    def store_result(self, key: str, kept: list[Finding],
                     suppressed: int) -> None:
        try:
            os.makedirs(self.results_dir, exist_ok=True)
            tmp = self._result_path(key) + f".tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({
                    "version": 1,
                    "pack": pack_version(),
                    "suppressed": suppressed,
                    "findings": [fd.to_dict() for fd in kept],
                }, f)
            os.replace(tmp, self._result_path(key))
            self._prune(self.results_dir, _MAX_RESULT_ENTRIES)
        except Exception:
            pass

    @staticmethod
    def _prune(directory: str, keep: int) -> None:
        try:
            entries = [(os.path.getmtime(os.path.join(directory, n)), n)
                       for n in os.listdir(directory)
                       if not n.endswith(".tmp")]
            entries.sort(reverse=True)
            for _mtime, name in entries[keep:]:
                os.unlink(os.path.join(directory, name))
        except Exception:
            pass


def lint_paths_cached(paths: Iterable[str],
                      rules: Iterable[Rule] | None = None,
                      baseline_keys: Iterable[str] | None = None,
                      jobs: int | None = None,
                      cache_dir: str | None = None,
                      ) -> tuple[LintResult, LintCache | None]:
    """The CLI's cached lint entry.  ``cache_dir`` None runs the plain
    uncached path (``--no-cache``); otherwise parse pickles and the
    findings payload are reused when content allows.  Returns the
    result plus the cache handle (hit/miss counters for the verbose
    trailer)."""
    from deeprest_tpu_torch.analysis.core import parse_files

    if cache_dir is None:
        return (lint_project(
            Project(parse_files(collect_py_files(paths), jobs=jobs)),
            rules=rules, baseline_keys=baseline_keys), None)

    cache = LintCache(cache_dir)
    manifest: list[tuple[str, str, str]] = []
    for rel, full in collect_py_files(paths):
        try:
            with open(full, "rb") as f:
                digest = _file_digest(f.read())
        except OSError:
            continue
        manifest.append((rel, full, digest))

    rule_ids = sorted(r.id for r in rules) if rules is not None else None
    key = LintCache.project_key(manifest, rule_ids)
    hit = cache.load_result(key)
    if hit is not None:
        kept, suppressed = hit
        return (apply_baseline(kept, suppressed, len(manifest),
                               baseline_keys), cache)

    project = Project(cache.load_sources(manifest))
    kept, suppressed = analyze_project(project, rules=rules)
    cache.store_result(key, kept, suppressed)
    return (apply_baseline(kept, suppressed, len(project.files),
                           baseline_keys), cache)
