"""graftlint core: files, findings, suppressions, baseline, runner.

An AST-based static-analysis framework purpose-built for THIS repo's
hard-won invariants.  Generic linters cannot see that a ``jax.jit``
closure capturing trained parameters silently constant-folds a
differently-rounding mask subgraph (the 1-ulp drift fix), or that GSPMD
compiles a second executable when a step function's output sharding
signature drifts (the sharding drift fix), or that a ``/healthz``
handler reads a reload counter a background thread is writing.
graftlint encodes exactly those bug classes as mechanical rules and runs
over the whole package as a tier-1 test (tests/test_torch_lint_clean.py),
the Python-side twin of the native featurizer's ``-fsanitize=thread``
selftest (native/Makefile).

Vocabulary:

- A **rule** (:class:`Rule`) inspects a :class:`Project` (all parsed
  files) and yields :class:`Finding`s.  Rules register under stable ids
  (``JX001``...), grouped in packs: JX (JAX compile/readback
  invariants), TH (threading), HY (hygiene), GL (the linter's own
  meta-findings, e.g. malformed suppressions).
- A **suppression** is an in-code comment on (or immediately above) the
  offending line::

      # graftlint: disable=JX003 -- log-boundary readback, by design

  The reason string after ``--`` is REQUIRED: a bare disable is itself
  reported (GL001).  Suppressions are the mechanism for *documented,
  deliberate* deviations; they live next to the code they excuse.
- The **baseline** is a checked-in JSON list of finding keys that are
  tolerated repo-wide.  The repo's own baseline
  (deeprest_tpu_torch/analysis/baseline.json) is EMPTY and the tier-1
  self-check (tests/test_torch_lint_clean.py) pins it that way: real
  findings get fixed (or visibly suppressed with a reason), not
  baselined away.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Iterable, Iterator


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location.  ``related`` carries
    secondary witness sites — ``(path, line, col, message)`` tuples —
    for rules whose evidence spans two locations (the RC pack's
    two-site race witnesses); SARIF renders them as
    ``relatedLocations``."""

    path: str          # posix path relative to the lint root
    line: int
    col: int
    rule: str
    message: str
    related: tuple = ()

    def __post_init__(self):
        # normalize (the findings cache round-trips through JSON, which
        # revives the witness tuples as lists)
        if not isinstance(self.related, tuple) or any(
                not isinstance(r, tuple) for r in self.related):
            object.__setattr__(self, "related", tuple(
                tuple(r) for r in self.related))

    def key(self) -> str:
        """Baseline identity: line numbers are EXCLUDED so unrelated
        edits above a baselined finding do not churn the file."""
        return f"{self.rule}|{self.path}|{self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- suppressions -----------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:--\s*(.*\S))?\s*$")
_RULE_ID_RE = re.compile(r"^[A-Z]{2}\d{3}$")


@dataclasses.dataclass
class Suppression:
    line: int
    rules: tuple[str, ...]
    reason: str | None
    own_line: bool     # comment-only line: applies to the NEXT line too


def parse_suppressions(lines: list[str]) -> list[Suppression]:
    out = []
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        out.append(Suppression(
            line=i, rules=rules, reason=m.group(2),
            own_line=text.lstrip().startswith("#")))
    return out


# -- parsed files -----------------------------------------------------------


class SourceFile:
    """One parsed module plus the lookaside data every rule needs."""

    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.suppressions = parse_suppressions(self.lines)
        self.syntax_error: SyntaxError | None = None
        try:
            self.tree: ast.Module | None = ast.parse(source)
        except SyntaxError as e:
            self.tree = None
            self.syntax_error = e
        self._parents: dict[ast.AST, ast.AST] | None = None
        self._all_nodes: tuple | None = None

    def walk(self) -> tuple:
        """Every node of the tree in ``ast.walk`` (BFS) order,
        materialized once.  ~20 rule packs iterate the full tree of
        every file; sharing one flattened pass keeps the package-wide
        lint self-check inside its 10s tier-1 budget."""
        nodes = getattr(self, "_all_nodes", None)   # absent on instances
        if nodes is None:                           # revived by the cache
            nodes = self._all_nodes = (tuple(ast.walk(self.tree))
                                       if self.tree is not None else ())
        return nodes

    def parents(self) -> dict[ast.AST, ast.AST]:
        """child → parent map (built lazily, once)."""
        if self._parents is None:
            self._parents = {}
            if self.tree is not None:
                for node in ast.walk(self.tree):
                    for child in ast.iter_child_nodes(node):
                        self._parents[child] = node
        return self._parents

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        p = self.parents()
        while node in p:
            node = p[node]
            yield node

    def finding(self, node_or_line, rule: str, message: str) -> Finding:
        if isinstance(node_or_line, int):
            return Finding(self.rel, node_or_line, 0, rule, message)
        return Finding(self.rel, getattr(node_or_line, "lineno", 1),
                       getattr(node_or_line, "col_offset", 0), rule, message)

    def suppressed(self, finding: Finding) -> bool:
        for s in self.suppressions:
            if finding.rule not in s.rules or s.reason is None:
                continue
            if s.line == finding.line:
                return True
            if s.own_line and s.line == finding.line - 1:
                return True
        return False


class Project:
    """Every parsed file under the lint root, shared by all rules."""

    def __init__(self, files: list[SourceFile]):
        self.files = sorted(files, key=lambda f: f.rel)
        self.by_rel = {f.rel: f for f in self.files}
        self._graph: "CallGraph | None" = None

    def call_graph(self) -> "CallGraph":
        """The project-wide symbol table + call graph (built lazily, once,
        shared by every rule that needs cross-function or cross-module
        resolution)."""
        if self._graph is None:
            self._graph = CallGraph(self)
        return self._graph

    @classmethod
    def from_dir(cls, root: str, jobs: int | None = None) -> "Project":
        return cls(parse_files(walk_py_files(root), jobs=jobs))

    @classmethod
    def from_sources(cls, sources: dict[str, str]) -> "Project":
        """Tests and callers with in-memory code: {relpath: source}."""
        return cls([SourceFile(rel, src) for rel, src in sources.items()])


def walk_py_files(root: str) -> list[tuple[str, str]]:
    """``(rel, full_path)`` for every .py under ``root``, sorted — the
    one directory walk Project.from_dir and the lint cache share, so
    both layers agree on file identity."""
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            paths.append((rel, full))
    return paths


def _parse_one(item: tuple[str, str]) -> SourceFile:
    """Worker for the parallel parse pool (top-level so spawn can pickle
    it; the SourceFile ships back with its parsed tree)."""
    rel, full = item
    with open(full, encoding="utf-8") as f:
        return SourceFile(rel, f.read())


# Below this many files the pool's spawn cost exceeds the parse it
# saves — measured on this tree: 75 files parse serially in ~0.22s
# while a spawn pool costs ~0.6s before the first file lands (workers
# re-import the interpreter); the crossover sits around a couple
# hundred files, so the repo's own lint stays serial and only genuinely
# large trees fan out.
_PARALLEL_MIN_FILES = 192


def parse_files(paths: list[tuple[str, str]],
                jobs: int | None = None) -> list[SourceFile]:
    """Parse ``(rel, full_path)`` pairs, fanning out across ``jobs``
    worker processes when the file count makes it worthwhile.  ``jobs``
    None or 1 parses serially; any pool failure (a restricted host, no
    semaphores) falls back to the serial path — parallelism is a speedup,
    never a requirement."""
    if jobs is None or jobs <= 1 or len(paths) < _PARALLEL_MIN_FILES:
        return [_parse_one(p) for p in paths]
    try:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # spawn, not fork: the CLI process may have initialized CUDA, and
        # forking a CUDA-initialized process is unsafe
        ctx = mp.get_context("spawn")
        workers = min(jobs, len(paths))
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=ctx) as pool:
            chunk = max(1, len(paths) // (workers * 4))
            return list(pool.map(_parse_one, paths, chunksize=chunk))
    except Exception:
        return [_parse_one(p) for p in paths]


# -- rules ------------------------------------------------------------------


class Rule:
    """Base rule: subclass, set ``id``/``title``/``guards``, implement
    :meth:`run`.  ``guards`` names the historical incident the rule
    exists to prevent (surfaced by ``lint --list-rules`` and
    ANALYSIS.md)."""

    id: str = "XX000"
    title: str = ""
    guards: str = ""

    def run(self, project: Project) -> Iterator[Finding]:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    rule = rule_cls()
    if not _RULE_ID_RE.match(rule.id):
        raise ValueError(f"bad rule id {rule.id!r}")
    if rule.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {rule.id}")
    _REGISTRY[rule.id] = rule
    return rule_cls


def all_rules() -> dict[str, Rule]:
    """The registry, with every built-in rule pack imported."""
    import importlib

    for pack in ("rules_jax", "rules_threading", "rules_hygiene",
                 "rules_obs", "rules_data", "rules_lifecycle",
                 "rules_exceptions", "rules_fleet", "rules_wire",
                 "rules_races", "rules_torch"):
        importlib.import_module(f"deeprest_tpu_torch.analysis.{pack}")
    return dict(_REGISTRY)


# -- meta rules (the linter checking its own machinery) ---------------------


def _meta_findings(project: Project, known_rules: set[str],
                   rule_objs: Iterable[Rule] = ()) -> list[Finding]:
    out = []
    # GL004: an uncited rule.  Every registered rule must carry the
    # guarded-incident citation (`guards`) that --list-rules and the
    # ANALYSIS.md catalog surface — a rule that cannot say which
    # incident it prevents is a rule nobody can review, suppress
    # against, or retire.  Anchored at the rule's class definition when
    # the pack file is inside the linted tree.
    for rule in rule_objs:
        if rule.guards and rule.title:
            continue
        cls_name = type(rule).__name__
        path, line = "<registry>", 0
        for sf in project.files:
            if sf.tree is None:
                continue
            hit = next((n for n in sf.tree.body
                        if isinstance(n, ast.ClassDef)
                        and n.name == cls_name), None)
            if hit is not None:
                path, line = sf.rel, hit.lineno
                break
        missing = ("guarded-incident citation (guards)" if rule.title
                   else "title and guarded-incident citation")
        out.append(Finding(
            path, line, 0, "GL004",
            f"rule {rule.id} ({cls_name}) is registered without a "
            f"{missing}: every rule must name the incident it guards "
            "against (--list-rules / ANALYSIS.md catalog)"))
    for f in project.files:
        if f.syntax_error is not None:
            out.append(Finding(f.rel, f.syntax_error.lineno or 1, 0, "GL003",
                               f"syntax error: {f.syntax_error.msg}"))
        for s in f.suppressions:
            if s.reason is None:
                out.append(Finding(
                    f.rel, s.line, 0, "GL001",
                    "suppression without a reason: append "
                    "' -- <why this deviation is deliberate>'"))
            for rid in s.rules:
                if rid not in known_rules and not rid.startswith("GL"):
                    out.append(Finding(
                        f.rel, s.line, 0, "GL002",
                        f"suppression names unknown rule {rid!r}"))
    return out


GL_RULES = {
    "GL001": "suppression missing its required reason string",
    "GL002": "suppression names a rule id that does not exist",
    "GL003": "file does not parse",
    "GL004": "registered rule lacks its guarded-incident citation",
}


# -- baseline ---------------------------------------------------------------


def load_baseline(path: str) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    keys = data.get("findings", [])
    if not isinstance(keys, list) or not all(isinstance(k, str) for k in keys):
        raise ValueError(f"malformed baseline {path!r}: 'findings' must be "
                         "a list of finding keys")
    return keys


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    keys = sorted(f.key() for f in findings)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": keys}, f, indent=2)
        f.write("\n")


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


# -- runner -----------------------------------------------------------------


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]          # live (non-baselined, non-suppressed)
    baselined: list[Finding]
    suppressed_count: int
    files: int


def analyze_project(project: Project,
                    rules: Iterable[Rule] | None = None,
                    timings: dict | None = None,
                    ) -> tuple[list[Finding], int]:
    """Run meta checks + rule packs and apply in-code suppressions:
    ``(kept findings, suppressed count)``.  This is the (expensive,
    content-determined) half the incremental cache stores — the
    baseline split happens in :func:`apply_baseline` because the
    baseline file can change independently of the tree.

    ``timings``, when given, is filled with per-pack wall seconds
    keyed by the two-letter pack prefix (plus ``meta``).  Shared lazy
    infrastructure (the call graph, the value-flow and lockset
    fixpoints) is charged to the FIRST pack that touches it — the
    honest cost of running that pack alone."""
    import time as _time

    rule_objs = (list(rules) if rules is not None
                 else list(all_rules().values()))
    t0 = _time.perf_counter()
    raw: list[Finding] = _meta_findings(
        project, {r.id for r in rule_objs} | set(all_rules()), rule_objs)
    if timings is not None:
        timings["meta"] = _time.perf_counter() - t0
    for rule in rule_objs:
        t0 = _time.perf_counter()
        raw.extend(rule.run(project))
        if timings is not None:
            pack = rule.id[:2]
            timings[pack] = (timings.get(pack, 0.0)
                             + _time.perf_counter() - t0)

    suppressed = 0
    kept: list[Finding] = []
    for f in raw:
        sf = project.by_rel.get(f.path)
        if sf is not None and sf.suppressed(f):
            suppressed += 1
        else:
            kept.append(f)
    return kept, suppressed


def apply_baseline(kept: Iterable[Finding], suppressed: int, files: int,
                   baseline_keys: Iterable[str] | None) -> LintResult:
    # Baseline keys consume one finding each (a multiset match): two
    # identical findings with one baseline entry leave one live.
    budget: dict[str, int] = {}
    for k in (baseline_keys or []):
        budget[k] = budget.get(k, 0) + 1
    live, base = [], []
    for f in sorted(kept):
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            base.append(f)
        else:
            live.append(f)
    return LintResult(findings=live, baselined=base,
                      suppressed_count=suppressed, files=files)


def lint_project(project: Project,
                 rules: Iterable[Rule] | None = None,
                 baseline_keys: Iterable[str] | None = None) -> LintResult:
    kept, suppressed = analyze_project(project, rules=rules)
    return apply_baseline(kept, suppressed, len(project.files),
                          baseline_keys)


def collect_py_files(paths: Iterable[str]) -> list[tuple[str, str]]:
    """``(rel, full_path)`` pairs for directories and/or single files —
    the shared file selector behind :func:`load_project` and the
    incremental cache's content-hash manifest."""
    out: list[tuple[str, str]] = []
    for path in paths:
        if os.path.isdir(path):
            out.extend(walk_py_files(path))
        else:
            out.append((os.path.basename(path), path))
    return out


def load_project(paths: Iterable[str],
                 jobs: int | None = None) -> Project:
    """One Project over directories and/or single files (the CLI's
    loading path; ``jobs`` fans the parse across worker processes)."""
    return Project(parse_files(collect_py_files(paths), jobs=jobs))


def lint_paths(paths: Iterable[str],
               rules: Iterable[Rule] | None = None,
               baseline_keys: Iterable[str] | None = None,
               jobs: int | None = None) -> LintResult:
    """Lint directories and/or single files (the CLI entry)."""
    return lint_project(load_project(paths, jobs=jobs), rules=rules,
                        baseline_keys=baseline_keys)


def lint_sources(sources: dict[str, str],
                 rules: Iterable[Rule] | None = None,
                 baseline_keys: Iterable[str] | None = None) -> LintResult:
    """In-memory entry point (fixture tests)."""
    return lint_project(Project.from_sources(sources), rules=rules,
                        baseline_keys=baseline_keys)


# -- shared AST helpers (used by the rule packs) ----------------------------


def call_name(node: ast.AST) -> str | None:
    """Dotted name of a call target / attribute chain, best effort:
    ``jax.jit`` → "jax.jit", ``self._ladder.dispatch`` →
    "self._ladder.dispatch", anything dynamic → None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


JIT_NAMES = {"jax.jit", "jit", "pjit", "jax.experimental.pjit.pjit"}


def is_jit_call(call: ast.Call) -> bool:
    name = call_name(call.func)
    return name in JIT_NAMES


def scope_bound_names(fn: ast.AST) -> set[str]:
    """Names bound in a function scope: parameters plus every assignment
    target / import / def at that scope (no descent into nested function
    or class scopes — those bind their own names)."""
    bound: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            bound.add(a.arg)
        if args.vararg:
            bound.add(args.vararg.arg)
        if args.kwarg:
            bound.add(args.kwarg.arg)

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                bound.add(child.name)
                continue            # its body is a new scope
            if isinstance(child, ast.ClassDef):
                bound.add(child.name)
                continue
            if isinstance(child, ast.Lambda):
                continue
            if isinstance(child, ast.Name) and isinstance(
                    child.ctx, (ast.Store, ast.Del)):
                bound.add(child.id)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                for alias in child.names:
                    bound.add((alias.asname
                               or alias.name.split(".")[0]))
            elif isinstance(child, ast.comprehension):
                # comprehension targets technically live in their own
                # scope; treating them as bound here only makes the
                # closure analysis more conservative
                for n in ast.walk(child.target):
                    if isinstance(n, ast.Name):
                        bound.add(n.id)
            visit(child)

    body = fn.body if isinstance(getattr(fn, "body", None), list) else [fn.body]
    for stmt in body:
        if isinstance(stmt, ast.Name) and isinstance(
                stmt.ctx, (ast.Store, ast.Del)):
            bound.add(stmt.id)
        visit(stmt)
    return bound


def enclosing_function_scopes(sf: SourceFile,
                              node: ast.AST) -> list[ast.AST]:
    """Enclosing FunctionDef/Lambda chain for ``node`` (innermost first),
    EXCLUDING the module scope — module globals are not closures."""
    return [a for a in sf.ancestors(node)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda))]


def in_loop(sf: SourceFile, node: ast.AST) -> bool:
    """True when ``node`` sits inside a for/while loop (or comprehension)
    without an intervening function boundary."""
    for anc in sf.ancestors(node):
        if isinstance(anc, (ast.For, ast.While, ast.AsyncFor,
                            ast.ListComp, ast.SetComp, ast.DictComp,
                            ast.GeneratorExp)):
            return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return False
    return False


def iter_functions(sf: SourceFile) -> Iterator[ast.AST]:
    if sf.tree is None:
        return
    for node in sf.walk():
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            yield node


def walk_no_nested_scopes(node: ast.AST,
                          skip: Callable[[ast.AST], bool] | None = None,
                          ) -> Iterator[ast.AST]:
    """Walk a function/class body without entering nested function or
    class scopes (``skip`` vetoes additional subtrees)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        if skip is not None and skip(n):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def transitive_closure(edges: dict[str, set[str]],
                       seeds: Iterable[str],
                       max_depth: int | None = None) -> set[str]:
    """Bounded-depth BFS closure over a string-keyed edge map.  The one
    closure every rule shares: TH001's thread-entry propagation, TH003's
    child-side method set, and the call graph's reachability all used to
    hand-roll this walk."""
    reached = set(seeds)
    frontier = set(reached)
    depth = 0
    while frontier and (max_depth is None or depth < max_depth):
        nxt: set[str] = set()
        for name in frontier:
            for callee in edges.get(name, ()):
                if callee not in reached:
                    reached.add(callee)
                    nxt.add(callee)
        frontier = nxt
        depth += 1
    return reached


# -- whole-program symbol table + call graph --------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class FuncKey:
    """Identity of one function in the project: module file, enclosing
    class (or None for module level), and name."""

    rel: str
    cls: str | None
    name: str

    def __str__(self) -> str:
        suffix = f"{self.cls}.{self.name}" if self.cls else self.name
        return f"{self.rel}::{suffix}"


def _self_name_of(method: ast.AST) -> str:
    """The instance-receiver name of a method ('' for staticmethods —
    their first arg is NOT the instance; the ReplicaRouter._probe_meta
    lesson from TH004)."""
    if any(isinstance(d, ast.Name) and d.id == "staticmethod"
           for d in getattr(method, "decorator_list", [])):
        return ""
    args = getattr(method, "args", None)
    if args is not None and args.args:
        return args.args[0].arg
    return "self"


class CallGraph:
    """Project-wide symbol table + resolved call graph.

    Before this existed every rule pack re-implemented its own ad-hoc
    transitive-self-call walk and none could see across module
    boundaries (the same few-annotations-propagated-everywhere gap the
    partition-rule table closes for shardings).  The graph resolves:

    - ``self._helper()``          → the same class's method
    - ``helper()``                → a module-level function in the file
                                    (or one imported via ``from m import f``)
    - ``pkg.mod.fn(...)``         → a function in another linted module,
                                    through ``import``/``from``/aliases —
                                    function-scoped lazy imports included
                                    (this repo's startup-cost idiom)
    - ``Class.method`` chains     → the named class's method

    Module identity is matched on dotted-path *suffixes*, so the same
    resolution works whether the lint root is the installed package dir
    (rel ``serve/replica.py``) or the repo root
    (``deeprest_tpu_torch/serve/replica.py``); ambiguous suffixes resolve to
    nothing rather than to a guess.
    """

    MAX_DEPTH = 8          # bounded transitive closure (reachable())

    def __init__(self, project: Project):
        self.project = project
        self.functions: dict[FuncKey, ast.AST] = {}
        # dotted-suffix → rel (None marks an ambiguous suffix)
        self._module_index: dict[tuple[str, ...], str | None] = {}
        # rel → {class name → {method name → node}}
        self._classes: dict[str, dict[str, dict[str, ast.AST]]] = {}
        # rel → {module-level function name → node}
        self._module_fns: dict[str, dict[str, ast.AST]] = {}
        # rel → {alias → ("mod", parts) | ("obj", parts, name)}
        self._imports: dict[str, dict[str, tuple]] = {}
        self._edges: dict[FuncKey, set[FuncKey]] = {}
        # reachable()'s string-keyed view, built once on first use
        self._str_edges: dict[str, set[str]] | None = None
        self._by_str: dict[str, FuncKey] = {}
        self._build()

    # -- construction ----------------------------------------------------

    @staticmethod
    def _module_parts(rel: str) -> tuple[str, ...]:
        parts = rel.replace("\\", "/").split("/")
        leaf = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
        if leaf == "__init__":
            return tuple(parts[:-1])
        return tuple(parts[:-1]) + (leaf,)

    def _build(self) -> None:
        for sf in self.project.files:
            if sf.tree is None:
                continue
            mod = self._module_parts(sf.rel)
            for i in range(len(mod)):
                suffix = mod[i:]
                if not suffix:
                    continue
                if suffix in self._module_index \
                        and self._module_index[suffix] != sf.rel:
                    self._module_index[suffix] = None      # ambiguous
                else:
                    self._module_index[suffix] = sf.rel
            fns: dict[str, ast.AST] = {}
            classes: dict[str, dict[str, ast.AST]] = {}
            for node in sf.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fns[node.name] = node
                    self.functions[FuncKey(sf.rel, None, node.name)] = node
                elif isinstance(node, ast.ClassDef):
                    methods = {
                        m.name: m for m in node.body
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
                    classes[node.name] = methods
                    for name, m in methods.items():
                        self.functions[FuncKey(sf.rel, node.name, name)] = m
            self._module_fns[sf.rel] = fns
            self._classes[sf.rel] = classes
            self._imports[sf.rel] = self._import_table(sf)
        for key, node in self.functions.items():
            self._edges[key] = self._function_edges(key, node)

    @staticmethod
    def _import_table(sf: SourceFile) -> dict[str, tuple]:
        """Alias → import target for EVERY import in the file, including
        function-scoped lazy imports (the package's startup-cost idiom
        means most cross-module references live inside functions)."""
        table: dict[str, tuple] = {}
        for node in sf.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    parts = tuple(a.name.split("."))
                    if a.asname:
                        table[a.asname] = ("mod", parts)
                    else:
                        # `import a.b.c` binds `a`; dotted uses resolve
                        # through the full path at the call site
                        table[parts[0]] = ("mod", (parts[0],))
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                base = tuple(node.module.split("."))
                for a in node.names:
                    if a.name == "*":
                        continue
                    table[a.asname or a.name] = ("obj", base, a.name)
        return table

    def resolve_module(self, dotted: tuple[str, ...]) -> str | None:
        """rel path of the linted file a dotted module path names, or
        None (unknown / ambiguous)."""
        for j in range(len(dotted)):
            rel = self._module_index.get(dotted[j:])
            if rel is not None:
                return rel
        return None

    def _lookup(self, rel: str, cls: str | None,
                name: str) -> FuncKey | None:
        if cls is not None:
            if name in self._classes.get(rel, {}).get(cls, {}):
                return FuncKey(rel, cls, name)
            return None
        if name in self._module_fns.get(rel, {}):
            return FuncKey(rel, None, name)
        return None

    def resolve_call(self, rel: str, cls: str | None,
                     self_name: str, call: ast.Call) -> FuncKey | None:
        """Resolve one call site to a linted function, best effort."""
        dotted = call_name(call.func)
        if dotted is None:
            return None
        parts = dotted.split(".")
        # self.method()
        if (cls is not None and self_name and len(parts) == 2
                and parts[0] == self_name):
            return self._lookup(rel, cls, parts[1])
        table = self._imports.get(rel, {})
        # bare name: imported object, else same-module function
        if len(parts) == 1:
            entry = table.get(parts[0])
            if entry is not None and entry[0] == "obj":
                target = self.resolve_module(entry[1])
                if target is not None:
                    return self._lookup(target, None, entry[2])
                return None
            return self._lookup(rel, None, parts[0])
        # Class.method() in the same module
        if len(parts) == 2 and parts[0] in self._classes.get(rel, {}):
            return self._lookup(rel, parts[0], parts[1])
        # dotted: expand a leading alias, then try (module).fn and
        # (module).Class.method splits, longest module first
        head = table.get(parts[0])
        if head is not None:
            if head[0] == "mod":
                expanded = head[1] + tuple(parts[1:])
            else:                          # from pkg import mod
                expanded = head[1] + (head[2],) + tuple(parts[1:])
        else:
            expanded = tuple(parts)
        for split in range(len(expanded) - 1, 0, -1):
            target = self.resolve_module(expanded[:split])
            if target is None:
                continue
            rest = expanded[split:]
            if len(rest) == 1:
                hit = self._lookup(target, None, rest[0])
            elif len(rest) == 2:
                hit = self._lookup(target, rest[0], rest[1])
            else:
                hit = None
            if hit is not None:
                return hit
        return None

    def _function_edges(self, key: FuncKey,
                        node: ast.AST) -> set[FuncKey]:
        self_name = _self_name_of(node) if key.cls else ""
        out: set[FuncKey] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                hit = self.resolve_call(key.rel, key.cls, self_name, sub)
                if hit is not None and hit != key:
                    out.add(hit)
        return out

    # -- queries ---------------------------------------------------------

    def edges(self, key: FuncKey) -> set[FuncKey]:
        return self._edges.get(key, set())

    def reachable(self, seeds: Iterable[FuncKey],
                  max_depth: int | None = None) -> set[FuncKey]:
        """Bounded-depth transitive closure over the resolved graph."""
        depth = self.MAX_DEPTH if max_depth is None else max_depth
        if self._str_edges is None:
            # built once: several rules call reachable() per lint run
            self._str_edges = {str(k): {str(v) for v in vs}
                               for k, vs in self._edges.items()}
            self._by_str = {str(k): k for k in self._edges}
        names = transitive_closure(self._str_edges,
                                   [str(s) for s in seeds], depth)
        return {self._by_str[n] for n in names if n in self._by_str}

    def class_method_edges(self, rel: str,
                           cls: str) -> dict[str, set[str]]:
        """``{method → same-class methods it calls}`` for one class —
        the edge map TH001's thread-entry propagation and TH003's
        child-side closure walk (they used to hand-roll this)."""
        out: dict[str, set[str]] = {}
        for name in self._classes.get(rel, {}).get(cls, {}):
            key = FuncKey(rel, cls, name)
            out[name] = {e.name for e in self._edges.get(key, set())
                         if e.rel == rel and e.cls == cls}
        return out

    def function_node(self, key: FuncKey) -> ast.AST | None:
        return self.functions.get(key)


# -- path-sensitive paired-operation dataflow -------------------------------
#
# The acquire/release obligation walker behind the RS/EX rule packs: given
# a function, a statement where an obligation opens (a spawned resource, a
# bare lock acquire, a drain), and predicates for what discharges it, walk
# every path — through try/finally, with, early return, and raise edges —
# and report where the obligation survives to an exit.


@dataclasses.dataclass
class Leak:
    """One way an obligation escapes its function still open.

    ``kind`` is "path" (a normal control-flow path reaches an exit with
    the obligation open: fall-through, early return, explicit raise) or
    "exception" (a raise-capable statement can throw while the obligation
    is open, with no enclosing try/finally or handler that discharges
    it)."""

    kind: str
    node: ast.AST


_OPEN, _CLOSED = "open", "closed"
_FALL, _RETURN, _RAISE, _BREAK, _CONTINUE = range(5)


class ObligationWalker:
    """Tracks ONE obligation through one function body.

    ``open_at`` is the statement that creates the obligation; with
    ``open_mode`` "after" the obligation exists after the statement
    completes, with "body" it exists inside the statement's body only
    (the ``if x.acquire(): ...`` shape, where the else-branch never held
    it).  ``closes(stmt)`` is the discharge predicate — a release call,
    an ownership escape, whatever the rule defines.  ``raise_capable``
    marks statements that can throw (default: anything containing a call
    or a raise)."""

    def __init__(self, fn: ast.AST, open_at: ast.stmt,
                 closes: Callable[[ast.stmt], bool],
                 open_mode: str = "after",
                 raise_capable: Callable[[ast.stmt], bool] | None = None,
                 assume_loops_run: bool = False):
        self.fn = fn
        self.open_at = open_at
        self.closes = closes
        self.open_mode = open_mode
        # assume_loops_run drops the zero-iteration join term: the
        # drain-loop/resume-loop idiom iterates the SAME replica set
        # twice, so "first loop ran, second ran zero times" is not a
        # real path — without this every paired loop pair would flag
        self.assume_loops_run = assume_loops_run
        self.raise_capable = raise_capable or self._default_raise_capable
        self.leaks: list[Leak] = []
        self._exception_reported = False
        # per-Try: an exception CAN strike while the obligation is open
        # somewhere inside (drives the handler-entry state)
        self._open_raise: set[int] = set()

    # Cleanup/bookkeeping method calls and pure builtins are treated as
    # non-raising: "your finally's close() might itself throw" is beyond
    # what a lint can usefully demand, and counting logging/collection
    # bookkeeping as raise edges would flag every cleanup handler.
    NONRAISING_METHODS = frozenset({
        "close", "join", "terminate", "kill", "release", "shutdown",
        "stop", "stop_trace", "cancel", "clear", "discard", "notify",
        "notify_all", "set", "unlink", "detach", "append", "appendleft",
        "add", "extend", "setdefault", "items", "keys", "values",
        "info", "debug", "warning", "error", "is_alive",
    })
    NONRAISING_BUILTINS = frozenset({
        "print", "len", "id", "isinstance", "issubclass", "sorted",
        "list", "dict", "tuple", "set", "str", "repr", "format", "min",
        "max", "sum", "round", "abs", "range", "enumerate", "zip",
        "bool", "int", "float", "hasattr", "callable", "type", "vars",
    })

    @classmethod
    def _default_raise_capable(cls, stmt: ast.stmt) -> bool:
        if isinstance(stmt, ast.Raise):
            return True
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return False       # defining a function does not run it
        for n in walk_no_nested_scopes(stmt):
            if not isinstance(n, ast.Call):
                continue
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in cls.NONRAISING_METHODS:
                continue
            if isinstance(n.func, ast.Name) \
                    and n.func.id in cls.NONRAISING_BUILTINS:
                continue
            return True
        return False

    # ``try_ctx`` is the stack of enclosing Try nodes; an implicit raise
    # is covered when any of them discharges the obligation in a finally
    # or in a handler body.
    def _try_covers(self, try_ctx: list[ast.Try]) -> bool:
        for t in try_ctx:
            for stmt in t.finalbody:
                if self._block_closes(stmt):
                    return True
            for h in t.handlers:
                for stmt in h.body:
                    if self._block_closes(stmt):
                        return True
        return False

    def _block_closes(self, stmt: ast.stmt) -> bool:
        """closes() over a statement and its nested blocks (a finally
        whose `if` branch closes still counts)."""
        for n in ast.walk(stmt):
            if isinstance(n, ast.stmt) and self.closes(n):
                return True
        return False

    def run(self) -> list[Leak]:
        body = self.fn.body if isinstance(self.fn.body, list) else []
        exits = self._walk(body, _CLOSED, [])
        for outcome, state, node in exits:
            if state == _OPEN and outcome in (_FALL, _RETURN, _RAISE):
                self.leaks.append(Leak("path", node))
        return self.leaks

    def _note_exception(self, stmt: ast.stmt,
                        try_ctx: list[ast.Try]) -> None:
        for t in try_ctx:
            self._open_raise.add(id(t))
        if self._exception_reported:
            return
        # inside a try with handlers the exception is (assumed) caught
        # and the handler path is walked separately; only an UNCOVERED
        # raise site leaks
        for t in try_ctx:
            if t.handlers:
                return
        if self._try_covers(try_ctx):
            return
        self._exception_reported = True
        self.leaks.append(Leak("exception", stmt))

    def _walk(self, stmts: list[ast.stmt], state: str,
              try_ctx: list[ast.Try]):
        """Returns the set of (outcome, state, node) exits of the block."""
        exits: list[tuple[int, str, ast.AST]] = []
        last: ast.AST = stmts[-1] if stmts else self.fn
        for stmt in stmts:
            if stmt is self.open_at:
                if self.open_mode == "body":
                    # obligation held inside the statement's body only
                    inner = getattr(stmt, "body", [])
                    orelse = getattr(stmt, "orelse", [])
                    for out in self._walk(inner, _OPEN, try_ctx):
                        if out[0] == _FALL:
                            state = self._join(state, out[1])
                        else:
                            exits.append(out)
                    for out in self._walk(orelse, state, try_ctx):
                        if out[0] == _FALL:
                            state = self._join(state, out[1])
                        else:
                            exits.append(out)
                    continue
                state_after = self._step(stmt, _CLOSED, try_ctx, exits)
                state = _OPEN if state_after != "divert" else state
                continue
            res = self._step(stmt, state, try_ctx, exits)
            if res == "divert":
                return exits            # every path left the block
            state = res
        exits.append((_FALL, state, last))
        return exits

    def _join(self, a: str, b: str) -> str:
        return _OPEN if _OPEN in (a, b) else _CLOSED

    def _step(self, stmt: ast.stmt, state: str,
              try_ctx: list[ast.Try], exits: list) -> str:
        """Process one statement; returns the state after it on the
        fall-through path, or "divert" when no path falls through."""
        compound = isinstance(stmt, (ast.If, ast.For, ast.AsyncFor,
                                     ast.While, ast.With, ast.AsyncWith,
                                     ast.Try))
        if not compound and self.closes(stmt):
            return _CLOSED
        if isinstance(stmt, ast.Return):
            if state == _OPEN and not self._try_covers(try_ctx):
                exits.append((_RETURN, state, stmt))
            else:
                exits.append((_RETURN, _CLOSED, stmt))
            return "divert"
        if isinstance(stmt, ast.Raise):
            if state == _OPEN:
                for t in try_ctx:
                    self._open_raise.add(id(t))
            if state == _OPEN and not self._caught_or_covered(try_ctx):
                exits.append((_RAISE, state, stmt))
            else:
                exits.append((_RAISE, _CLOSED, stmt))
            return "divert"
        if isinstance(stmt, (ast.Break, ast.Continue)):
            exits.append((_BREAK if isinstance(stmt, ast.Break)
                          else _CONTINUE, state, stmt))
            return "divert"
        if isinstance(stmt, ast.If):
            # a receiver-guarded close (`if proc is not None:
            # proc.terminate()`) IS the runtime was-it-created check —
            # rules opt in via an If-aware closes predicate
            if self.closes(stmt):
                return _CLOSED
            s_body = self._branch(stmt.body, state, try_ctx, exits)
            s_else = self._branch(stmt.orelse, state, try_ctx, exits)
            if s_body is None and s_else is None:
                return "divert"
            if s_body is None:
                return s_else
            if s_else is None:
                return s_body
            return self._join(s_body, s_else)
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            # exception edges are noted per simple statement INSIDE the
            # body (where the enclosing-try context is known), not at
            # whole-loop granularity
            s_body = self._branch(stmt.body, state, try_ctx, exits,
                                  loop=True)
            parts = []
            if s_body is not None:
                parts.append(s_body)
            if not self.assume_loops_run or s_body is None:
                parts.append(state)            # the zero-iteration path
            base = _OPEN if _OPEN in parts else _CLOSED
            s_else = self._branch(stmt.orelse, base, try_ctx, exits)
            return base if s_else is None else s_else
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            s_body = self._branch(stmt.body, state, try_ctx, exits)
            return state if s_body is None else s_body
        if isinstance(stmt, ast.Try):
            inner_ctx = try_ctx + [stmt]
            body_exits = self._walk(stmt.body, state, inner_ctx)
            after: list[str] = []
            for outcome, st, node in body_exits:
                if outcome == _FALL:
                    after.append(st)
                else:
                    exits.append((outcome, st, node))
            # A handler only runs when something in the body raised; the
            # obligation is open at its entry exactly when an exception
            # could strike while it was open (_open_raise) — joining the
            # body's FALL-THROUGH state here would walk the handler from
            # a state that cannot reach it.
            handler_entry = (_OPEN if id(stmt) in self._open_raise
                             else _CLOSED)
            for h in stmt.handlers:
                h_exits = self._walk(h.body, handler_entry, try_ctx)
                for outcome, st, node in h_exits:
                    if outcome == _FALL:
                        after.append(st)
                    else:
                        exits.append((outcome, st, node))
            if stmt.orelse and after:
                entry = (_OPEN if _OPEN in after else _CLOSED)
                after = []
                for outcome, st, node in self._walk(stmt.orelse, entry,
                                                    try_ctx):
                    if outcome == _FALL:
                        after.append(st)
                    else:
                        exits.append((outcome, st, node))
            final_closes = any(self._block_closes(s)
                               for s in stmt.finalbody)
            if final_closes:
                # the finally discharges EVERY path through the try —
                # including the non-FALL exits recorded above
                patched = [(o, _CLOSED, n) if n_in_try else (o, st, n)
                           for (o, st, n), n_in_try in
                           ((e, self._inside(stmt, e[2])) for e in exits)]
                exits[:] = patched
                after = [_CLOSED for _ in after]
            if not after:
                return "divert"
            return _OPEN if _OPEN in after else _CLOSED
        # plain statement
        if state == _OPEN and self.raise_capable(stmt):
            self._note_exception(stmt, try_ctx)
        # nested opens inside expressions do not change this obligation
        return state

    @staticmethod
    def _inside(container: ast.AST, node: ast.AST) -> bool:
        for n in ast.walk(container):
            if n is node:
                return True
        return False

    def _caught_or_covered(self, try_ctx: list[ast.Try]) -> bool:
        for t in try_ctx:
            if t.handlers:
                return True
        return self._try_covers(try_ctx)

    def _branch(self, stmts: list[ast.stmt], state: str,
                try_ctx: list[ast.Try], exits: list,
                loop: bool = False) -> str | None:
        """Walk one branch; returns its fall-through state, or None when
        no path falls through."""
        if not stmts:
            return state
        after: list[str] = []
        for outcome, st, node in self._walk(stmts, state, try_ctx):
            if outcome == _FALL or (loop and outcome in (_BREAK,
                                                         _CONTINUE)):
                after.append(st)
            else:
                exits.append((outcome, st, node))
        if not after:
            return None
        return _OPEN if _OPEN in after else _CLOSED


def dotted_name(node: ast.AST) -> str | None:
    """Alias of :func:`call_name` with a rule-pack-friendly name: the
    dotted receiver chain of an attribute/name expression."""
    return call_name(node)


def receiver_escapes(stmt: ast.stmt, receiver: str) -> bool:
    """Ownership of ``receiver`` is transferred by ``stmt``: stored on an
    attribute/subscript/container, returned, yielded, or passed as a call
    ARGUMENT (not as the receiver of a method call).  After an escape the
    resource has an owner other than this function's frame, so the local
    obligation is discharged."""

    def contains(node: ast.AST | None) -> bool:
        if node is None:
            return False
        for n in ast.walk(node):
            if dotted_name(n) == receiver and isinstance(
                    getattr(n, "ctx", ast.Load()), ast.Load):
                return True
        return False

    if isinstance(stmt, ast.Assign):
        if any(isinstance(t, (ast.Attribute, ast.Subscript))
               for t in stmt.targets) and contains(stmt.value):
            return True
    if isinstance(stmt, (ast.Return, ast.Expr)) and isinstance(
            getattr(stmt, "value", None), ast.Yield):
        if contains(stmt.value.value):
            return True
    if isinstance(stmt, ast.Return) and contains(stmt.value):
        return True
    for n in ast.walk(stmt):
        if not isinstance(n, ast.Call):
            continue
        # receiver as an argument (or inside one) transfers ownership;
        # receiver as the METHOD TARGET (receiver.close()) does not
        for arg in list(n.args) + [kw.value for kw in n.keywords]:
            if contains(arg):
                return True
    return False


def method_call_on(stmt: ast.stmt, receiver: str,
                   methods: tuple[str, ...]) -> ast.Call | None:
    """The first ``receiver.<m>(...)`` call in ``stmt`` with m in
    ``methods``, or None."""
    for n in ast.walk(stmt):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr in methods
                and dotted_name(n.func.value) == receiver):
            return n
    return None


def guarded_if_closes(stmt: ast.stmt, receiver: str,
                      methods: tuple[str, ...]) -> bool:
    """``if proc is not None: proc.terminate()`` — an If whose TEST
    mentions the receiver and whose body discharges it is the runtime
    was-it-created check; the walker treats the whole If as a close.
    (An If with an unrelated test does NOT count: its else path really
    can leak.)"""
    if not isinstance(stmt, ast.If):
        return False
    if not any(dotted_name(n) == receiver for n in ast.walk(stmt.test)):
        return False
    return any(method_call_on(s, receiver, methods) is not None
               for s in stmt.body)


# -- suppression inventory --------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class SuppressionEntry:
    """One live in-code suppression (the --list-suppressions row)."""

    rule: str
    path: str
    line: int
    reason: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def suppression_inventory(project: Project) -> list[SuppressionEntry]:
    """Every reasoned in-code suppression in the project, one entry per
    (rule, site).  Reasonless disables are GL001 findings, not inventory
    rows — the inventory is the catalog of *documented* deviations."""
    out: list[SuppressionEntry] = []
    for sf in project.files:
        for s in sf.suppressions:
            if s.reason is None:
                continue
            for rule in s.rules:
                out.append(SuppressionEntry(rule=rule, path=sf.rel,
                                            line=s.line, reason=s.reason))
    return sorted(out)
