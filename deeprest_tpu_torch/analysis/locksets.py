"""graftrace: compositional interprocedural lockset analysis (RC pack).

The TH pack's race checks are syntactic: TH001 proves thread
reachability inside one class and TH004 flags locked/unlocked mixes —
but both only see ``ast.Store`` writes.  The last two rounds EACH
shipped a race they structurally could not catch: round 23's dispatch
read a freshly-spilled params tree (check under the engine lock, act
after release), and round 24's ``stats()`` iterated the wire latency
deque off-lock against ``commit()``'s locked ``extend`` — a *container
mutation*, which is an ``ast.Load`` of the attribute plus a method
call, invisible to ``written_outside_init``.

This module is the RacerD-lineage answer ([4] in PAPERS.md), layered on
the round-16 CallGraph:

- **Per-statement held-lock sets**: ``with self.<lock>`` blocks, bare
  ``acquire()``/``release()`` pairs (including the ``finally`` release
  idiom), and the ``*_locked``-suffix convention (called with the class
  lock held — modeled as a wildcard lock).  A
  ``threading.Condition(self._lock)`` ALIASES the lock it wraps —
  both names canonicalize to the underlying mutex, so the
  ``_cv``/``_lock`` pair (EngineReplica) is one guard, not a split
  guard.
- **Function summaries propagated through call chains**: a private
  helper called only from under a lock inherits that lock (intersection
  over all in-class call sites, iterated to fixpoint).
- **Mutation-as-write**: ``self.x.append(...)``, ``self.x[k] = v``,
  ``pop``/``extend``/``update``/``clear``/… count as WRITES to the
  attribute — the exact blind spot both shipped races hid in.
- **Thread-root inventory**: ``threading.Thread`` targets (methods and
  local functions, with multiplicity ``many`` when spawned in a loop —
  the wire per-connection handlers), ThreadingHTTPServer handler
  methods, and an ``external`` root for public methods of any
  lock-holding class (the lock is the declaration of concurrency — the
  RacerD ownership argument).  Only access pairs reachable from two
  distinct roots (or one ``many`` root) are race candidates.
- **Ownership / escape reasoning**: accesses in ``__init__`` and
  before the first ``Thread(...)`` construction in a spawning method
  are owned (init-before-``start()``); ``Event``/``Queue``/``Thread``
  attributes are synchronization primitives, and queue ``put``/``get``
  token handoffs (the ``_EtlBuffer`` ``(batch, token)`` shape) are
  happens-before edges, never races.
- **Guarded-by inference**: the majority lock over an attribute's
  guarded accesses becomes its inferred guard; only *deviations* fire,
  and every finding carries a TWO-SITE WITNESS (both access sites plus
  the call chain from each concurrent root; the second site rides into
  SARIF as ``relatedLocations``).

Attributes with NO guarded access are deliberately out of scope: the
plane's single-writer / GIL-atomic designs (``SpanFirehoseReceiver._out``
and friends) carry their own documented happens-before arguments, and a
lockset analysis has no evidence of intent to guard them.  RacerD makes
the same precision trade.

The rules themselves (RC001–RC004) live in ``rules_races``; this module
is the engine, memoized per :class:`Project` like the call graph.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    CallGraph, Project, SourceFile, call_name, in_loop,
)
from deeprest_tpu_torch.analysis.rules_threading import (
    _LOCK_FACTORIES, _SYNC_FACTORIES, _is_thread_ctor, _module_concurrent,
    _thread_target,
)

# wildcard lock: accesses in a `*_locked` method are guarded by whatever
# lock the caller holds — it matches any concrete inferred guard
LOCK_ANY = "*"

MANY = "many"          # root multiplicity: >1 concurrent instances

# container methods that MUTATE the receiver: a `self.x.append(...)` is
# a WRITE to self.x even though the attribute node is an ast.Load (the
# round-24 blind spot)
MUTATOR_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "add", "discard",
    "setdefault", "sort", "reverse", "rotate",
})

# queue-protocol methods are HAPPENS-BEFORE handoffs (the _EtlBuffer
# (batch, token) shape), not shared-state mutations — never writes
_HANDOFF_METHODS = frozenset({
    "put", "put_nowait", "get", "get_nowait", "task_done", "join",
})

# constructors whose result is a mutable container (RC004's escape-by-
# reference check needs to know the returned reference stays live)
_MUTABLE_CTORS = frozenset({
    "list", "dict", "set", "bytearray", "deque", "collections.deque",
    "defaultdict", "collections.defaultdict", "OrderedDict",
    "collections.OrderedDict", "Counter", "collections.Counter",
})


@dataclasses.dataclass
class LockAccess:
    """One ``self.<attr>`` access with the lockset held at that point."""

    attr: str
    write: bool
    mutation: bool       # write via container-mutating call / subscript
    locks: frozenset     # lexically held self-lock attrs (pre-summary)
    line: int
    col: int
    unit: str
    owned: bool = False  # init-before-start(): not yet shared


@dataclasses.dataclass
class SelfCall:
    name: str
    locks: frozenset
    line: int


@dataclasses.dataclass
class Section:
    """One ``with self.<lock>`` critical section (RC003's unit of
    atomicity): first read/write line per attribute inside it."""

    locks: frozenset
    line: int
    end: int
    reads: dict = dataclasses.field(default_factory=dict)
    writes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Escape:
    """``return self.<attr>`` executed with a lock held (RC004)."""

    attr: str
    line: int
    col: int
    locks: frozenset
    unit: str


@dataclasses.dataclass
class LockUnit:
    """One analyzed body: a method, or a thread-target local function
    (named ``method.localfn``, the ClassModel convention)."""

    name: str
    node: ast.AST
    accesses: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    sections: list = dataclasses.field(default_factory=list)
    escapes: list = dataclasses.field(default_factory=list)
    spawn_line: int | None = None     # first Thread(...) ctor line
    entry_locks: frozenset = frozenset()
    roots: dict = dataclasses.field(default_factory=dict)  # root -> chain


def _is_self_attr(node: ast.AST, self_name: str) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == self_name)


class _Scanner:
    """Per-function statement walk carrying the held-lock set."""

    def __init__(self, cls: "ClassLocks", unit: LockUnit, self_name: str,
                 skip_nodes: set[int]):
        self.cls = cls
        self.unit = unit
        self.self_name = self_name
        self.skip = skip_nodes          # thread-target local fns (ids)
        self.stack: list[Section] = []

    def scan(self, fn: ast.AST) -> None:
        if not self.self_name:
            return                      # staticmethod: no instance
        self._block(getattr(fn, "body", []), frozenset())

    # -- statement dispatch ------------------------------------------------

    def _block(self, stmts, held: frozenset) -> frozenset:
        for stmt in stmts:
            held = self._stmt(stmt, held)
        return held

    def _stmt(self, stmt: ast.stmt, held: frozenset) -> frozenset:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            locks = set()
            for item in stmt.items:
                self._note(item.context_expr, held)
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    locks.add(lock)
            inner = held | frozenset(locks)
            if locks:
                section = Section(locks=frozenset(locks), line=stmt.lineno,
                                  end=getattr(stmt, "end_lineno",
                                              stmt.lineno))
                self.stack.append(section)
                self.unit.sections.append(section)
                self._block(stmt.body, inner)
                self.stack.pop()
            else:
                self._block(stmt.body, inner)
            return held
        if isinstance(stmt, ast.Try):
            held = self._block(stmt.body, held)
            for h in stmt.handlers:
                self._block(h.body, held)
            self._block(stmt.orelse, held)
            self._block(stmt.finalbody, held)
            # `acquire(); try: ... finally: release()` — the release in
            # the finally ends the hold for everything after the Try
            return held - self._released_in(stmt.finalbody)
        if isinstance(stmt, ast.If):
            self._note(stmt.test, held)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return held
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._note(stmt.target, held)
            self._note(stmt.iter, held)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return held
        if isinstance(stmt, ast.While):
            self._note(stmt.test, held)
            self._block(stmt.body, held)
            self._block(stmt.orelse, held)
            return held
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if id(stmt) not in self.skip:
                # non-thread-target local fn: folds into the unit with
                # the lexical lockset (ClassModel parity)
                self._block(stmt.body, held)
            return held
        if isinstance(stmt, ast.ClassDef):
            return held
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._note(stmt.value, held)
                if (held and _is_self_attr(stmt.value, self.self_name)
                        and stmt.value.attr in self.cls.mutable_attrs):
                    self.unit.escapes.append(Escape(
                        attr=stmt.value.attr, line=stmt.lineno,
                        col=stmt.col_offset, locks=held,
                        unit=self.unit.name))
            return held
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            op = self._acquire_release(stmt.value)
            if op is not None:
                kind, lock = op
                return (held | {lock}) if kind == "acquire" else \
                    held - {lock}
        self._note(stmt, held)
        return held

    # -- helpers -----------------------------------------------------------

    def _lock_of(self, expr: ast.AST) -> str | None:
        """``self.<lock>`` (or a call on it) in a with-item."""
        if isinstance(expr, ast.Call):
            expr = expr.func
        if _is_self_attr(expr, self.self_name) \
                and expr.attr in self.cls.lock_attrs:
            return self.cls.canon(expr.attr)
        return None

    def _acquire_release(self, call: ast.Call) -> tuple[str, str] | None:
        fn = call.func
        if (isinstance(fn, ast.Attribute)
                and fn.attr in ("acquire", "release")
                and _is_self_attr(fn.value, self.self_name)
                and fn.value.attr in self.cls.lock_attrs):
            return fn.attr, self.cls.canon(fn.value.attr)
        return None

    def _released_in(self, stmts) -> frozenset:
        out = set()
        for stmt in stmts:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    op = self._acquire_release(n)
                    if op is not None and op[0] == "release":
                        out.add(op[1])
        return frozenset(out)

    def _note(self, node: ast.AST, held: frozenset) -> None:
        """Record every self-attribute access / self-call / Thread ctor
        inside ``node`` (an expression or leaf statement)."""
        parents = self.cls.sf.parents()
        for sub in ast.walk(node):
            if _is_self_attr(sub, self.self_name):
                self._note_attr(sub, held, parents)
            elif isinstance(sub, ast.Call):
                name = call_name(sub.func)
                if name and name.startswith(self.self_name + "."):
                    rest = name[len(self.self_name) + 1:]
                    if "." not in rest:
                        self.unit.calls.append(SelfCall(
                            name=rest, locks=held, line=sub.lineno))
                if _is_thread_ctor(sub):
                    if self.unit.spawn_line is None \
                            or sub.lineno < self.unit.spawn_line:
                        self.unit.spawn_line = sub.lineno

    def _note_attr(self, node: ast.Attribute, held: frozenset,
                   parents) -> None:
        attr = node.attr
        if attr in self.cls.lock_attrs or attr in self.cls.sync_attrs \
                or attr in self.cls.method_names:
            return
        write = isinstance(node.ctx, (ast.Store, ast.Del))
        mutation = False
        also_read = False
        parent = parents.get(node)
        if not write and parent is not None:
            if isinstance(parent, ast.Attribute):
                if parent.attr in MUTATOR_METHODS:
                    write = mutation = True
                elif parent.attr in _HANDOFF_METHODS:
                    return            # queue handoff: happens-before edge
            elif (isinstance(parent, ast.Subscript)
                    and parent.value is node
                    and isinstance(parent.ctx, (ast.Store, ast.Del))):
                write = mutation = True
        if write and not mutation and parent is not None \
                and isinstance(parent, ast.AugAssign):
            also_read = True          # x += 1 reads AND writes atomically
        acc = LockAccess(attr=attr, write=write, mutation=mutation,
                         locks=held, line=node.lineno,
                         col=node.col_offset, unit=self.unit.name)
        self.unit.accesses.append(acc)
        for section in self.stack:
            if write:
                section.writes.setdefault(attr, node.lineno)
                if also_read:
                    section.reads.setdefault(attr, node.lineno)
            else:
                section.reads.setdefault(attr, node.lineno)


class ClassLocks:
    """Lockset model of one class: units with per-access locksets,
    function lock summaries, the thread-root inventory, and the
    guarded-by inference the RC rules consume."""

    def __init__(self, sf: SourceFile, node: ast.ClassDef,
                 module_concurrent: bool, graph: CallGraph):
        self.sf = sf
        self.node = node
        self.name = node.name
        self.module_concurrent = module_concurrent
        self.lock_attrs: set[str] = set()
        self.lock_alias: dict[str, str] = {}
        self.sync_attrs: set[str] = set()
        self.mutable_attrs: set[str] = set()
        self.units: dict[str, LockUnit] = {}
        self.roots: dict[str, str] = {}      # root id -> multiplicity
        methods = [n for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self.method_names = {m.name for m in methods}
        self._classify_attrs(methods)
        self._scan_units(methods)
        self._build_roots(methods)
        self._summarize_entry_locks()

    # -- construction ------------------------------------------------------

    def _classify_attrs(self, methods) -> None:
        for m in methods:
            for n in ast.walk(m):
                if not (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)):
                    continue
                ctor = call_name(n.value.func)
                for t in n.targets:
                    if not _is_self_attr(t, _self_name(m)):
                        continue
                    if ctor in _LOCK_FACTORIES:
                        self.lock_attrs.add(t.attr)
                        # Condition(self._lock) WRAPS an existing lock:
                        # `with self._cv` and `with self._lock` take the
                        # same underlying mutex, so the two names must
                        # unify or RC002 reports a split guard that
                        # serializes perfectly well (EngineReplica's
                        # _cv/_lock pair)
                        if (ctor.endswith("Condition")
                                and n.value.args
                                and _is_self_attr(n.value.args[0],
                                                  _self_name(m))):
                            self.lock_alias[t.attr] = n.value.args[0].attr
                    elif ctor in _SYNC_FACTORIES:
                        self.sync_attrs.add(t.attr)
                    elif ctor in _MUTABLE_CTORS:
                        self.mutable_attrs.add(t.attr)
            # container literals: self.x = [] / {} / set-literal
            for n in ast.walk(m):
                if isinstance(n, ast.Assign) and isinstance(
                        n.value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                                  ast.DictComp, ast.SetComp)):
                    for t in n.targets:
                        if _is_self_attr(t, _self_name(m)):
                            self.mutable_attrs.add(t.attr)

    def _scan_units(self, methods) -> None:
        for m in methods:
            self_name = _self_name(m)
            local_fns = _local_thread_targets(m)
            unit = LockUnit(name=m.name, node=m)
            self.units[m.name] = unit
            scanner = _Scanner(self, unit, self_name,
                               {id(fn) for fn in local_fns.values()})
            scanner.scan(m)
            for fn_name, fn_node in local_fns.items():
                sub = LockUnit(name=f"{m.name}.{fn_name}", node=fn_node)
                self.units[sub.name] = sub
                _Scanner(self, sub, self_name, set()).scan(fn_node)

    def _build_roots(self, methods) -> None:
        entries: dict[str, set[str]] = {}    # root id -> entry units
        for m in methods:
            self_name = _self_name(m)
            for n in ast.walk(m):
                if not (isinstance(n, ast.Call) and _is_thread_ctor(n)):
                    continue
                mult = MANY if in_loop(self.sf, n) else "1"
                tgt = _thread_target(n)
                if (_is_self_attr(tgt, self_name)
                        and tgt.attr in self.method_names):
                    rid = f"thread {tgt.attr}()"
                    self.roots[rid] = MANY if (
                        self.roots.get(rid) == MANY or mult == MANY) \
                        else mult
                    entries.setdefault(rid, set()).add(tgt.attr)
                elif isinstance(tgt, ast.Name):
                    sub = f"{m.name}.{tgt.id}"
                    if sub in self.units:
                        rid = f"thread {sub}()"
                        self.roots[rid] = MANY if (
                            self.roots.get(rid) == MANY or mult == MANY) \
                            else mult
                        entries.setdefault(rid, set()).add(sub)
        if self.module_concurrent:
            rid = "HTTP handler thread"
            self.roots[rid] = MANY
            entries[rid] = set(self.units) - {"__init__"}
        if self.lock_attrs or self.roots:
            # the lock (or the spawned thread) is the declaration of
            # concurrency: public methods — and private methods nobody
            # in the class calls — run on whatever thread the caller is
            called_here = {c.name for u in self.units.values()
                           for c in u.calls}
            rid = "external caller"
            ext = {name for name in self.units
                   if name != "__init__"
                   and (not name.startswith("_")
                        or ("." not in name and name not in called_here
                            and not any(name in e for e in
                                        entries.values())))}
            if ext:
                self.roots[rid] = MANY
                entries[rid] = ext
        # closure with chains: BFS over in-class call edges
        edges: dict[str, set[str]] = {
            name: {c.name for c in u.calls if c.name in self.units}
            for name, u in self.units.items()}
        for rid, seeds in entries.items():
            frontier = [(s, s + "()") for s in sorted(seeds)]
            seen = set()
            while frontier:
                name, chain = frontier.pop(0)
                if name in seen:
                    continue
                seen.add(name)
                u = self.units.get(name)
                if u is None:
                    continue
                u.roots.setdefault(rid, chain)
                for callee in sorted(edges.get(name, ())):
                    if callee not in seen and callee != "__init__":
                        frontier.append((callee, f"{chain} → {callee}()"))

    def _summarize_entry_locks(self) -> None:
        """Compositional summary: a unit reachable ONLY from call sites
        that hold lock L runs with L held — intersection over in-class
        call sites, iterated to fixpoint (monotone decreasing)."""
        sites: dict[str, list[tuple[str, frozenset]]] = {}
        for name, u in self.units.items():
            for c in u.calls:
                if c.name in self.units:
                    sites.setdefault(c.name, []).append((name, c.locks))
        top = frozenset(self.canon(l) for l in self.lock_attrs) | {LOCK_ANY}
        for name, u in self.units.items():
            if name.endswith("_locked"):
                u.entry_locks = frozenset({LOCK_ANY})
            elif u.roots or name == "__init__" or name not in sites:
                u.entry_locks = frozenset()
            else:
                u.entry_locks = top
        for _ in range(len(self.units) + 1):
            changed = False
            for name, u in self.units.items():
                if u.roots or name == "__init__" or name not in sites \
                        or name.endswith("_locked"):
                    continue
                new = None
                for caller, locks in sites[name]:
                    cu = self.units.get(caller)
                    eff = locks | (cu.entry_locks if cu else frozenset())
                    new = eff if new is None else (new & eff)
                new = new if new is not None else frozenset()
                if new != u.entry_locks:
                    u.entry_locks = new
                    changed = True
            if not changed:
                break

    # -- queries -----------------------------------------------------------

    def canon(self, lock: str) -> str:
        """Canonical lock name: a Condition constructed over an existing
        lock attribute aliases it (chains resolve to the root)."""
        seen = set()
        while lock in self.lock_alias and lock not in seen:
            seen.add(lock)
            lock = self.lock_alias[lock]
        return lock

    def effective_locks(self, acc: LockAccess) -> frozenset:
        unit = self.units.get(acc.unit)
        extra = unit.entry_locks if unit is not None else frozenset()
        return acc.locks | extra

    def shared_accesses(self, attr: str) -> list[LockAccess]:
        """Every access to ``attr`` outside ownership windows: __init__
        is owned, and so is anything before the first Thread ctor in a
        spawning method (init-before-start())."""
        out = []
        for name, u in self.units.items():
            if name == "__init__":
                continue
            for a in u.accesses:
                if a.attr != attr:
                    continue
                if u.spawn_line is not None and a.line < u.spawn_line:
                    continue
                out.append(a)
        return out

    def state_attrs(self) -> list[str]:
        return sorted({a.attr for u in self.units.values()
                       for a in u.accesses})

    def concurrent_pair(self, u1: str, u2: str
                        ) -> tuple[str, str] | None:
        """``(chain1, chain2)`` when the two units can interleave: two
        distinct roots reach them, or one shared root of multiplicity
        ``many`` (handler threads, per-connection spawns, external
        callers)."""
        a = self.units.get(u1)
        b = self.units.get(u2)
        if a is None or b is None or not a.roots or not b.roots:
            return None
        for r1, c1 in sorted(a.roots.items()):
            for r2, c2 in sorted(b.roots.items()):
                if r1 != r2:
                    return (f"{r1}: {c1}", f"{r2}: {c2}")
        for rid in sorted(set(a.roots) & set(b.roots)):
            if self.roots.get(rid) == MANY:
                return (f"{rid}: {a.roots[rid]}",
                        f"{rid} (a second one): {b.roots[rid]}")
        return None

    def inferred_guard(self, accesses: list[LockAccess]
                       ) -> tuple[str | None, int, int]:
        """Majority concrete lock over the guarded accesses:
        ``(lock, covered, total)``."""
        counts: dict[str, int] = {}
        for a in accesses:
            for lock in self.effective_locks(a):
                if lock != LOCK_ANY:
                    counts[lock] = counts.get(lock, 0) + 1
        if not counts:
            return None, 0, len(accesses)
        guard = max(sorted(counts), key=lambda k: counts[k])
        return guard, counts[guard], len(accesses)


def _self_name(method: ast.AST) -> str:
    if any(isinstance(d, ast.Name) and d.id == "staticmethod"
           for d in getattr(method, "decorator_list", [])):
        return ""
    args = getattr(method, "args", None)
    if args is not None and args.args:
        return args.args[0].arg
    return "self"


def _local_thread_targets(method: ast.AST) -> dict[str, ast.AST]:
    local_defs = {n.name: n for n in ast.walk(method)
                  if isinstance(n, ast.FunctionDef) and n is not method}
    out = {}
    for n in ast.walk(method):
        if isinstance(n, ast.Call) and _is_thread_ctor(n):
            tgt = _thread_target(n)
            if isinstance(tgt, ast.Name) and tgt.id in local_defs:
                out[tgt.id] = local_defs[tgt.id]
    return out


def _class_is_interesting(node: ast.ClassDef) -> bool:
    """Cheap pre-filter: a class with no lock attr and no thread spawn
    has nothing for a lockset analysis to say."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            name = call_name(n.func)
            if name in _LOCK_FACTORIES or _is_thread_ctor(n):
                return True
    return False


_TH_OWNER_RE = re.compile(r"^(\w+)\.(\w+) is ")


class LocksetAnalysis:
    """Project-wide lockset models + the TH-ownership ledger, built
    once per Project (the call-graph memoization pattern)."""

    @classmethod
    def of(cls, project: Project) -> "LocksetAnalysis":
        cached = project.__dict__.get("_lockset_analysis")
        if cached is None:
            cached = project.__dict__["_lockset_analysis"] = cls(project)
        return cached

    def __init__(self, project: Project):
        self.project = project
        graph = project.call_graph()
        self.classes: list[ClassLocks] = []
        for sf in project.files:
            if sf.tree is None:
                continue
            mc = _module_concurrent(sf)
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef) and (
                        mc or _class_is_interesting(node)):
                    self.classes.append(ClassLocks(sf, node, mc, graph))
        self.th_owned = self._th_ownership(project)

    @staticmethod
    def _th_ownership(project: Project) -> set[tuple[str, str, str]]:
        """(path, class, attr) triples TH001/TH004 already report —
        one owner per site, so RC rules never double-report them."""
        from deeprest_tpu_torch.analysis.rules_threading import (
            TH001AttributeRace, TH004LockDiscipline,
        )

        owned = set()
        for rule in (TH001AttributeRace(), TH004LockDiscipline()):
            for f in rule.run(project):
                m = _TH_OWNER_RE.match(f.message)
                if m is not None:
                    owned.add((f.path, m.group(1), m.group(2)))
        return owned

    def owned_by_th(self, cls: ClassLocks, attr: str) -> bool:
        return (cls.sf.rel, cls.name, attr) in self.th_owned

    def iter_classes(self) -> Iterator[ClassLocks]:
        return iter(self.classes)


__all__ = [
    "LOCK_ANY", "MANY", "MUTATOR_METHODS", "ClassLocks", "Escape",
    "LockAccess", "LockUnit", "LocksetAnalysis", "Section",
]
