"""Rule pack TH: threading invariants for the serving/streaming layers.

The repo's concurrency surface is small but load-bearing: the HTTP
service's handler threads (ThreadingHTTPServer — one thread per
request), the MicroBatcher worker, the checkpoint-reload loader, the
streaming ETL thread, and the loadgen user workers.  The native
featurizer gets ``-fsanitize=thread`` (native/Makefile); this pack is
the Python side's equivalent, as static analysis:

- TH001 — data races on ``self.*``: a mutable attribute written by
  thread-reachable code and accessed elsewhere without the class's
  lock/condition held.  Thread-reachable code is found three ways:
  ``threading.Thread(target=self.method)``, ``threading.Thread`` over a
  local function defined in a method (the streaming ETL loop), and —
  because ThreadingHTTPServer dispatches every request on its own
  thread — ALL methods of every class in a module that uses
  ThreadingHTTPServer.  TH001 also flags objects captured by a
  thread-target closure and still used by the spawning function after
  the thread starts, when the object's class shows no internal
  synchronization (the shared-tailer pattern).
- TH002 — lock-ordering cycles over the project-wide lock-acquisition
  graph (lock held while acquiring another, including through calls
  into other classes resolved via ``__init__`` annotations and
  same-module construction).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    CallGraph, Finding, Project, Rule, SourceFile, call_name, register,
    transitive_closure,
)

_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}
_SYNC_FACTORIES = _LOCK_FACTORIES | {
    "threading.Event", "threading.Semaphore", "threading.Barrier",
    "threading.Thread", "Event", "Semaphore", "Barrier", "Thread",
    "queue.Queue", "Queue",
}


def _is_thread_ctor(call: ast.Call) -> bool:
    return call_name(call.func) in ("threading.Thread", "Thread")


def _thread_target(call: ast.Call) -> ast.AST | None:
    for kw in call.keywords:
        if kw.arg == "target":
            return kw.value
    if call.args:
        return call.args[0]
    return None


@dataclasses.dataclass
class Access:
    attr: str
    write: bool
    locked: bool
    line: int
    col: int
    unit: str          # method name (or "method.localfn" for local funcs)


@dataclasses.dataclass
class Unit:
    """One analyzed code body: a method, or a thread-target local
    function inside a method."""

    name: str
    node: ast.AST
    accesses: list[Access] = dataclasses.field(default_factory=list)
    self_calls: set[str] = dataclasses.field(default_factory=set)
    thread_entry: bool = False


class ClassModel:
    @classmethod
    def of(cls, sf: SourceFile, node: ast.ClassDef,
           module_concurrent: bool,
           graph: CallGraph | None = None) -> "ClassModel":
        """Memoized constructor: TH001/TH002/TH004 each model the same
        classes, and _build's per-method walks dominated the lint
        self-check's 10s tier-1 budget.  The cache lives on the
        SourceFile (one lint run's lifetime), keyed by everything
        _build reads."""
        cache = sf.__dict__.setdefault("_class_models", {})
        key = (id(node), module_concurrent, graph is not None)
        model = cache.get(key)
        if model is None:
            model = cache[key] = cls(sf, node, module_concurrent,
                                     graph=graph)
        return model

    def __init__(self, sf: SourceFile, node: ast.ClassDef,
                 module_concurrent: bool,
                 graph: CallGraph | None = None):
        self.sf = sf
        self.node = node
        self.name = node.name
        self.lock_attrs: set[str] = set()
        self.units: dict[str, Unit] = {}
        self.init_written: set[str] = set()
        self.written_outside_init: set[str] = set()
        self.module_concurrent = module_concurrent
        self._graph = graph
        self._build()

    def method_edges(self) -> dict[str, set[str]]:
        """method → same-class methods it calls: resolved on the shared
        project call graph when one is supplied, else from the units'
        collected self-calls (direct constructions by TH002/TH004 that
        never propagate thread entries)."""
        if self._graph is not None:
            return self._graph.class_method_edges(self.sf.rel, self.name)
        return {name: set(u.self_calls)
                for name, u in self.units.items() if "." not in name}

    # -- construction ----------------------------------------------------

    def _build(self) -> None:
        methods = [n for n in self.node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        # pass 1: lock attributes (anywhere, usually __init__)
        for m in methods:
            for n in ast.walk(m):
                if (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)
                        and call_name(n.value.func) in _LOCK_FACTORIES):
                    for t in n.targets:
                        if (isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            self.lock_attrs.add(t.attr)
        # pass 2: create every method unit, then scan (a Thread ctor in
        # __init__ may target a method defined later in the class body)
        for m in methods:
            unit = Unit(name=m.name, node=m)
            unit.thread_entry = self.module_concurrent
            self.units[m.name] = unit
        method_names = {m.name for m in methods}
        for m in methods:
            # a staticmethod's first arg is NOT the instance — scanning it
            # as "self" fabricates attribute accesses (the ReplicaRouter
            # _probe_meta false positive)
            if any(isinstance(d, ast.Name) and d.id == "staticmethod"
                   for d in m.decorator_list):
                self_name = ""
            else:
                self_name = (m.args.args[0].arg if m.args.args else "self")
            unit = self.units[m.name]
            local_thread_fns = self._local_thread_targets(m)
            self._scan_body(m, unit, self_name,
                            skip_local_fns=set(local_thread_fns.values()))
            for fn_name, fn_node in local_thread_fns.items():
                sub = Unit(name=f"{m.name}.{fn_name}", node=fn_node,
                           thread_entry=True)
                self.units[sub.name] = sub
                self._scan_body(fn_node, sub, self_name, skip_local_fns=set())
            # threading.Thread(target=self.M) marks M a thread entry
            for n in ast.walk(m):
                if isinstance(n, ast.Call) and _is_thread_ctor(n):
                    tgt = _thread_target(n)
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == self_name
                            and tgt.attr in method_names):
                        self.units[tgt.attr].thread_entry = True
        # transitive: self.M() calls from thread-entry units.  The edge
        # map and closure are the shared project call graph's (this pack
        # carried its own while-changed walk until the graph existed);
        # thread-target LOCAL functions are not graph nodes, so their
        # collected self-calls seed the closure directly.
        seeds = {u.name for u in self.units.values()
                 if u.thread_entry and "." not in u.name}
        for u in self.units.values():
            if u.thread_entry and "." in u.name:
                seeds |= u.self_calls
        for name in transitive_closure(self.method_edges(), seeds):
            cu = self.units.get(name)
            if cu is not None:
                cu.thread_entry = True
        for u in self.units.values():
            for a in u.accesses:
                if a.write:
                    if u.name == "__init__":
                        self.init_written.add(a.attr)
                    else:
                        self.written_outside_init.add(a.attr)

    @staticmethod
    def _local_thread_targets(method: ast.AST) -> dict[str, ast.AST]:
        """Local ``def`` nodes of this method that are handed to
        ``threading.Thread(target=...)`` by name."""
        local_defs = {n.name: n for n in ast.walk(method)
                      if isinstance(n, ast.FunctionDef) and n is not method}
        out = {}
        for n in ast.walk(method):
            if isinstance(n, ast.Call) and _is_thread_ctor(n):
                tgt = _thread_target(n)
                if isinstance(tgt, ast.Name) and tgt.id in local_defs:
                    out[tgt.id] = local_defs[tgt.id]
        return out

    def _scan_body(self, fn: ast.AST, unit: Unit, self_name: str,
                   skip_local_fns: set[ast.AST]) -> None:
        """Collect self.* accesses + self-method calls, tracking which
        are lexically under ``with self.<lock>``.  Nested local
        functions fold into the unit (they run on the same thread unless
        they are thread targets, which are scanned separately); nested
        classes are skipped entirely."""

        def is_self_lock(expr: ast.AST) -> bool:
            return (isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == self_name
                    and expr.attr in self.lock_attrs)

        def visit(node: ast.AST, locked: bool) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    continue
                if child in skip_local_fns:
                    continue
                if isinstance(child, ast.With):
                    child_locked = locked or any(
                        is_self_lock(i.context_expr)
                        or (isinstance(i.context_expr, ast.Call)
                            and is_self_lock(i.context_expr.func))
                        for i in child.items)
                    for i in child.items:
                        visit(i, locked)
                    for stmt in child.body:
                        visit(stmt, child_locked)
                        self._note(stmt, unit, self_name, child_locked)
                    continue
                self._note(child, unit, self_name, locked)
                visit(child, locked)

        self._note(fn, unit, self_name, False)
        visit(fn, False)

    def _note(self, node: ast.AST, unit: Unit, self_name: str,
              locked: bool) -> None:
        """Record ``node`` itself if it is a self-attribute access or a
        self-method call (children are handled by the visit walk)."""
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == self_name):
            if node.attr in self.lock_attrs:
                return
            unit.accesses.append(Access(
                attr=node.attr,
                write=isinstance(node.ctx, (ast.Store, ast.Del)),
                locked=locked, line=node.lineno, col=node.col_offset,
                unit=unit.name))
        if isinstance(node, ast.Call):
            name = call_name(node.func)
            if name and name.startswith(self_name + "."):
                rest = name[len(self_name) + 1:]
                if "." not in rest:
                    unit.self_calls.add(rest)

    # -- race detection --------------------------------------------------

    def races(self) -> Iterator[Finding]:
        if not any(u.thread_entry for u in self.units.values()):
            return
        methods = {n.name for n in self.node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for attr in sorted(self.written_outside_init):
            if attr in methods:
                continue                      # bound methods, not state
            accesses = [a for u in self.units.values() for a in u.accesses
                        if a.attr == attr and u.name != "__init__"]
            writes = [a for a in accesses if a.write]
            if not writes or len(accesses) < 2:
                continue
            # a pair (write, other access) races when at least one side
            # runs on a spawned/handler thread, the two can run
            # concurrently, and they are not both under the class lock
            hit = None
            for w in writes:
                w_thr = self.units[w.unit].thread_entry
                for a in accesses:
                    if a is w:
                        continue
                    a_thr = self.units[a.unit].thread_entry
                    if not (w_thr or a_thr):
                        continue
                    same_unit = a.unit == w.unit
                    if same_unit and not self.module_concurrent:
                        continue              # one thread runs the unit
                    if w.locked and a.locked:
                        continue
                    hit = (w, a)
                    break
                if hit:
                    break
            if hit is None:
                continue
            w, a = hit
            lock_hint = (f"hold self.{sorted(self.lock_attrs)[0]}"
                         if self.lock_attrs
                         else "add a threading.Lock to the class and hold "
                              "it")
            yield self.sf.finding(
                w.line if isinstance(w.line, int) else 1, "TH001",
                f"{self.name}.{attr} is written in {w.unit}() "
                f"({'thread' if self.units[w.unit].thread_entry else 'main'}"
                f"-side, {'locked' if w.locked else 'no lock'}) and "
                f"accessed in {a.unit}() line {a.line} "
                f"({'locked' if a.locked else 'no lock'}) — a data race "
                f"between the class's threads; {lock_hint} around every "
                "access")


_THREADED_SERVER_NAMES = ("ThreadingHTTPServer", "ThreadingMixIn",
                          "http.server.ThreadingHTTPServer",
                          "socketserver.ThreadingMixIn")


def _module_concurrent(sf: SourceFile) -> bool:
    """ThreadingHTTPServer modules run every handler on its own thread:
    any class the handlers reach is concurrently accessed."""
    if sf.tree is None:
        return False
    for node in sf.walk():
        if isinstance(node, (ast.Name, ast.Attribute)):
            if call_name(node) in _THREADED_SERVER_NAMES:
                return True
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                if alias.name.split(".")[-1] in ("ThreadingHTTPServer",
                                                 "ThreadingMixIn"):
                    return True
    return False


@register
class TH001AttributeRace(Rule):
    id = "TH001"
    title = ("mutable shared state written by thread-reachable code and "
             "accessed elsewhere without the class's lock held")
    guards = ("the /healthz reload counter and backend swap in "
              "serve/server.py raced handler threads against "
              "maybe_reload(), and the streaming trainer read the "
              "tailer's counters across the ETL thread boundary — both "
              "found and fixed by this rule's first run")

    def run(self, project: Project) -> Iterator[Finding]:
        graph = project.call_graph()
        for sf in project.files:
            if sf.tree is None:
                continue
            concurrent = _module_concurrent(sf)
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef):
                    model = ClassModel.of(sf, node, concurrent, graph=graph)
                    yield from model.races()
                    yield from self._shared_captures(sf, model)

    # -- shared-capture sub-check (the ETL-tailer pattern) ---------------

    def _shared_captures(self, sf: SourceFile,
                         model: ClassModel) -> Iterator[Finding]:
        for m in model.node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            local_fns = ClassModel._local_thread_targets(m)
            if not local_fns:
                continue
            spawn_line = min(
                n.lineno for n in ast.walk(m)
                if isinstance(n, ast.Call) and _is_thread_ctor(n))
            synced, classes = self._local_types(sf, m)
            for fn_name, fn_node in local_fns.items():
                captured = self._captured_names(m, fn_node)
                for name in sorted(captured):
                    if name in synced:
                        continue
                    later = self._uses_after(m, name, spawn_line,
                                             exclude=fn_node)
                    if later is None:
                        continue
                    cls_hint = classes.get(name)
                    if cls_hint is not None and cls_hint.lock_attrs:
                        continue          # internally synchronized class
                    yield sf.finding(
                        later, "TH001",
                        f"{name!r} is captured by thread target "
                        f"{fn_name}() (started line {spawn_line}) and "
                        f"still used by {model.name}.{m.name}() after "
                        "the thread starts, with no internal "
                        "synchronization visible on its class — route "
                        "the shared values through a lock-protected "
                        "handoff instead")

    def _local_types(self, sf: SourceFile, m: ast.AST):
        """(names bound to sync primitives, {name: ClassModel-of-local
        construction}) for the method's locals."""
        synced: set[str] = set()
        classes: dict[str, ClassModel] = {}
        module_classes = {n.name: n for n in sf.tree.body
                          if isinstance(n, ast.ClassDef)}
        for n in ast.walk(m):
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and isinstance(n.value, ast.Call)):
                continue
            tgt = n.targets[0].id
            ctor = call_name(n.value.func)
            if ctor in _SYNC_FACTORIES:
                synced.add(tgt)
            elif ctor in module_classes:
                classes[tgt] = ClassModel.of(sf, module_classes[ctor], False)
        return synced, classes

    @staticmethod
    def _captured_names(method: ast.AST, fn_node: ast.AST) -> set[str]:
        from deeprest_tpu_torch.analysis.core import scope_bound_names

        method_bound = scope_bound_names(method)
        fn_bound = scope_bound_names(fn_node)
        self_name = (method.args.args[0].arg if method.args.args else "self")
        out = set()
        for n in ast.walk(fn_node):
            if (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                    and n.id != self_name
                    and n.id not in fn_bound and n.id in method_bound):
                out.add(n.id)
        return out

    @staticmethod
    def _uses_after(method: ast.AST, name: str, spawn_line: int,
                    exclude: ast.AST) -> int | None:
        excluded = set()
        for n in ast.walk(exclude):
            excluded.add(id(n))
        for n in ast.walk(method):
            if id(n) in excluded:
                continue
            if (isinstance(n, ast.Name) and n.id == name
                    and n.lineno > spawn_line):
                return n.lineno
        return None


# -- TH003: state mutated across a multiprocessing boundary ----------------


def _is_process_ctor(call: ast.Call) -> bool:
    name = call_name(call.func)
    return name == "Process" or bool(name and name.endswith(".Process"))


@register
class TH003CrossProcessState(Rule):
    id = "TH003"
    title = ("self.* state mutated inside a multiprocessing child is "
             "invisible to the parent process")
    guards = ("the replica plane runs worker subprocesses "
              "(serve/replica.ProcessReplica); a counter updated via "
              "self.* in the child lives in the child's copy of the "
              "object — the router's scheduler would read frozen parent "
              "state forever.  Share through the Pipe/Queue/Value the "
              "worker protocol already carries")

    def run(self, project: Project) -> Iterator[Finding]:
        graph = project.call_graph()
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef):
                    yield from self._check(sf, node, graph)

    def _check(self, sf: SourceFile, cnode: ast.ClassDef,
               graph: CallGraph) -> Iterator[Finding]:
        model = ClassModel.of(sf, cnode, False, graph=graph)
        methods = [n for n in cnode.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        method_names = {m.name for m in methods}
        # methods handed to a Process ctor as target=self.<m>
        child_entries: set[str] = set()
        for m in methods:
            self_name = (m.args.args[0].arg if m.args.args else "self")
            for n in ast.walk(m):
                if isinstance(n, ast.Call) and _is_process_ctor(n):
                    tgt = _thread_target(n)
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == self_name
                            and tgt.attr in method_names):
                        child_entries.add(tgt.attr)
        if not child_entries:
            return
        # transitive: self.M() calls from child-side units stay
        # child-side — the same shared-call-graph closure TH001 uses
        child_units = {name for name in transitive_closure(
            model.method_edges(), child_entries) if name in method_names}
        for uname in sorted(child_units):
            u = model.units.get(uname)
            if u is None:
                continue
            for acc in u.accesses:
                if not acc.write:
                    continue
                readers = [
                    a for other, ou in model.units.items()
                    if other not in child_units and other != "__init__"
                    for a in ou.accesses if a.attr == acc.attr
                ]
                if not readers:
                    continue
                r = readers[0]
                yield sf.finding(
                    acc.line, "TH003",
                    f"{cnode.name}.{acc.attr} is written in {uname}() — a "
                    f"multiprocessing child entry — and read parent-side "
                    f"in {r.unit}() line {r.line}; the child mutates its "
                    "OWN copy of the object, so the parent never observes "
                    "this write.  Route it through the process boundary "
                    "explicitly (Pipe/Queue/Value/shared memory)")
                break          # one finding per child-written attribute


# -- TH004: inconsistent lock discipline ------------------------------------


@register
class TH004LockDiscipline(Rule):
    id = "TH004"
    title = ("attribute guarded by the class's lock on one side but "
             "written or read without it elsewhere")
    guards = ("the routing front's shared surfaces (replica registry, "
              "admission counters, autoscaler sample ring) are called "
              "from HTTP handler threads in OTHER modules, where TH001's "
              "thread-entry proof cannot see; mixing one unguarded "
              "access into an otherwise lock-guarded attribute "
              "re-introduces exactly the races TH001 exists to stop")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef):
                    yield from self._check(sf, node)

    def _check(self, sf: SourceFile,
               cnode: ast.ClassDef) -> Iterator[Finding]:
        model = ClassModel.of(sf, cnode, False)
        if not model.lock_attrs:
            return
        method_names = {n.name for n in cnode.body
                        if isinstance(n, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        for attr in sorted(model.written_outside_init):
            if attr in method_names:
                continue                   # bound methods, not state
            # convention: a *_locked method is called with the class lock
            # already held — its accesses count as guarded
            accesses = [a for u in model.units.values() for a in u.accesses
                        if a.attr == attr and u.name != "__init__"]
            locked = [a for a in accesses
                      if a.locked or a.unit.endswith("_locked")]
            unlocked = [a for a in accesses
                        if not (a.locked or a.unit.endswith("_locked"))]
            if not locked or not unlocked:
                continue                   # consistent either way
            # inconsistent AND write-involved: an unguarded write against
            # any guarded access, or an unguarded read of a
            # guarded-written attribute
            bad = next((a for a in unlocked if a.write), None)
            if bad is None and any(a.write for a in locked):
                bad = unlocked[0]
            if bad is None:
                continue
            witness = locked[0]
            yield sf.finding(
                bad.line, "TH004",
                f"{cnode.name}.{attr} is "
                f"{'written' if bad.write else 'read'} in {bad.unit}() "
                f"without the class lock, but {witness.unit}() line "
                f"{witness.line} guards the same attribute with "
                f"self.{sorted(model.lock_attrs)[0]} — one unguarded "
                "access defeats the lock; hold it on every access")


# -- TH002: lock-ordering cycles -------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockId:
    module: str
    cls: str
    attr: str

    def __str__(self) -> str:
        return f"{self.module}:{self.cls}.{self.attr}"


@register
class TH002LockOrderCycle(Rule):
    id = "TH002"
    title = "lock-acquisition ordering cycle across the project"
    guards = ("the serving layer holds per-object locks (service state, "
              "MicroBatcher condition, ShapeLadder/fused counters); an "
              "AB-BA ordering between any two deadlocks the whole "
              "request path under load")

    _MAX_DEPTH = 6

    def run(self, project: Project) -> Iterator[Finding]:
        classes: dict[str, tuple[SourceFile, ast.ClassDef]] = {}
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef):
                    classes.setdefault(node.name, (sf, node))
        lock_attrs: dict[str, set[str]] = {}
        attr_types: dict[str, dict[str, str]] = {}
        for cname, (sf, node) in classes.items():
            locks, types = self._class_info(node)
            lock_attrs[cname] = locks
            attr_types[cname] = types

        edges: dict[tuple[LockId, LockId], tuple[str, int]] = {}

        def lock_of(cname: str, attr: str, sf: SourceFile) -> LockId | None:
            if attr in lock_attrs.get(cname, ()):
                return LockId(sf.rel, cname, attr)
            return None

        def acquisitions(cname: str, method: str, depth: int,
                         held: tuple[LockId, ...],
                         seen: set[tuple[str, str]]) -> None:
            """Walk ``cname.method`` recording edges held→acquired."""
            if depth > self._MAX_DEPTH or (cname, method) in seen:
                return
            seen = seen | {(cname, method)}
            entry = classes.get(cname)
            if entry is None:
                return
            sf, cnode = entry
            mnode = next(
                (n for n in cnode.body
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and n.name == method), None)
            if mnode is None:
                return
            self_name = (mnode.args.args[0].arg
                         if mnode.args.args else "self")

            def visit(node: ast.AST, held_now: tuple[LockId, ...]) -> None:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda, ast.ClassDef)) \
                        and node is not mnode:
                    return
                if isinstance(node, ast.With):
                    new_held = held_now
                    for item in node.items:
                        expr = item.context_expr
                        if (isinstance(expr, ast.Call)
                                and isinstance(expr.func, ast.Attribute)):
                            expr = expr.func.value      # .acquire() etc
                        if (isinstance(expr, ast.Attribute)
                                and isinstance(expr.value, ast.Name)
                                and expr.value.id == self_name):
                            lk = lock_of(cname, expr.attr, sf)
                            if lk is not None:
                                for h in new_held:
                                    if h != lk:
                                        edges.setdefault(
                                            (h, lk),
                                            (sf.rel, node.lineno))
                                new_held = new_held + (lk,)
                    for stmt in node.body:
                        visit(stmt, new_held)
                    return
                if isinstance(node, ast.Call):
                    name = call_name(node.func)
                    if name and name.startswith(self_name + "."):
                        parts = name.split(".")[1:]
                        if len(parts) == 1:
                            acquisitions(cname, parts[0], depth + 1,
                                         held_now, seen)
                        elif len(parts) == 2:
                            tcls = attr_types.get(cname, {}).get(parts[0])
                            if tcls:
                                acquisitions(tcls, parts[1], depth + 1,
                                             held_now, seen)
                for child in ast.iter_child_nodes(node):
                    visit(child, held_now)

            visit(mnode, held)

        for cname, (sf, cnode) in classes.items():
            for m in cnode.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    acquisitions(cname, m.name, 0, (), set())

        yield from self._report_cycles(project, edges)

    @staticmethod
    def _class_info(node: ast.ClassDef):
        """(lock attribute names, {attr: ClassName} best-effort types
        from __init__ annotations and direct construction)."""
        locks: set[str] = set()
        types: dict[str, str] = {}
        ann: dict[str, str] = {}
        for m in node.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if m.name == "__init__":
                for a in m.args.args[1:]:
                    if isinstance(a.annotation, ast.Name):
                        ann[a.arg] = a.annotation.id
                    elif (isinstance(a.annotation, ast.Constant)
                          and isinstance(a.annotation.value, str)):
                        # forward reference: `svc: "Service"`
                        ann[a.arg] = a.annotation.value.strip()
            for n in ast.walk(m):
                if not isinstance(n, ast.Assign):
                    continue
                for t in n.targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    if isinstance(n.value, ast.Call):
                        ctor = call_name(n.value.func)
                        if ctor in _LOCK_FACTORIES:
                            locks.add(t.attr)
                        elif ctor:
                            types[t.attr] = ctor.split(".")[-1]
                    elif (isinstance(n.value, ast.Name)
                          and n.value.id in ann):
                        types[t.attr] = ann[n.value.id]
        return locks, types

    def _report_cycles(self, project: Project,
                       edges: dict) -> Iterator[Finding]:
        graph: dict[LockId, set[LockId]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)

        reported: set[tuple[str, ...]] = set()

        def dfs(start: LockId, node: LockId, path: list[LockId],
                visited: set[LockId]) -> Iterator[list[LockId]]:
            for nxt in sorted(graph.get(node, ()), key=str):
                if nxt == start:
                    yield path + [nxt]
                elif nxt not in visited:
                    yield from dfs(start, nxt, path + [nxt],
                                   visited | {nxt})

        for start in sorted(graph, key=str):
            for cycle in dfs(start, start, [start], {start}):
                key = tuple(sorted(str(l) for l in cycle[:-1]))
                if key in reported:
                    continue
                reported.add(key)
                rel, line = edges[(cycle[0], cycle[1])]
                sf = project.by_rel.get(rel)
                chain = " -> ".join(str(l) for l in cycle)
                finding = Finding(
                    rel, line, 0, self.id,
                    f"lock-ordering cycle: {chain}; two threads taking "
                    "these locks in opposite orders deadlock — impose a "
                    "single acquisition order (or merge the locks)")
                if sf is not None:
                    finding = sf.finding(line, self.id, finding.message)
                yield finding
