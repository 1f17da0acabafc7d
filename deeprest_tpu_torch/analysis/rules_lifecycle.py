"""Rule pack RS: resource-lifecycle discipline for the chaos-ready plane.

ROADMAP item 7 asks the plane to survive a preempted slice or a replica
killed mid-request.  Nothing dynamic can prove that if the *code* leaks a
Thread, a worker subprocess, a pipe end, or a profiler window the moment
an exception takes the non-happy path: the leaked handle wedges the
serving plane exactly when chaos hits.  This pack rides the whole-program
call graph and the path-sensitive paired-operation walker (core.py):

- RS001 — a spawned resource (Thread/Process/pipe connection/socket/
  file/``jax.profiler`` trace window) must be joined/closed/terminated on
  EVERY path out of the function that created it, including exception
  paths.  Ownership escapes (stored on ``self``, returned, passed to
  another call) discharge the local obligation; daemon *threads* are
  exempt (they die with the process — daemon processes still zombie
  until reaped, so they are not).  Factories in OTHER modules count: a
  call that the graph resolves to a function returning a freshly started
  resource opens the same obligation at the call site.
- RS002 — ``drain()`` without a matching ``resume()`` (or a deliberate
  ``close()``) in the replica/router lifecycle methods: a drained-and-
  forgotten replica is permanently invisible to the dispatch loop.  Only
  lifecycle drains count — a ``drain()`` whose RESULT is consumed is a
  data pop (the span ring), not a pause.
- RS003 — ``__del__``-reliance for cleanup on hot objects: finalizers
  are not a lifecycle guarantee (ref cycles, interpreter teardown, a
  replica killed mid-request never runs them); cleanup belongs in an
  explicit ``close()`` the owner calls.
- RS004 — unbounded retry loops in the serving plane: a ``while True``
  (or recursive) retry around a raise-capable call with neither an
  attempt cap nor a backoff.  The chaos-hardened router retries dead
  replicas BOUNDEDLY (``retry_budget``) and its probe loop is paced
  (``probe_interval_s``); an unbounded retry busy-spins the host the
  moment a dependency stays down — which, under chaos, is a certainty.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    Finding, FuncKey, ObligationWalker, Project, Rule, SourceFile,
    call_name, dotted_name, guarded_if_closes, method_call_on,
    receiver_escapes, register,
)


@dataclasses.dataclass(frozen=True)
class ResourceKind:
    kind: str
    closers: tuple[str, ...]
    needs_start: bool          # obligation opens at .start(), not ctor
    daemon_exempt: bool        # daemon=True at the ctor waives it


_KINDS = {
    "thread": ResourceKind("thread", ("join",), True, True),
    "process": ResourceKind("process", ("join", "terminate", "kill"),
                            True, False),
    "pipe": ResourceKind("pipe", ("close",), False, False),
    "socket": ResourceKind("socket", ("close", "shutdown", "detach"),
                           False, False),
    "file": ResourceKind("file", ("close",), False, False),
    "popen": ResourceKind("popen", ("wait", "communicate", "kill",
                                    "terminate"), False, False),
}


def _factory_kind(call: ast.Call) -> ResourceKind | None:
    name = call_name(call.func)
    if name is None:
        return None
    if name in ("threading.Thread", "Thread"):
        return _KINDS["thread"]
    if name == "Process" or name.endswith(".Process"):
        return _KINDS["process"]
    if name == "Pipe" or name.endswith(".Pipe"):
        return _KINDS["pipe"]
    if name in ("socket.socket", "socket.create_connection"):
        return _KINDS["socket"]
    if name == "open":
        return _KINDS["file"]
    if name in ("subprocess.Popen", "Popen"):
        return _KINDS["popen"]
    return None


def _is_daemon_ctor(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


@dataclasses.dataclass
class _Acquire:
    """One local resource obligation inside one function."""

    receiver: str              # the local name bound to the resource
    res: ResourceKind
    ctor_stmt: ast.stmt
    ctor_call: ast.Call
    daemon: bool


def _stmt_of(sf: SourceFile, node: ast.AST) -> ast.stmt | None:
    """The nearest enclosing statement of an expression node (stopping at
    the function boundary)."""
    cur = node
    parents = sf.parents()
    while cur in parents:
        parent = parents[cur]
        if isinstance(cur, ast.stmt):
            return cur
        cur = parent
    return cur if isinstance(cur, ast.stmt) else None


def _function_rel_functions(sf: SourceFile):
    """Every (function node, enclosing class name) in the file, outermost
    functions only — nested defs are analyzed as part of their parent
    (their leaks belong to the enclosing frame's lifetime)."""
    if sf.tree is None:
        return
    for node in sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node, None
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield m, node.name


def _in_with_item(sf: SourceFile, call: ast.Call) -> bool:
    parents = sf.parents()
    cur: ast.AST = call
    while cur in parents:
        parent = parents[cur]
        if isinstance(parent, (ast.With, ast.AsyncWith)):
            for item in parent.items:
                if item.context_expr is cur:
                    return True
        if isinstance(parent, ast.stmt):
            return False
        cur = parent
    return False


def _factory_returns(graph, key: FuncKey,
                     depth: int = 4) -> ResourceKind | None:
    """Does the function behind ``key`` return a freshly created (and,
    for threads/processes, started) resource?  Bounded recursion through
    wrapper functions — the cross-module half of RS001."""
    if depth <= 0:
        return None
    node = graph.function_node(key)
    if node is None:
        return None
    local: dict[str, ResourceKind] = {}
    started: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
            res = _factory_kind(sub.value)
            if res is not None and not _is_daemon_ctor(sub.value):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        local[t.id] = res
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "start"
                and isinstance(sub.func.value, ast.Name)):
            started.add(sub.func.value.id)
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Return) or sub.value is None:
            continue
        v = sub.value
        if isinstance(v, ast.Call):
            res = _factory_kind(v)
            if res is not None and not _is_daemon_ctor(v):
                if not res.needs_start:
                    return res
                continue       # returning an unstarted thread is fine
            # a wrapper of a wrapper: recurse through the graph
            target = graph.resolve_call(
                key.rel, key.cls,
                "" if key.cls is None else "self", v)
            if target is not None:
                inner = _factory_returns(graph, target, depth - 1)
                if inner is not None:
                    return inner
        if isinstance(v, ast.Name) and v.id in local:
            res = local[v.id]
            if not res.needs_start or v.id in started:
                return res
    return None


@register
class RS001LeakedSpawnedResource(Rule):
    id = "RS001"
    title = ("spawned resource (Thread/Process/pipe/socket/file/profiler "
             "window) not joined/closed/terminated on every path, "
             "including exception paths")
    guards = ("round 16: ProcessReplica._boot's handshake recv could "
              "raise with the worker process and both pipe ends live — "
              "the leaked child wedged the plane exactly the way the "
              "ROADMAP item 7 chaos harness will kill replicas; every "
              "spawn/open now discharges on all paths (escape to an "
              "owner, close/join/terminate, or a try/finally)")

    def run(self, project: Project) -> Iterator[Finding]:
        graph = project.call_graph()
        for sf in project.files:
            if sf.tree is None:
                continue
            for fn, cls in _function_rel_functions(sf):
                yield from self._check_function(sf, fn, cls, graph)
                yield from self._check_profiler_window(sf, fn, cls, graph)

    # -- object-resource obligations -------------------------------------

    def _acquires(self, sf: SourceFile, fn: ast.AST,
                  graph, cls: str | None) -> list[_Acquire]:
        out: list[_Acquire] = []
        self_name = "self" if cls is not None else ""
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            targets = []
            values = []
            if isinstance(node.value, ast.Call):
                res = _factory_kind(node.value)
                if res is not None:
                    if (len(node.targets) == 1
                            and isinstance(node.targets[0], ast.Tuple)
                            and res.kind == "pipe"):
                        # conn, child = Pipe(): each end is an obligation
                        for elt in node.targets[0].elts:
                            if isinstance(elt, ast.Name):
                                targets.append(elt.id)
                                values.append((node.value, res))
                    elif len(node.targets) == 1 and isinstance(
                            node.targets[0], ast.Name):
                        targets.append(node.targets[0].id)
                        values.append((node.value, res))
                else:
                    # cross-module: a call the graph resolves to a
                    # resource-returning factory
                    target = graph.resolve_call(sf.rel, cls, self_name,
                                                node.value)
                    if target is not None and len(node.targets) == 1 \
                            and isinstance(node.targets[0], ast.Name):
                        res = _factory_returns(graph, target)
                        if res is not None:
                            targets.append(node.targets[0].id)
                            values.append((node.value, res))
            for name, (call, res) in zip(targets, values):
                if _in_with_item(sf, call):
                    continue
                stmt = _stmt_of(sf, call)
                if stmt is None:
                    continue
                out.append(_Acquire(receiver=name, res=res,
                                    ctor_stmt=stmt, ctor_call=call,
                                    daemon=_is_daemon_ctor(call)))
        return out

    def _check_function(self, sf: SourceFile, fn: ast.AST,
                        cls: str | None, graph) -> Iterator[Finding]:
        for acq in self._acquires(sf, fn, graph, cls):
            res = acq.res
            if acq.daemon and res.daemon_exempt:
                continue
            open_at = acq.ctor_stmt
            if res.needs_start and _factory_kind(acq.ctor_call):
                # a locally-CONSTRUCTED thread/process owes nothing until
                # it starts; factory-returned ones arrive already started
                start_stmt = self._start_stmt(sf, fn, acq.receiver)
                if start_stmt is None:
                    continue
                open_at = start_stmt

            def closes(stmt: ast.stmt, _recv=acq.receiver,
                       _res=res) -> bool:
                if isinstance(stmt, ast.If):
                    return guarded_if_closes(stmt, _recv, _res.closers)
                if method_call_on(stmt, _recv, _res.closers) is not None:
                    return True
                return receiver_escapes(stmt, _recv)

            walker = ObligationWalker(fn, open_at, closes)
            for leak in walker.run():
                yield sf.finding(
                    leak.node, self.id, self._message(acq, leak))
                break          # one finding per obligation

    @staticmethod
    def _start_stmt(sf: SourceFile, fn: ast.AST,
                    receiver: str) -> ast.stmt | None:
        # simple statements only: matching a compound container would
        # open the obligation "after the whole if", branches untaken
        for node in ast.walk(fn):
            if not isinstance(node, (ast.Expr, ast.Assign)):
                continue
            if method_call_on(node, receiver, ("start",)) is not None:
                return node
        return None

    def _message(self, acq: _Acquire, leak) -> str:
        want = "/".join(f".{c}()" for c in acq.res.closers)
        how = ("an exception here leaks it — release it in a "
               "try/finally (or an except that cleans up)"
               if leak.kind == "exception"
               else "this path exits the function with it still live")
        return (f"{acq.res.kind} {acq.receiver!r} (created line "
                f"{acq.ctor_call.lineno}) is not discharged on every "
                f"path: {how}; call {want}, hand ownership to a "
                "long-lived owner, or suppress with a reason if this "
                "lifetime is the design")

    # -- the jax.profiler window (paired GLOBAL calls) --------------------

    _START = ("jax.profiler.start_trace", "profiler.start_trace")
    _STOP = ("jax.profiler.stop_trace", "profiler.stop_trace")

    def _check_profiler_window(self, sf: SourceFile, fn: ast.AST,
                               cls: str | None,
                               graph) -> Iterator[Finding]:
        self_name = "self" if cls is not None else ""
        starts = [n for n in ast.walk(fn)
                  if isinstance(n, ast.Call)
                  and call_name(n.func) in self._START]
        if not starts:
            return
        stop_wrappers = self._stop_wrappers(sf, fn, cls, graph)

        def closes(stmt: ast.stmt) -> bool:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    name = call_name(n.func)
                    if name in self._STOP or name in stop_wrappers:
                        return True
            return False

        for start in starts:
            open_at = _stmt_of(sf, start)
            if open_at is None:
                continue
            walker = ObligationWalker(fn, open_at, closes)
            for leak in walker.run():
                how = ("an exception here leaves the trace window open"
                       if leak.kind == "exception"
                       else "this path exits with the window open")
                yield sf.finding(
                    leak.node, self.id,
                    f"jax.profiler trace window opened line "
                    f"{start.lineno} is not closed on every path: {how}; "
                    "stop_trace() belongs in a finally")
                break

    def _stop_wrappers(self, sf: SourceFile, fn: ast.AST,
                       cls: str | None, graph) -> set[str]:
        """Callable names that (transitively, via the call graph or a
        local def) end in stop_trace — cli.py's ``stop_profiling()``."""
        out: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Call) \
                            and call_name(sub.func) in self._STOP:
                        out.add(node.name)
        key_cls = cls
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            target = graph.resolve_call(
                sf.rel, key_cls, "self" if key_cls else "", node)
            if target is None:
                continue
            tnode = graph.function_node(target)
            if tnode is None:
                continue
            for sub in ast.walk(tnode):
                if isinstance(sub, ast.Call) \
                        and call_name(sub.func) in self._STOP:
                    name = call_name(node.func)
                    if name:
                        out.add(name)
        return out


@register
class RS002DrainWithoutResume(Rule):
    id = "RS002"
    title = ("lifecycle drain() without a matching resume()/close() on "
             "every path in the replica/router plane")
    guards = ("round 16: ReplicaRouter.scale_to drained the shrink set "
              "and closed each replica with raise-capable calls between "
              "— one failing close left the rest drained-and-live "
              "forever, invisible to dispatch; drain obligations now "
              "discharge on all paths (rolling_reload_from's "
              "try/finally resume is the model)")

    # The replica/router lifecycle lives under serve/ — obs' span-ring
    # drain() is a data pop, excluded both by directory and by the
    # result-consumed test below.
    HOT_DIRS = ("serve",)
    _CLOSERS = ("resume", "close", "terminate", "kill", "shutdown")

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return any(d in parts[:-1] for d in self.HOT_DIRS)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for fn, _cls in _function_rel_functions(sf):
                yield from self._check(sf, fn)

    def _drain_sites(self, fn: ast.AST) -> list[tuple[str, ast.stmt]]:
        """(receiver, statement) for every LIFECYCLE drain: the call is a
        bare expression statement — a drain whose result is consumed is a
        data pop, not a pause."""
        out = []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "drain"):
                recv = dotted_name(node.value.func.value)
                if recv is not None:
                    out.append((recv, node))
        return out

    def _check(self, sf: SourceFile, fn: ast.AST) -> Iterator[Finding]:
        seen: set[str] = set()
        for recv, stmt in self._drain_sites(fn):
            if recv in seen:
                continue
            seen.add(recv)

            def closes(s: ast.stmt, _recv=recv) -> bool:
                if isinstance(s, ast.If):
                    return guarded_if_closes(s, _recv, self._CLOSERS)
                return method_call_on(s, _recv, self._CLOSERS) is not None

            # the drain loop and its completer loop iterate the same
            # replica set: the zero-trip join would flag every pair
            walker = ObligationWalker(fn, stmt, closes,
                                      assume_loops_run=True)
            for leak in walker.run():
                if leak.kind != "path":
                    continue       # exception-path stranding is EX002's
                # anchored at the DRAIN (where a suppression belongs),
                # with the leaking exit in the message
                yield sf.finding(
                    stmt, self.id,
                    f"{recv}.drain() has no matching resume()/close() "
                    f"on the path exiting at line "
                    f"{getattr(leak.node, 'lineno', '?')}: a drained "
                    "replica is invisible to dispatch forever; resume in "
                    "a finally (rolling reload), close it (scale-down), "
                    "or suppress with a reason for a designed shutdown "
                    "sink")
                break


def _body_has(nodes, kinds) -> bool:
    """Any node of ``kinds`` in the statements' subtrees, NOT descending
    into nested function definitions (their control flow is their own)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(node, kinds):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return False


_BACKOFF_ATTRS = ("sleep", "wait")


def _has_backoff(nodes) -> bool:
    """A pacing call (time.sleep / Event.wait / Condition.wait / stop
    .wait) anywhere in the statements, nested defs excluded."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            name = call_name(node.func)
            if name is not None and name.split(".")[-1] in _BACKOFF_ATTRS:
                return True
        stack.extend(ast.iter_child_nodes(node))
    return False


def _has_cap_guard(fn: ast.AST) -> bool:
    """An attempt-cap shape anywhere in the function: an ``if`` whose
    test contains a comparison and whose body raises/returns/breaks —
    ``if attempt >= budget: raise`` and friends."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        if not any(isinstance(s, ast.Compare) for s in ast.walk(node.test)):
            continue
        if _body_has(node.body, (ast.Raise, ast.Return, ast.Break)):
            return True
    return False


@register
class RS004UnboundedRetry(Rule):
    id = "RS004"
    title = ("unbounded retry loop (while-True or recursive retry around "
             "a raise-capable call with no attempt cap or backoff) in "
             "the serve/ plane")
    guards = ("round 17: the chaos-hardened router re-dispatches dead-"
              "replica requests and the probe loop reboots ejected "
              "workers — both retries are BOUNDED by design "
              "(RouterConfig.retry_budget; probe_interval_s pacing).  A "
              "retry loop with neither an attempt cap nor a backoff "
              "turns one dead replica into a busy-spin that saturates "
              "the host exactly when the plane is least healthy — and "
              "under chaos every replica WILL die eventually, so the "
              "spin is a certainty, not a tail risk")

    # The serving plane, where retries meet live traffic.
    HOT_DIRS = ("serve",)

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return any(d in parts[:-1] for d in self.HOT_DIRS)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for fn, _cls in _function_rel_functions(sf):
                yield from self._check_while_retry(sf, fn)
                yield from self._check_recursive_retry(sf, fn)

    @staticmethod
    def _is_forever(test: ast.AST) -> bool:
        return isinstance(test, ast.Constant) and bool(test.value)

    def _check_while_retry(self, sf: SourceFile,
                           fn: ast.AST) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not (isinstance(node, ast.While)
                    and self._is_forever(node.test)):
                continue
            for stmt in node.body:
                if not isinstance(stmt, ast.Try):
                    continue
                # a retry-continue handler neither re-raises nor leaves
                # the loop: the exception is eaten and the loop respins
                swallowing = [
                    h for h in stmt.handlers
                    if not _body_has(h.body,
                                     (ast.Raise, ast.Return, ast.Break))
                ]
                if not swallowing:
                    continue
                # discharged by EITHER an attempt cap (a compare-guarded
                # raise/break/return anywhere in the loop) or a backoff
                # (a sleep/wait pacing the respin)
                if _has_backoff(node.body) or any(_has_cap_guard(s)
                                                  for s in node.body):
                    continue
                yield sf.finding(
                    swallowing[0], self.id,
                    "unbounded retry: this while-True loop swallows the "
                    "exception and respins with no attempt cap and no "
                    "backoff — one persistently-failing callee becomes "
                    "a busy-spin; bound it (attempt counter + raise) or "
                    "pace it (sleep/Event.wait), or suppress with a "
                    "reason")
                break

    def _check_recursive_retry(self, sf: SourceFile,
                               fn: ast.AST) -> Iterator[Finding]:
        name = getattr(fn, "name", None)
        if not name:
            return
        if _has_cap_guard(fn):
            return                     # a compare-guarded raise = the cap
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            for h in node.handlers:
                if _has_backoff(h.body):
                    continue
                for stmt in h.body:
                    for sub in ast.walk(stmt):
                        if not isinstance(sub, ast.Call):
                            continue
                        cname = call_name(sub.func)
                        if cname is not None and \
                                cname.split(".")[-1] == name:
                            yield sf.finding(
                                sub, self.id,
                                f"unbounded recursive retry: the "
                                f"handler calls {name}() again with no "
                                "attempt cap in sight — a persistently-"
                                "failing callee recurses to the stack "
                                "limit; thread an attempts parameter "
                                "with a compare-guarded raise, or "
                                "suppress with a reason")
                            return


@register
class RS003DelReliance(Rule):
    id = "RS003"
    title = ("__del__ used for resource cleanup on a hot object "
             "(finalizers are not a lifecycle guarantee)")
    guards = ("the chaos harness (ROADMAP item 7) kills replicas "
              "mid-request: a __del__ that closes pipes/joins workers "
              "never runs on a ref cycle, on interpreter teardown "
              "ordering, or on a SIGKILLed process — cleanup must be an "
              "explicit close() the owner calls (and the RS001/RS002 "
              "walkers can then prove it is called)")

    HOT_DIRS = ("serve", "train", "obs", "ops")
    _CLEANUP = ("close", "join", "terminate", "kill", "release",
                "shutdown", "stop", "stop_trace", "disconnect")

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return any(d in parts[:-1] for d in self.HOT_DIRS)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for node in sf.walk():
                if not isinstance(node, ast.ClassDef):
                    continue
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) \
                            and m.name == "__del__":
                        if self._does_cleanup(m):
                            yield sf.finding(
                                m, self.id,
                                f"{node.name}.__del__ performs resource "
                                "cleanup: finalizers are skipped on ref "
                                "cycles, teardown ordering, and killed "
                                "processes — move the cleanup into an "
                                "explicit close() the owner is "
                                "responsible for calling")

    def _does_cleanup(self, m: ast.AST) -> bool:
        for n in ast.walk(m):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in self._CLEANUP):
                return True
        return False
