"""Rule pack TX: CUDA-graph capture and ``torch.compile`` invariants.

The port replaces each ``jax.jit`` executable with a captured CUDA graph
(``graphs.py``): the trainer's optimizer update (``train/graphs.py``
``capture_update``) and one graph per serving rung (``serve/graphs.py``
``RungGraphs``).  A graph bakes in the ADDRESS of every tensor its body
touched and replays the recorded kernels, so the JAX package's jit hazards
come back in capture form.  Each rule here is the counterpart of the JX rule
with the same number:

- TX001 (JX001) — a tensor that captured code reads through a free name or
  a ``self.`` attribute, which the program rebinds by plain assignment: the
  graph keeps the old address and every later replay reads the old storage.
  The fleet tier's ``BoundSlot`` is the designed shape: weights are
  ``copy_``'d into the tensors the graphs were captured against.
- TX002 (JX002) — a ``torch.cuda.CUDAGraph()``, capture or ``torch.compile``
  inside a loop body, or applied per call to a fresh lambda or local def
  with no keyed cache in front of it: it breaks the "18 graphs at warm-up,
  0 after" contract (``RungGraphs`` looks its key up before
  ``_capture_locked``).
- TX004 (JX004) — a graph's static output read after the ``with
  <graphs>.lock`` block that covered its run, or after a later run or
  replay of the same graphs, without a copy-out (``.clone()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``copy_`` into a buffer of its own): the next
  replay overwrites it (``serve/graphs.py``: "the caller holds ``lock``
  across the run and the copy-out").
- TX005 (JX005) — a partition-spec literal handed to the mesh's box and
  gather helpers outside ``parallel/sharding.py``, where ``spec_of`` and the
  rule table decide.
- TX006 (JX006) — inside captured code, a host-made constant, a float64
  widening, an integer tensor times a Python float, or a pinned allocation,
  event or stream made in the body (a collection inside a capture freed
  pinned memory and gave CUDA error 901 on the card; ``graphs.py`` pauses
  the collector since).

All of them range over the CAPTURED CODE (:func:`captured_scope`): the
bodies handed to ``graphs.capture``, ``capture_update`` and
``RungGraphs.run``, ``with torch.cuda.graph(...)`` blocks,
``torch.cuda.make_graphed_callables`` and ``torch.compile``, and every
function those reach through the call graph (the closure JX006 takes over
jit seeds).  JX007 takes the same seeds as a second set of entry points: a
host sync reached there fails the capture at run time.
"""

from __future__ import annotations

import ast
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    Finding, FuncKey, Project, Rule, SourceFile, call_name, in_loop,
    register, scope_bound_names, walk_no_nested_scopes,
)
from deeprest_tpu_torch.analysis.captured import (
    capture_sites, captured_scope, context, graphs_receiver, is_capture_call,
    name_is_paramish,
)


# -- shared helpers -----------------------------------------------------------

# Calls whose result is a tensor for TX001's "rebinds a tensor" test: torch
# constructors and ops, and the tensor methods that return a new tensor.
_TENSOR_METHODS = frozenset({
    "to", "cuda", "clone", "detach", "float", "half", "bfloat16", "double",
    "contiguous", "view", "reshape", "t", "permute", "transpose",
    "expand", "repeat", "new_zeros", "new_ones", "new_empty", "new_tensor",
})


def _tensor_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.BinOp):
        return _tensor_expr(node.left) or _tensor_expr(node.right)
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node.func) or ""
    if name.startswith(("torch.", "F.")) and not name.startswith(
            ("torch.cuda.", "torch.distributed.")):
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_METHODS)


def _methods_of(sf: SourceFile, cls: str) -> dict[str, ast.AST]:
    for node in sf.tree.body if sf.tree is not None else ():
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return {m.name: m for m in node.body
                    if isinstance(m, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))}
    return {}


def _init_time(graph, rel: str, cls: str) -> set[str]:
    """``__init__`` and the methods only it (transitively) calls."""
    edges = graph.class_method_edges(rel, cls)
    callers: dict[str, set[str]] = {}
    for caller, callees in edges.items():
        for callee in callees:
            callers.setdefault(callee, set()).add(caller)
    init = {"__init__"}
    changed = True
    while changed:
        changed = False
        for name, who in callers.items():
            if name not in init and who and who <= init:
                init.add(name)
                changed = True
    return init


# -- TX001 --------------------------------------------------------------------


@register
class TX001RebindingCapturedTensor(Rule):
    id = "TX001"
    title = ("tensor read by captured code (CUDA graph / torch.compile) "
             "rebound by plain assignment instead of copied into in place")
    guards = ("the fleet tier shares one plane's rung graphs across "
              "tenants: a graph replays against the addresses it captured, "
              "so a tenant's weights are copy_'d into the plane's BoundSlot "
              "(serve/graphs.py); rebinding the attribute instead leaves "
              "every replay reading the old tensor — the capture-time "
              "counterpart of JX001's closure-baked params")

    def run(self, project: Project) -> Iterator[Finding]:
        scope = captured_scope(project)
        graph = project.call_graph()
        rebinds: dict[tuple, dict[str, list]] = {}
        seen: set[tuple] = set()
        for sf in project.files:
            ids = scope.ids.get(sf.rel)
            if not ids or sf.tree is None:
                continue
            for node in sf.walk():
                if id(node) not in ids or isinstance(node, (ast.With,
                                                            ast.AsyncWith)):
                    continue
                cls, self_name, _ = context(sf, node)
                if cls is not None and self_name:
                    table = rebinds.get(cls)
                    if table is None:
                        table = rebinds[cls] = self._family_rebinds(
                            project, scope, cls, graph)
                    yield from self._self_reads(sf, node, self_name, table,
                                                seen)
                if id(node) in scope.bodies:
                    yield from self._free_names(sf, node, seen)

    def _family_rebinds(self, project, scope, cls: str, graph
                        ) -> dict[str, list]:
        """``{attr: [(file, assignment)]}`` over ``cls``, its bases and its
        subclasses, wherever in the project each is defined."""
        family = scope.family(cls)
        out: dict[str, list] = {}
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef) and node.name in family:
                    for attr, stmts in self._rebinds(sf, node.name,
                                                     graph).items():
                        out.setdefault(attr, []).extend(
                            (sf, stmt) for stmt in stmts)
        return out

    @staticmethod
    def _rebinds(sf: SourceFile, cls: str, graph) -> dict[str, list]:
        """``{attr: [plain assignments to self.attr]}`` of one class, in
        its methods that run after construction, where the attribute names
        parameters or the value is a tensor expression."""
        init = _init_time(graph, sf.rel, cls)
        out: dict[str, list] = {}
        for name, m in _methods_of(sf, cls).items():
            if name in init or not m.args.args:
                continue
            self_name = m.args.args[0].arg
            for stmt in ast.walk(m):
                if not isinstance(stmt, (ast.Assign, ast.AnnAssign)) or \
                        stmt.value is None:
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                for t in targets:
                    for n in ast.walk(t):
                        if (isinstance(n, ast.Attribute)
                                and isinstance(n.ctx, ast.Store)
                                and isinstance(n.value, ast.Name)
                                and n.value.id == self_name
                                and (name_is_paramish(n.attr)
                                     or _tensor_expr(stmt.value))):
                            out.setdefault(n.attr, []).append(stmt)
        return out

    def _self_reads(self, sf, fn, self_name, table, seen):
        parents = sf.parents()
        for sub in ast.walk(fn):
            if not (isinstance(sub, ast.Attribute)
                    and isinstance(sub.ctx, ast.Load)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == self_name
                    and sub.attr in table):
                continue
            parent = parents.get(sub)
            if isinstance(parent, ast.Call) and parent.func is sub:
                continue
            for where, stmt in table[sub.attr]:
                yield from self._emit(where, stmt, sub, f"self.{sub.attr}",
                                      seen, sf)

    def _free_names(self, sf, fn, seen) -> Iterator[Finding]:
        """Free names of a nested captured body that its enclosing
        function rebinds after the capture."""
        own = scope_bound_names(fn)
        outer = next((a for a in sf.ancestors(fn)
                      if isinstance(a, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))), None)
        if outer is None:
            return
        site_line = self._site_line(sf, fn, outer)
        later: dict[str, list] = {}
        for stmt in walk_no_nested_scopes(outer):
            if isinstance(stmt, ast.Assign) and stmt.lineno > site_line:
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        later.setdefault(t.id, []).append(stmt)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                    and sub.id not in own:
                for stmt in later.get(sub.id, ()):
                    if name_is_paramish(sub.id) or _tensor_expr(stmt.value):
                        yield from self._emit(sf, stmt, sub, sub.id, seen,
                                              sf)

    @staticmethod
    def _site_line(sf, fn, outer) -> int:
        """The line of the capture that takes ``fn``."""
        parent = sf.parents().get(fn)
        if isinstance(parent, ast.Call):
            return parent.lineno
        name = getattr(fn, "name", None)
        for node in walk_no_nested_scopes(outer):
            if isinstance(node, ast.Call) and any(
                    isinstance(a, ast.Name) and a.id == name
                    for a in node.args):
                return node.lineno
        return getattr(fn, "lineno", 0)

    def _emit(self, sf, rebind, read, what, seen,
              read_sf) -> Iterator[Finding]:
        """One finding at the rebinding ``rebind`` (in ``sf``) of what
        captured code reads at ``read`` (in ``read_sf``)."""
        dk = (sf.rel, rebind.lineno, rebind.col_offset, what)
        if dk in seen:
            return
        seen.add(dk)
        yield Finding(
            sf.rel, rebind.lineno, rebind.col_offset, self.id,
            f"{what} is read by captured code at "
            f"{read_sf.rel}:{read.lineno}, and a CUDA graph keeps the "
            "address it read at capture; this plain assignment rebinds it, "
            "so every later replay reads the old tensor: copy_ the new "
            "values into it instead",
            related=[(read_sf.rel, read.lineno, read.col_offset,
                      "captured read")])


# -- TX002 --------------------------------------------------------------------


@register
class TX002RecaptureHazard(Rule):
    id = "TX002"
    title = ("re-capture hazard: CUDAGraph()/graphs.capture/capture_update/"
             "torch.compile in a loop body, or applied per call to a fresh "
             "lambda/local def with no keyed cache")
    guards = ("the serving plane captures 18 rung graphs at warm-up and "
              "0 after (serve/graphs.py RungGraphs looks its key up before "
              "_capture_locked; PERF.md checks the count on every plane); a "
              "capture or compile per call or per iteration re-records "
              "every time — the capture-time counterpart of JX002's "
              "jit-in-a-loop")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in sf.walk():
                if isinstance(node, ast.Call) and call_name(node.func) in (
                        "torch.cuda.CUDAGraph", "CUDAGraph") and \
                        in_loop(sf, node):
                    yield sf.finding(
                        node, self.id,
                        "torch.cuda.CUDAGraph() inside a loop body: every "
                        "iteration records a new graph; capture once and "
                        "replay it")
            for site, target, kind in capture_sites(project, sf):
                if kind in ("run", "graph"):
                    continue
                what = ("@torch.compile" if kind == "decorator"
                        else call_name(site.func))
                if kind != "decorator" and in_loop(sf, site):
                    yield sf.finding(
                        site, self.id,
                        f"{what} inside a loop body: every iteration "
                        "captures (or compiles) anew; hoist it out of the "
                        "loop and replay the result")
                    continue
                if self._fresh(sf, site, target) and \
                        not self._cached(sf, site):
                    yield sf.finding(
                        site, self.id,
                        f"{what} of a lambda or local def made at every "
                        "call of the enclosing function, with no keyed "
                        "cache in front of it: each call records or "
                        "compiles again; look the result up by key first "
                        "(serve/graphs.py RungGraphs) and store it")

    @staticmethod
    def _fresh(sf: SourceFile, site: ast.AST, target) -> bool:
        """The callable is made inside the function that captures it."""
        enclosing = next((a for a in sf.ancestors(site)
                          if isinstance(a, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))), None)
        if enclosing is None or target is None or \
                enclosing.name == "__init__":
            return False        # a capture per object is the object's own
        if isinstance(target, ast.Lambda):
            return True
        if isinstance(target, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return target is not enclosing and any(
                a is enclosing for a in sf.ancestors(target))
        if isinstance(target, ast.Name):
            for sub in walk_no_nested_scopes(enclosing):
                if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Lambda) and any(
                            isinstance(t, ast.Name) and t.id == target.id
                            for t in sub.targets):
                    return True
            return any(isinstance(s, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                       and s.name == target.id
                       for s in ast.walk(enclosing) if s is not enclosing)
        return False

    @staticmethod
    def _cached(sf: SourceFile, site: ast.AST) -> bool:
        """Something outlives the call with the result: the enclosing
        function returns it (a builder), stores into a subscript (a keyed
        cache), or assigns the capture to an attribute it tests for None
        first (the trainer's ``state.graph``)."""
        enclosing = next((a for a in sf.ancestors(site)
                          if isinstance(a, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))), None)
        if enclosing is None:
            return False
        # returned: the caller holds (and caches) what the builder made
        for anc in sf.ancestors(site):
            if anc is enclosing:
                break
            if isinstance(anc, ast.Return):
                return True
        memo = None
        parent = sf.parents().get(site)
        if isinstance(parent, ast.Assign):
            bound = {n.id for t in parent.targets for n in ast.walk(t)
                     if isinstance(n, ast.Name)}
            for r in walk_no_nested_scopes(enclosing):
                if not isinstance(r, ast.Return) or r.value is None:
                    continue
                elts = (r.value.elts if isinstance(r.value, ast.Tuple)
                        else [r.value])
                if any(isinstance(e, ast.Name) and e.id in bound
                       for e in elts):
                    return True
            for t in parent.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Attribute):
                        memo = call_name(n)
        for sub in ast.walk(enclosing):
            if isinstance(sub, ast.Subscript) and isinstance(
                    sub.ctx, ast.Store):
                return True
            if memo is not None and isinstance(sub, ast.Compare) and any(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops) \
                    and call_name(sub.left) == memo:
                return True
        return False


# -- TX004 --------------------------------------------------------------------

# a read that copies a static output out of the graph's pool
_COPY_OUT = frozenset({"clone", "cpu", "tolist", "numpy", "item"})


def _static_returning(project: Project) -> dict[FuncKey, str]:
    """Functions that return a ``<graphs>.run(...)`` result directly (the
    fused engine's ``_page``), with the graphs receiver as the caller sees
    it (``self._graphs``)."""
    graph = project.call_graph()
    out: dict[FuncKey, str] = {}
    for key, node in graph.functions.items():
        for sub in walk_no_nested_scopes(node):
            if isinstance(sub, ast.Return) and isinstance(sub.value,
                                                          ast.Call):
                recv = graphs_receiver(sub.value)
                if recv is not None:
                    out[key] = recv
    return out


@register
class TX004StaticOutputAfterRelease(Rule):
    id = "TX004"
    title = ("captured graph's static output read after the graphs lock "
             "that covered its run was released, or after a later "
             "run/replay, without a copy-out")
    guards = ("serve/graphs.py: a replay overwrites the last one's static "
              "outputs, so the caller holds RungGraphs.lock across the run "
              "and the copy-out (a clone, or a copy into a pinned buffer "
              "enqueued before the next replay); a value held past either "
              "silently becomes another request's answer — the "
              "capture-time counterpart of JX004's read-after-donation")

    def run(self, project: Project) -> Iterator[Finding]:
        from deeprest_tpu_torch.analysis.locksets import LocksetAnalysis

        graph = project.call_graph()
        static_fns = _static_returning(project)
        # a unit every caller enters with a lock held (graftrace's entry
        # locks, the `*_locked` convention included) never releases it
        entered_locked = {(c.sf.rel, c.name, name)
                          for c in LocksetAnalysis.of(project).iter_classes()
                          for name, unit in c.units.items()
                          if unit.entry_locks}
        for key, fn in graph.functions.items():
            sf = project.by_rel.get(key.rel)
            if sf is None:
                continue
            covered = (key.rel, key.cls, key.name) in entered_locked
            yield from self._check(project, sf, key, fn, static_fns,
                                   covered)

    @staticmethod
    def _producer(project, sf, key, call, static_fns) -> str | None:
        """The graphs receiver when ``call`` runs a graph and returns its
        static outputs: ``R.run(...)``, or a function that returns one
        (its ``self.`` receiver seen through the caller's)."""
        recv = graphs_receiver(call)
        if recv is not None:
            return recv
        graph = project.call_graph()
        hit = graph.resolve_call(key.rel, key.cls, context(sf, call)[1],
                                 call)
        recv = static_fns.get(hit)
        if recv is None:
            return None
        head, _, rest = recv.partition(".")
        fn = graph.function_node(hit)
        names = [a.arg for a in fn.args.args]
        offset = 1 if hit.cls is not None and isinstance(
            call.func, ast.Attribute) else 0
        if hit.cls is not None and names and head == names[0]:
            # the callee's self.graphs is the caller's receiver's
            owner = (call_name(call.func.value)
                     if isinstance(call.func, ast.Attribute) else None)
            base = owner
        elif head in names and 0 <= names.index(head) - offset < len(
                call.args):
            # a graphs object passed in: the caller's argument
            base = call_name(call.args[names.index(head) - offset])
        else:
            base = head
        if base is None:
            return None
        return f"{base}.{rest}" if rest else base

    @staticmethod
    def _alias_source(value: ast.AST) -> str | None:
        """The name a value is a view of: ``y``, ``y[...]``,
        ``y.view(...)``."""
        while True:
            if isinstance(value, ast.Name):
                return value.id
            if isinstance(value, ast.Subscript):
                value = value.value
            elif isinstance(value, ast.Call) and isinstance(
                    value.func, ast.Attribute) and value.func.attr in (
                        "view", "reshape", "narrow", "squeeze",
                        "unsqueeze", "flatten"):
                value = value.func.value
            else:
                return None

    def _events(self, project, sf, key, fn, static_fns) -> list:
        """Binds, aliases, runs and reads of one function, in order (by
        line; at one line the reads first, then the runs, then the
        binds)."""
        events = []
        for node in walk_no_nested_scopes(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
                    node.value is not None:
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names = [n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name)]
                value = node.value
                recv = (self._producer(project, sf, key, value, static_fns)
                        if isinstance(value, ast.Call) else None)
                if recv is not None:
                    events.append((node.end_lineno, 2, 0, "bind",
                                   (names, recv, True, node)))
                elif isinstance(value, ast.Call) and \
                        is_capture_call(project, sf, value):
                    # graph, outputs = capture(...): the live handles
                    pair = next((t.elts for t in targets
                                 if isinstance(t, ast.Tuple)
                                 and len(t.elts) == 2
                                 and all(isinstance(e, ast.Name)
                                         for e in t.elts)), None)
                    if pair is not None:
                        events.append((node.end_lineno, 2, 0, "bind",
                                       ([pair[1].id], pair[0].id, False,
                                        node)))
                else:
                    events.append((node.end_lineno, 2, 0, "alias",
                                   (names, self._alias_source(value))))
            elif isinstance(node, ast.Call):
                recv = self._producer(project, sf, key, node, static_fns)
                if recv is None and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "replay":
                    recv = call_name(node.func.value)
                if recv is not None:
                    events.append((node.lineno, 1, node.col_offset, "run",
                                   recv))
            elif isinstance(node, ast.Name) and isinstance(node.ctx,
                                                           ast.Load):
                events.append((node.lineno, 0, node.col_offset, "read",
                               node))
        events.sort(key=lambda e: e[:3])
        return events

    def _check(self, project, sf, key, fn, static_fns, covered):
        parents = sf.parents()
        live: dict[str, dict] = {}
        for line, _order, _col, kind, payload in self._events(
                project, sf, key, fn, static_fns):
            if kind == "bind":
                names, recv, held, stmt = payload
                lock = None if covered else self._lock_block(sf, stmt, recv)
                for n in names:
                    live[n] = {"recv": recv, "held": held, "lock": lock,
                               "stale": None}
            elif kind == "alias":
                names, src = payload
                for n in names:
                    if n == src:
                        continue
                    if src in live:
                        live[n] = dict(live[src], held=True, stale=None)
                    else:
                        live.pop(n, None)
            elif kind == "run":
                for info in live.values():
                    if info["recv"] == payload and info["held"] and \
                            info["stale"] is None:
                        info["stale"] = line
            else:
                info = live.get(payload.id)
                if info is None or self._copied_out(parents, payload):
                    continue
                lock = info["lock"]
                if lock is not None and line > lock.end_lineno:
                    why = (f"after the `with {info['recv']}.lock` block "
                           f"that covered its run ended (line "
                           f"{lock.end_lineno})")
                elif info["stale"] is not None and line > info["stale"]:
                    why = (f"after a later run or replay of "
                           f"{info['recv']} (line {info['stale']})")
                else:
                    continue
                del live[payload.id]              # report once per value
                yield sf.finding(
                    payload, self.id,
                    f"{payload.id!r} is a static output of a captured graph "
                    f"read here {why}: the next replay overwrites it in "
                    "place; copy it out first (.clone(), .cpu(), .numpy(), "
                    "or copy_ into a buffer of its own) while the lock is "
                    "held")

    @staticmethod
    def _lock_block(sf, stmt, recv):
        for anc in sf.ancestors(stmt):
            if isinstance(anc, (ast.With, ast.AsyncWith)):
                for item in anc.items:
                    if call_name(item.context_expr) == f"{recv}.lock":
                        return anc
        return None

    @staticmethod
    def _copied_out(parents, name: ast.Name) -> bool:
        parent = parents.get(name)
        if isinstance(parent, ast.Attribute) and parent.attr in _COPY_OUT:
            return True
        return (isinstance(parent, ast.Call)
                and isinstance(parent.func, ast.Attribute)
                and parent.func.attr == "copy_" and name in parent.args)


# -- TX005 --------------------------------------------------------------------

_AXES = ("data", "expert", "model")
_BOX_HELPERS = ("rank_box", "box_reader", "gather_leaf", "all_boxes",
                "replica_writer")


def _spec_literal(node: ast.AST) -> bool:
    if not isinstance(node, ast.Tuple) or not node.elts:
        return False
    named = False
    for e in node.elts:
        if not isinstance(e, ast.Constant):
            return False
        if e.value in _AXES:
            named = True
        elif e.value is not None:
            return False
    return named


@register
class TX005HandPinnedSpec(Rule):
    id = "TX005"
    title = ("partition-spec literal handed to rank_box/box_reader/"
             "gather_leaf/all_boxes/replica_writer outside "
             "parallel/sharding.py (bypassing the rule table)")
    guards = ("the partition-rule table (parallel/sharding.PARTITION_RULES) "
              "is the ONE owner of every leaf's placement on the mesh, as "
              "in the JAX package; a spec tuple written at a call site is a "
              "second owner that drifts from the table when a rule changes "
              "— the torch.distributed counterpart of JX005's "
              "NamedSharding literal")

    ALLOWED_SUFFIX = ("parallel", "sharding.py")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            parts = tuple(sf.rel.replace("\\", "/").split("/"))
            if parts[-2:] == self.ALLOWED_SUFFIX:
                continue
            for node in sf.walk():
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node.func)
                if name is None or name.rsplit(".", 1)[-1] not in \
                        _BOX_HELPERS:
                    continue
                for arg in list(node.args) + [k.value for k in
                                              node.keywords]:
                    if _spec_literal(arg):
                        yield sf.finding(
                            arg, self.id,
                            f"spec literal {ast.unparse(arg)} handed to "
                            f"{name.rsplit('.', 1)[-1]} outside "
                            "parallel/sharding.py: placement must resolve "
                            "from the partition-rule table (spec_of, "
                            "param_specs, state_specs, or a helper there); "
                            "a second spec owner drifts from the table")


# -- TX006 --------------------------------------------------------------------

_HOST_CONSTANTS = ("torch.tensor", "torch.as_tensor", "torch.from_numpy")
_PINNED_OBJECTS = ("torch.cuda.Event", "torch.cuda.Stream")


@register
class TX006HostStateInCapture(Rule):
    id = "TX006"
    title = ("inside captured code: a host-made constant, a float64 "
             "widening, an int-tensor x python-float promotion, or a "
             "pinned allocation/Event/Stream made in the body")
    guards = ("a garbage collection inside a CUDA-graph capture freed "
              "pinned host memory and invalidated the capture (CUDA error "
              "901 on the card; graphs.py now pauses the collector): what "
              "a captured body allocates on the host or bakes in from it "
              "outlives the capture only by accident.  Host constants, "
              "float64 subgraphs and python-float promotions are JX006's "
              "trace-time hazards in capture form; graftflow's call-graph "
              "closure over the capture seeds decides which helpers the "
              "graph records")

    def run(self, project: Project) -> Iterator[Finding]:
        from deeprest_tpu_torch.analysis.dataflow import ValueFlow

        scope = captured_scope(project)
        if not scope.ids:
            return
        flow = ValueFlow.of(project)
        seen: set[tuple] = set()

        def emit(sf, node, message):
            dk = (sf.rel, getattr(node, "lineno", 0),
                  getattr(node, "col_offset", 0), message[:40])
            if dk in seen:
                return None
            seen.add(dk)
            return sf.finding(node, self.id, message)

        for sf in project.files:
            if sf.rel not in scope.ids or sf.tree is None:
                continue
            for node in sf.walk():
                if not isinstance(node, ast.Call) or \
                        not scope.contains(sf, node):
                    continue
                name = call_name(node.func)
                msg = None
                if name in _HOST_CONSTANTS:
                    msg = (f"{name}(...) inside captured code: a tensor made "
                           "from host data at capture time is baked into "
                           "the graph (and its host-to-device copy is not "
                           "replayed); stage it in a static buffer outside "
                           "the capture")
                elif name in _PINNED_OBJECTS:
                    msg = (f"{name}() made inside captured code: its host "
                           "object lives past the capture only by accident "
                           "(the fault that gave CUDA error 901); make it "
                           "once, outside the body")
                elif any(k.arg == "pin_memory" and isinstance(
                        k.value, ast.Constant) and k.value.value is True
                        for k in node.keywords):
                    msg = ("pin_memory=True allocation inside captured "
                           "code: pinned host memory freed while a graph "
                           "captures invalidates it (CUDA error 901); "
                           "allocate the pinned buffer outside the body")
                if msg is not None:
                    f = emit(sf, node, msg)
                    if f is not None:
                        yield f
        for c in flow.np_calls:
            sf = project.by_rel[c.rel]
            if c.has_dtype or not scope.contains(sf, c.node):
                continue
            f = emit(sf, c.node,
                     f"{c.dotted}(...) without an explicit dtype inside "
                     "captured code bakes a float64-defaulting host "
                     "constant into the graph; make it a static device "
                     "buffer with an explicit dtype")
            if f is not None:
                yield f
        for cast in flow.f64_casts:
            sf = project.by_rel[cast.rel]
            if not scope.contains(sf, cast.node):
                continue
            f = emit(sf, cast.node,
                     f"explicit float64 widening ({cast.why}) inside "
                     "captured code: the plane computes in f32/bf16 with a "
                     "pinned parity envelope — an f64 subgraph re-rounds "
                     "everything it touches")
            if f is not None:
                yield f
        for p in flow.promotions:
            sf = project.by_rel[p.rel]
            if not scope.contains(sf, p.node):
                continue
            if "f64" in (p.left, p.right):
                msg = (f"{p.left} x {p.right} promotion inside captured "
                       "code: the float64 side infects the whole "
                       "expression")
            else:
                msg = ("integer tensor x python-float promotion inside "
                       "captured code: call-path counts are natively "
                       "integers — a bare float constant silently floats "
                       "them; make the cast explicit (.float()/.to) so "
                       "the rounding is deliberate")
            f = emit(sf, p.node, msg)
            if f is not None:
                yield f
