"""The captured code of a project: what CUDA-graph capture and
``torch.compile`` run, shared by the rule packs and the value-flow engine.

The seeds are the bodies handed to ``graphs.capture``, ``capture_update``
and ``RungGraphs.run``, ``with torch.cuda.graph(...)`` blocks,
``torch.cuda.make_graphed_callables`` and ``torch.compile``; the scope is
every function those reach through the call graph.  The TX pack
(``rules_torch.py``) ranges over it, JX007 takes it as a second set of entry
points, and graftflow (``dataflow.py``) analyzes the nested bodies handed to
a capture in their enclosing environment.
"""

from __future__ import annotations

import ast
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    FuncKey, Project, SourceFile, call_name,
)

# Identifiers that, in this codebase, always name device-resident model
# state (trained parameters, optimizer state, weights).
_PARAMISH = ("param", "params", "state", "weight", "weights", "theta")


def name_is_paramish(name: str) -> bool:
    parts = name.lower().strip("_").split("_")
    return any(p in _PARAMISH for p in parts)


def in_scope(sf: SourceFile, node: ast.AST, scope_ids: set[int]) -> bool:
    """``node`` is one of ``scope_ids`` or lies inside one."""
    if id(node) in scope_ids:
        return True
    return any(id(a) in scope_ids for a in sf.ancestors(node))


_CAPTURE_FNS = ("capture", "capture_update")
_COMPILE_NAMES = ("torch.compile", "torch.cuda.make_graphed_callables")
_GRAPH_CTX = ("torch.cuda.graph",)


def context(sf: SourceFile, node: ast.AST) -> tuple[str | None, str, list]:
    """``(class, self name, enclosing function nodes innermost first)`` of
    ``node``; a method counts as enclosing itself."""
    fns, cls, self_name = [], None, ""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
            isinstance(sf.parents().get(node), ast.ClassDef):
        fns.append(node)
    for anc in sf.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            fns.append(anc)
        elif isinstance(anc, ast.ClassDef):
            cls = anc.name
            break
    if cls is not None:
        methods = [f for f in fns if isinstance(f, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef))]
        if methods and methods[-1].args.args:
            self_name = methods[-1].args.args[0].arg
    return cls, self_name, fns


def graphs_receiver(call: ast.Call) -> str | None:
    """``R`` of a ``R.run(...)`` whose receiver names a graphs holder
    (``self.graphs``, ``self._graphs``, ``plane.graphs``)."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "run"):
        return None
    recv = call_name(fn.value)
    if recv is None or "graphs" not in recv.rsplit(".", 1)[-1].lower():
        return None
    return recv


def is_capture_call(project: Project, sf: SourceFile,
                    call: ast.Call) -> bool:
    """``graphs.capture(body, ...)`` / ``capture_update(body, ...)``: by
    name, unless the call graph resolves it to a function outside a
    ``graphs.py`` (``obs/profiler.capture`` is not a graph capture)."""
    name = call_name(call.func)
    if name is None or name.rsplit(".", 1)[-1] not in _CAPTURE_FNS:
        return False
    cls, self_name, _ = context(sf, call)
    hit = project.call_graph().resolve_call(sf.rel, cls, self_name, call)
    return hit is None or hit.rel.replace("\\", "/").endswith("graphs.py")


def _arg(call: ast.Call, pos: int, kw: str) -> ast.AST | None:
    if len(call.args) > pos:
        return call.args[pos]
    return next((k.value for k in call.keywords if k.arg == kw), None)


def capture_sites(project: Project, sf: SourceFile
                  ) -> Iterator[tuple[ast.AST, ast.AST | None, str]]:
    """Every capture construct in ``sf``: ``(site, the callable handed to
    it or None, kind)``; kind is "capture", "run", "compile", "graph" (a
    ``with torch.cuda.graph`` block, the site being the With) or
    "decorator" (``@torch.compile`` on a def, the site being the def)."""
    if sf.tree is None:
        return
    for node in sf.walk():
        if isinstance(node, ast.Call):
            name = call_name(node.func)
            if is_capture_call(project, sf, node):
                yield node, _arg(node, 0, "body"), "capture"
            elif graphs_receiver(node) is not None:
                yield node, _arg(node, 1, "fn"), "run"
            elif name in _COMPILE_NAMES:
                yield node, _arg(node, 0, "model"), "compile"
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call) and \
                        call_name(expr.func) in _GRAPH_CTX:
                    yield node, None, "graph"
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if call_name(target) == "torch.compile":
                    yield node, node, "decorator"


class CapturedScope:
    """The captured code of a project: ``ids`` maps each file to the ids
    of the captured function nodes, lambdas and ``torch.cuda.graph``
    blocks in it; ``keys`` are the call-graph functions among them;
    ``bodies`` the nested defs and lambdas handed to a capture directly
    (graftflow analyzes those bodies too)."""

    def __init__(self, project: Project):
        self.project = project
        self.graph = project.call_graph()
        self.ids: dict[str, set[int]] = {}
        self.keys: set[FuncKey] = set()
        self.bodies: set[int] = set()
        self._node_key = {id(n): k for k, n in self.graph.functions.items()}
        self._methods: dict[str, list[FuncKey]] = {}
        self._bases: dict[str, set[str]] = {}
        for key in self.graph.functions:
            if key.cls is not None:
                self._methods.setdefault(key.name, []).append(key)
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in sf.tree.body:
                if isinstance(node, ast.ClassDef):
                    self._bases.setdefault(node.name, set()).update(
                        name.rsplit(".", 1)[-1]
                        for name in map(call_name, node.bases) if name)
        seeds: set[FuncKey] = set()
        for sf in project.files:
            for site, target, kind in capture_sites(project, sf):
                if kind == "graph":
                    self._add(sf.rel, site)
                    seeds |= self._calls_in(sf, site)
                elif target is not None:
                    seeds |= self._resolve(sf, site, target, depth=0)
        for key in self.graph.reachable(seeds):
            node = self.graph.function_node(key)
            if node is not None:
                self.keys.add(key)
                self._add(key.rel, node)

    @classmethod
    def of(cls, project: Project) -> "CapturedScope":
        cached = project.__dict__.get("_captured_scope")
        if cached is None:
            cached = project.__dict__["_captured_scope"] = cls(project)
        return cached

    def _subclasses(self, cls: str) -> set[str]:
        """The project's classes that derive from ``cls``, transitively
        (by class name)."""
        out, frontier = set(), [cls]
        while frontier:
            base = frontier.pop()
            for name, bases in self._bases.items():
                if base in bases and name not in out:
                    out.add(name)
                    frontier.append(name)
        return out

    def family(self, cls: str) -> set[str]:
        """``cls`` with its subclasses and its base classes in the
        project, transitively."""
        out, frontier = {cls} | self._subclasses(cls), [cls]
        while frontier:
            for base in self._bases.get(frontier.pop(), ()):
                if base in self._bases and base not in out:
                    out.add(base)
                    frontier.append(base)
        return out

    def contains(self, sf: SourceFile, node: ast.AST) -> bool:
        ids = self.ids.get(sf.rel)
        return bool(ids) and in_scope(sf, node, ids)

    # -- seed resolution ---------------------------------------------------

    def _add(self, rel: str, node: ast.AST) -> None:
        self.ids.setdefault(rel, set()).add(id(node))

    def _calls_in(self, sf: SourceFile, body: ast.AST) -> set[FuncKey]:
        """The functions the calls in a nested body resolve to; a method
        call on a receiver the graph cannot type resolves when exactly one
        class of the project defines that method."""
        cls, self_name, _ = context(sf, body)
        out: set[FuncKey] = set()
        for sub in ast.walk(body):
            if not isinstance(sub, ast.Call):
                continue
            hit = self.graph.resolve_call(sf.rel, cls, self_name, sub)
            if hit is None and isinstance(sub.func, ast.Attribute):
                owners = self._methods.get(sub.func.attr, [])
                if len(owners) == 1:
                    hit = owners[0]
            if hit is not None:
                out.add(hit)
        return out

    def _overrides(self, key: FuncKey) -> set[FuncKey]:
        """``key`` and the same method of every subclass in the project: a
        ``self._apply`` of a base class runs a subclass's."""
        subclasses = self._subclasses(key.cls)
        return {key} | {k for k in self._methods.get(key.name, [])
                        if k.cls in subclasses}

    def _resolve(self, sf: SourceFile, site: ast.AST, target: ast.AST,
                 depth: int) -> set[FuncKey]:
        """Seeds for the callable ``target`` handed to a capture at
        ``site``; nested bodies go into the scope directly."""
        cls, self_name, fns = context(sf, site)
        if isinstance(target, ast.Call) and call_name(target.func) in (
                "partial", "functools.partial") and target.args:
            return self._resolve(sf, site, target.args[0], depth)
        if isinstance(target, (ast.Lambda, ast.FunctionDef,
                               ast.AsyncFunctionDef)):
            key = self._node_key.get(id(target))
            if key is not None:
                return self._overrides(key)
            self._add(sf.rel, target)
            self.bodies.add(id(target))
            return self._calls_in(sf, target)
        if isinstance(target, ast.Name):
            for scope in fns:
                body = scope.body if isinstance(scope.body, list) else []
                for node in body:
                    for sub in ast.walk(node):
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)) \
                                and sub.name == target.id:
                            return self._resolve(sf, site, sub, depth)
                        if isinstance(sub, ast.Assign) and isinstance(
                                sub.value, ast.Lambda) and any(
                                    isinstance(t, ast.Name)
                                    and t.id == target.id
                                    for t in sub.targets):
                            return self._resolve(sf, site, sub.value, depth)
                args = getattr(scope, "args", None)
                names = [] if args is None else [
                    a.arg for a in list(args.posonlyargs) + list(args.args)
                    + list(args.kwonlyargs)]
                if target.id in names:
                    return self._through_callers(sf, scope, target.id,
                                                 depth)
            fake = ast.Call(func=target, args=[], keywords=[])
            hit = self.graph.resolve_call(sf.rel, cls, self_name, fake)
            return set() if hit is None else {hit}
        if isinstance(target, ast.Attribute):
            fake = ast.Call(func=target, args=[], keywords=[])
            key = self.graph.resolve_call(sf.rel, cls, self_name, fake)
            if key is not None:
                return (self._overrides(key) if key.cls is not None
                        else {key})
            owners = self._methods.get(target.attr, [])
            if len(owners) == 1:
                return set(owners)
        return set()

    def _through_callers(self, sf: SourceFile, fn: ast.AST, param: str,
                         depth: int) -> set[FuncKey]:
        """A callable that reaches the capture as parameter ``param`` of
        ``fn``: whatever each resolved call site of ``fn`` passes there."""
        key = self._node_key.get(id(fn))
        if key is None or depth >= 2:
            return set()
        args = fn.args
        names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
        out: set[FuncKey] = set()
        for caller in self.project.files:
            if caller.tree is None:
                continue
            for call in caller.walk():
                if not isinstance(call, ast.Call):
                    continue
                c_cls, c_self, _ = context(caller, call)
                if self.graph.resolve_call(caller.rel, c_cls, c_self,
                                           call) != key:
                    continue
                offset = 1 if key.cls is not None and isinstance(
                    call.func, ast.Attribute) else 0
                passed = next((k.value for k in call.keywords
                               if k.arg == param), None)
                if passed is None and param in names:
                    pos = names.index(param) - offset
                    if 0 <= pos < len(call.args):
                        passed = call.args[pos]
                if passed is not None:
                    out |= self._resolve(caller, call, passed, depth + 1)
        return out


def captured_scope(project: Project) -> CapturedScope:
    return CapturedScope.of(project)
