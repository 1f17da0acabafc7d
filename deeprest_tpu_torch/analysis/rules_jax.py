"""Rule pack JX: JAX compile / readback / donation invariants.

Each rule encodes a bug class this repo has already paid for by hand:

- JX001 — the JAX package once spent days on a 1-ulp drift traced to
  ``jax.jit`` closure captures: params baked as compile-time constants
  let XLA constant-fold parameter subgraphs with its compile-time
  evaluator, whose rounding differs from the runtime kernels
  (serve/fused.py module docstring).  Params must be ARGUMENTS of the
  jitted function.
- JX002 — the serving layer's original shape recompiled per ragged
  batch; a ``jax.jit`` in a loop body (or a fresh lambda jitted per
  call, or data-derived ``static_argnums``) rebuilds executables the
  shape ladder exists to bound (serve/batcher.py).
- JX003 — the early serving and training work repeatedly hunted
  implicit device→host readbacks (``.item()`` / ``float()`` /
  ``np.asarray`` on jit outputs) hiding in hot loops; each one is a
  pipeline stall.  Scoped to the named hot modules so host-side ETL code
  can use numpy freely.
- JX004 — ``donate_argnums`` invalidates the donated buffer; reading the
  Python reference afterwards returns garbage or raises at dispatch
  (train/trainer.py donates the train state at every step).
- JX005 — the sharding-table change deleted the trainer's hand-pinned
  per-leaf spec dict in favor of the ONE regex partition-rule table
  (parallel/sharding.PARTITION_RULES); a ``NamedSharding(mesh, P(...))``
  literal anywhere else re-creates the two-owners drift that table
  exists to kill (train pinned F on ``model`` while serve replicated it
  — the ROADMAP item 4 hazard).

In the port these rules keep the JAX package's ids, titles, incidents and
detection.  They match source text and import no JAX.  JX003, JX007 and
QT001 read torch code as written: ``.item()``, ``float()``, ``bool()`` and
``np.asarray`` in a loop of a hot module are the same host syncs on a CUDA
tensor, and an int8 value meeting float math is the same hazard.  JX007
and QT001 ride graftflow, whose lattice knows torch's device values, host
syncs and ``torch.int8`` beside ``jnp.*``/``jax.*`` and numpy's
(``dataflow.py``); JX007 also takes the port's captured code
(``captured.captured_scope``) as entry points, where any host sync
fails the capture.  JX001, JX002, JX004, JX005 and JX006 match only
``jax.jit``/``pjit`` sites and ``NamedSharding``, so they find nothing in
torch code; the TX pack (``rules_torch.py``) is their counterpart on
CUDA-graph captures and ``torch.compile``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    Finding, Project, Rule, SourceFile, call_name, enclosing_function_scopes,
    in_loop, is_jit_call, register, scope_bound_names, walk_no_nested_scopes,
)
from deeprest_tpu_torch.analysis.captured import (
    captured_scope, in_scope, name_is_paramish,
)

def _jitted_functions(sf: SourceFile) -> list[tuple[ast.AST, ast.AST]]:
    """Every function handed to jax.jit/pjit in this file, with the call
    (or decorator) node it was handed at: ``[(fn_node, site), ...]``.

    Resolves ``jax.jit(f)`` where f is a lambda, a local ``def``, or a
    ``self.method`` of the enclosing class; plus ``@jax.jit`` /
    ``@partial(jax.jit, ...)`` decorators.
    """
    if sf.tree is None:
        return []
    out: list[tuple[ast.AST, ast.AST]] = []

    def resolve(target: ast.AST, site: ast.Call) -> None:
        if isinstance(target, ast.Lambda):
            out.append((target, site))
            return
        if isinstance(target, ast.Name):
            # nearest enclosing body with `def name` or `name = lambda`
            scopes = [a for a in sf.ancestors(site)
                      if isinstance(a, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Module))]
            for scope in scopes:
                for node in ast.walk(scope):
                    if (isinstance(node, ast.FunctionDef)
                            and node.name == target.id):
                        out.append((node, site))
                        return
                    if (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Lambda)
                            and any(isinstance(t, ast.Name)
                                    and t.id == target.id
                                    for t in node.targets)):
                        out.append((node.value, site))
                        return
            return
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            cls = next((a for a in sf.ancestors(site)
                        if isinstance(a, ast.ClassDef)), None)
            if cls is not None:
                for node in cls.body:
                    if (isinstance(node, ast.FunctionDef)
                            and node.name == target.attr):
                        out.append((node, site))
                        return

    for node in sf.walk():
        if isinstance(node, ast.Call) and is_jit_call(node) and node.args:
            resolve(node.args[0], node)
        elif isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                if (isinstance(dec, (ast.Name, ast.Attribute))
                        and call_name(dec) in ("jax.jit", "jit", "pjit")):
                    out.append((node, dec))
                elif isinstance(dec, ast.Call):
                    if is_jit_call(dec):
                        out.append((node, dec))
                    elif (call_name(dec.func) in ("partial",
                                                  "functools.partial")
                          and dec.args
                          and isinstance(dec.args[0],
                                         (ast.Name, ast.Attribute))
                          and call_name(dec.args[0]) in ("jax.jit", "jit",
                                                         "pjit")):
                        out.append((node, dec))
    return out


@register
class JX001ClosureCapturedParams(Rule):
    id = "JX001"
    title = ("function handed to jax.jit closure-captures device state "
             "(params/weights/state) instead of taking it as an argument")
    guards = ("mask-drift fix: XLA constant-folded closure-captured "
              "params into a differently-rounding mask subgraph (1-ulp "
              "drift vs the runtime kernels); params must thread "
              "through jit as runtime ARGUMENTS — serve/fused.py "
              "numerics contract")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            for fn, _site in _jitted_functions(sf):
                own = scope_bound_names(fn)
                yield from self._scan(sf, fn, own, outer=[])

    def _scan(self, sf: SourceFile, fn: ast.AST, own: set[str],
              outer: list[set[str]]) -> Iterator[Finding]:
        scopes = enclosing_function_scopes(sf, fn)
        outer_all = [scope_bound_names(s) for s in scopes] + outer
        # Local helper FUNCTIONS captured from an enclosing scope are
        # static callables, not device state, whatever their name says
        # (e.g. trainer.py's `pin_state`).
        callables: set[str] = set()
        for s in scopes:
            body = s.body if isinstance(s.body, list) else [s.body]
            for node in body:
                for sub in ast.walk(node):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        callables.add(sub.name)
                    elif (isinstance(sub, ast.Assign)
                          and isinstance(sub.value, ast.Lambda)):
                        callables.update(
                            t.id for t in sub.targets
                            if isinstance(t, ast.Name))

        def is_closure(name: str) -> bool:
            return (name not in own and name not in callables
                    and any(name in scope for scope in outer_all))

        body = fn.body if isinstance(fn.body, list) else [fn.body]
        stack = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # nested scope: closure set grows by this fn's own names
                inner = scope_bound_names(node)
                yield from self._scan(sf, node, inner, [own] + outer_all)
                continue
            hit: ast.AST | None = None
            why = ""
            if (isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load)
                    and name_is_paramish(node.id)
                    and is_closure(node.id)):
                hit, why = node, f"closure variable {node.id!r}"
            elif isinstance(node, ast.Attribute):
                chain, base = [node.attr], node.value
                while isinstance(base, ast.Attribute):
                    chain.append(base.attr)
                    base = base.value
                if (isinstance(base, ast.Name) and base.id != "self"
                        and is_closure(base.id)
                        and any(name_is_paramish(a) for a in chain)):
                    dotted = ".".join([base.id] + list(reversed(chain)))
                    hit, why = node, f"closure attribute chain {dotted!r}"
                    # don't also report the chain's inner Attribute nodes
                    stack.extend(n for n in ast.iter_child_nodes(base))
                    if hit is not None:
                        yield sf.finding(hit, self.id, self._msg(why))
                    continue
            if hit is not None:
                yield sf.finding(hit, self.id, self._msg(why))
            stack.extend(ast.iter_child_nodes(node))

    def _msg(self, why: str) -> str:
        return (f"jit-compiled function captures {why}: XLA bakes it as a "
                "compile-time constant and may constant-fold its subgraph "
                "with different rounding than the runtime kernels (the "
                "mask-drift fix bug class); pass it as a function argument "
                "instead")


@register
class JX002RecompileHazard(Rule):
    id = "JX002"
    title = ("recompile hazard: jax.jit in a loop body, a fresh "
             "lambda/local def jitted per call, or non-literal "
             "static_argnums/static_argnames")
    guards = ("the pre-ladder serving path compiled one executable per "
              "ragged batch shape; serve/batcher.py's whole design bounds "
              "the jit cache to fixed rungs — a jit in a loop (or a fresh "
              "lambda per call) rebuilds that unbounded cache")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            for node in sf.walk():
                if not (isinstance(node, ast.Call) and is_jit_call(node)):
                    continue
                if in_loop(sf, node):
                    yield sf.finding(
                        node, self.id,
                        "jax.jit called inside a loop body: every "
                        "iteration re-wraps (and may re-trace/compile) "
                        "the function; hoist the jit out of the loop")
                parent = sf.parents().get(node)
                if (isinstance(parent, ast.Call) and parent.func is node
                        and node.args
                        and isinstance(node.args[0], ast.Lambda)):
                    yield sf.finding(
                        node, self.id,
                        "jit(lambda ...)(...) jits a FRESH lambda at every "
                        "call of the enclosing function, so the jit cache "
                        "never hits; bind the jitted callable once and "
                        "reuse it")
                for kw in node.keywords:
                    if kw.arg not in ("static_argnums", "static_argnames"):
                        continue
                    if not self._literal(kw.value):
                        yield sf.finding(
                            kw.value, self.id,
                            f"{kw.arg} is not a literal constant: "
                            "data-derived or unhashable static arguments "
                            "make every call a potential retrace/compile")

    @staticmethod
    def _literal(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, (ast.Tuple, ast.List)):
            return all(isinstance(e, ast.Constant) for e in node.elts)
        return False


@register
class JX003ReadbackInHotLoop(Rule):
    id = "JX003"
    title = ("implicit device→host readback (.item()/float()/bool()/"
             "np.asarray) inside a loop in a hot module")
    guards = ("early readback fixes each removed "
              "per-iteration host syncs from the train/infer hot paths "
              "(epoch-mean stacking, device-scalar eval accumulation, "
              "the fused engine's no-readback carry); "
              "this rule keeps new ones out")

    # Modules where a per-iteration sync is a measured pipeline stall.
    # Round 11 widened the watchlist from three named files to WHOLE
    # package directories: the coalesced recurrence paths put hot device
    # loops across ops/ and serve/, and a new module under either would
    # silently dodge a name list.  Host-side ETL
    # (data/, workload/) stays exempt — numpy there is the design.
    HOT_SUFFIXES = ("train/trainer.py",)
    HOT_DIRS = ("ops", "serve")

    def _is_hot(self, rel: str) -> bool:
        # rel is lint-root-relative ("serve/predictor.py" when linting the
        # package dir, "deeprest_tpu_torch/serve/predictor.py" from a repo
        # root), so match DIRECTORY COMPONENTS, not string prefixes.
        parts = rel.replace("\\", "/").split("/")
        return (rel.endswith(self.HOT_SUFFIXES)
                or any(d in parts[:-1] for d in self.HOT_DIRS))

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for node in sf.walk():
                if not isinstance(node, ast.Call):
                    continue
                kind = self._readback_kind(node)
                if kind is None or not in_loop(sf, node):
                    continue
                yield sf.finding(
                    node, self.id,
                    f"{kind} inside a loop in a hot module forces a "
                    "device→host sync every iteration; accumulate on "
                    "device (or stack once after the loop), or suppress "
                    "with a reason if this readback is the designed sink")

    @staticmethod
    def _readback_kind(call: ast.Call) -> str | None:
        name = call_name(call.func)
        if (isinstance(call.func, ast.Attribute) and call.func.attr == "item"
                and not call.args):
            return ".item()"
        if name in ("float", "bool") and call.args and not isinstance(
                call.args[0], ast.Constant):
            return f"{name}()"
        if name in ("np.asarray", "numpy.asarray", "np.array",
                    "numpy.array"):
            return f"{name}()"
        return None


@register
class JX005HandPinnedShardingSpec(Rule):
    id = "JX005"
    title = ("NamedSharding constructed outside parallel/sharding.py "
             "(hand-pinned partition spec bypassing the rule table)")
    guards = ("sharding-table fix: pin_state's per-leaf spec dict "
              "and serve's implicit replication were two divergent "
              "owners of the same placement decisions; every sharding "
              "now resolves from "
              "parallel/sharding.PARTITION_RULES, and an ad-hoc "
              "NamedSharding literal elsewhere silently re-forks that "
              "ownership (suppress with a reason only for the designed "
              "batch/plan FEED sites, which place inputs, not state)")

    # The single module allowed to construct NamedSharding: the owner of
    # the partition-rule table.  Matched on path components so both
    # package-dir and repo-root lint invocations resolve it.
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
                if call_name(node.func) not in (
                        "NamedSharding", "jax.sharding.NamedSharding",
                        "sharding.NamedSharding"):
                    continue
                yield sf.finding(
                    node, self.id,
                    "NamedSharding literal outside parallel/sharding.py: "
                    "state placement must resolve from the partition-rule "
                    "table (state_sharding/param_sharding/batch_sharding); "
                    "a second spec owner is how train and serve shardings "
                    "drift apart")


@register
class JX004UseAfterDonation(Rule):
    id = "JX004"
    title = ("argument read again after being passed to a "
             "donate_argnums-jitted callable")
    guards = ("train/trainer.py donates the whole TrainState buffer at "
              "every compiled step (donate_argnums=0); reading the stale "
              "Python reference afterwards observes an invalidated buffer")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            donated = self._donated_callables(sf)
            if not donated:
                continue
            for node in sf.walk():
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_function(sf, node, donated)

    @staticmethod
    def _donate_positions(call: ast.Call) -> set[int] | None:
        for kw in call.keywords:
            if kw.arg != "donate_argnums":
                continue
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return {v.value}
            if isinstance(v, (ast.Tuple, ast.List)):
                pos = set()
                for e in v.elts:
                    if isinstance(e, ast.Constant) and isinstance(e.value,
                                                                  int):
                        pos.add(e.value)
                return pos
        return None

    def _donated_callables(self, sf: SourceFile) -> dict[str, set[int]]:
        """``{dotted_callable_name: donated_positions}`` for every
        ``X = jax.jit(fn, donate_argnums=...)`` in the file."""
        out: dict[str, set[int]] = {}
        for node in sf.walk():
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and is_jit_call(node.value)):
                continue
            pos = self._donate_positions(node.value)
            if not pos:
                continue
            for t in node.targets:
                name = call_name(t)
                if name:
                    out[name] = pos
        return out

    def _check_function(self, sf: SourceFile, fn: ast.FunctionDef,
                        donated: dict[str, set[int]]):
        # local aliases: `run = self._train_step` or a trivial lambda
        # wrapper forwarding its own params into a donated position
        aliases = dict(donated)
        for node in walk_no_nested_scopes(fn):
            if not (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                continue
            tgt = node.targets[0].id
            src = call_name(node.value)
            if src in aliases:
                aliases[tgt] = aliases[src]
            elif isinstance(node.value, ast.Lambda):
                body = node.value.body
                if isinstance(body, ast.Call):
                    inner = call_name(body.func)
                    if inner in aliases:
                        largs = [a.arg for a in node.value.args.args]
                        fwd = set()
                        for p in aliases[inner]:
                            if (p < len(body.args)
                                    and isinstance(body.args[p], ast.Name)
                                    and body.args[p].id in largs):
                                fwd.add(largs.index(body.args[p].id))
                        if fwd:
                            aliases[tgt] = fwd

        dead: dict[str, int] = {}       # name -> donation line

        def binds(stmt: ast.stmt, name: str) -> bool:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name) and n.id == name:
                            return True
            if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                t = stmt.target
                return isinstance(t, ast.Name) and t.id == name
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                return any(isinstance(n, ast.Name) and n.id == name
                           for n in ast.walk(stmt.target))
            return False

        findings = []

        def scan_exprs(stmt: ast.stmt, roots: list[ast.AST]) -> None:
            """Reads-then-donations over the given expression subtrees;
            a name donated AND rebound by the same statement (the
            canonical ``state, loss = step(state, ...)``) stays live."""
            for root in roots:
                for n in ast.walk(root):
                    if (isinstance(n, ast.Name)
                            and isinstance(n.ctx, ast.Load)
                            and n.id in dead):
                        findings.append(sf.finding(
                            n, self.id,
                            f"{n.id!r} was donated to a jit-compiled "
                            f"callable (donate_argnums) on line "
                            f"{dead[n.id]} and is read again here: the "
                            "buffer may already be invalidated; rebind "
                            "the name to the call's result or pass a "
                            "copy"))
                        del dead[n.id]            # report once per name
            for root in roots:
                for n in ast.walk(root):
                    if isinstance(n, ast.Call):
                        cname = call_name(n.func)
                        if cname in aliases:
                            for p in aliases[cname]:
                                if (p < len(n.args)
                                        and isinstance(n.args[p], ast.Name)
                                        and not binds(stmt, n.args[p].id)):
                                    dead[n.args[p].id] = n.lineno
            for name in list(dead):
                if binds(stmt, name):
                    del dead[name]

        def visit_block(body: list[ast.stmt]) -> None:
            for stmt in body:
                blocks = [getattr(stmt, f) for f in
                          ("body", "orelse", "finalbody")
                          if isinstance(getattr(stmt, f, None), list)]
                for h in getattr(stmt, "handlers", None) or []:
                    blocks.append(h.body)
                if blocks and not isinstance(
                        stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                    headers = [x for x in (
                        getattr(stmt, "test", None),
                        getattr(stmt, "iter", None),
                        *(i.context_expr for i in
                          getattr(stmt, "items", []) or []),
                    ) if x is not None]
                    scan_exprs(stmt, headers)
                    for b in blocks:
                        visit_block(b)
                elif not isinstance(
                        stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                    scan_exprs(stmt, [stmt])

        visit_block(fn.body)
        yield from findings


# -- graftflow-powered rules (round 19) -------------------------------------
#
# JX006/JX007 consume the value-flow engine (analysis/dataflow.py): the
# same facts DN002 uses — dtype lattice, host/device domain, and the
# call-graph reachability that lets a rule range beyond a syntactic
# per-file watchlist without drowning in false positives.


def _jit_scope_nodes(project: Project) -> dict[str, set[int]]:
    """``{rel: {id(fn_node), ...}}`` of every function body that is
    jit-traced: functions handed to jax.jit/pjit in each file, plus
    every project function reachable from one through the call graph
    (tracing inlines callees, so their bodies compile too)."""
    graph = project.call_graph()
    node_to_key = {id(n): k for k, n in graph.functions.items()}
    scopes: dict[str, set[int]] = {}
    seeds = []
    for sf in project.files:
        ids = scopes.setdefault(sf.rel, set())
        for fn, _site in _jitted_functions(sf):
            ids.add(id(fn))
            key = node_to_key.get(id(fn))
            if key is not None:
                seeds.append(key)
                continue
            # nested jitted defs/lambdas are not call-graph nodes; seed
            # the closure from the calls their bodies resolve instead
            cls = next((a.name for a in sf.ancestors(fn)
                        if isinstance(a, ast.ClassDef)), None)
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    hit = graph.resolve_call(sf.rel, cls, "", sub)
                    if hit is not None:
                        seeds.append(hit)
    for key in project.call_graph().reachable(seeds):
        node = graph.function_node(key)
        if node is not None:
            scopes.setdefault(key.rel, set()).add(id(node))
    return scopes


@register
class JX006DtypePromotionInJit(Rule):
    id = "JX006"
    title = ("dtype-promotion hazard inside jit-traced code: an np.* "
             "f64-defaulting host constant, an explicit float64 "
             "widening, or an int-array x python-float promotion")
    guards = ("mask-drift fix's pin_state drift was a compile-time "
              "constant whose rounding differed from the runtime "
              "kernels; np/jnp mixing inside traced code is the same "
              "class — np.zeros "
              "defaults to float64 (silently upcasting the f32/bf16 plane "
              "under x64, or re-rounding through f64 otherwise), and "
              "call-path counts are natively integers, so a bare "
              "python-float constant op silently floats them.  graftflow "
              "proves which functions the jit trace actually reaches "
              "(call-graph closure over the jitted seeds), so the rule "
              "ranges over helpers the syntactic packs cannot see")

    def run(self, project: Project) -> Iterator[Finding]:
        from deeprest_tpu_torch.analysis.dataflow import ValueFlow

        flow = ValueFlow.of(project)
        scopes = _jit_scope_nodes(project)
        seen: set[tuple] = set()

        def emit(rel: str, node: ast.AST, message: str):
            sf = project.by_rel.get(rel)
            if sf is None:
                return None
            dk = (rel, getattr(node, "lineno", 0),
                  getattr(node, "col_offset", 0), message[:40])
            if dk in seen:
                return None
            seen.add(dk)
            return sf.finding(node, self.id, message)

        for c in flow.np_calls:
            ids = scopes.get(c.rel)
            if not ids or c.has_dtype:
                continue
            sf = project.by_rel[c.rel]
            if not in_scope(sf, c.node, ids):
                continue
            f = emit(c.rel, c.node,
                     f"{c.dotted}(...) without an explicit dtype inside "
                     "jit-traced code bakes a float64-defaulting host "
                     "constant into the trace: it silently upcasts the "
                     "f32/bf16 plane (or re-rounds through f64); use "
                     "jnp here, or pass an explicit dtype")
            if f is not None:
                yield f
        for cast in flow.f64_casts:
            ids = scopes.get(cast.rel)
            if not ids:
                continue
            sf = project.by_rel[cast.rel]
            if not in_scope(sf, cast.node, ids):
                continue
            f = emit(cast.rel, cast.node,
                     f"explicit float64 widening ({cast.why}) inside "
                     "jit-traced code: the plane computes in f32/bf16 "
                     "with a pinned parity envelope — an f64 subgraph "
                     "re-rounds everything it touches")
            if f is not None:
                yield f
        for p in flow.promotions:
            ids = scopes.get(p.rel)
            if not ids:
                continue
            sf = project.by_rel[p.rel]
            if not in_scope(sf, p.node, ids):
                continue
            if "f64" in (p.left, p.right):
                msg = (f"{p.left} x {p.right} promotion inside "
                       "jit-traced code: the float64 side infects the "
                       "whole expression (np default-dtype leak — keep "
                       "traced math in jnp/f32)")
            else:
                msg = ("integer array x python-float promotion inside "
                       "jit-traced code: call-path counts are natively "
                       "integers — a bare float constant silently "
                       "floats them; make the cast explicit "
                       "(.astype/jnp.float32) so the rounding is "
                       "deliberate")
            f = emit(p.rel, p.node, msg)
            if f is not None:
                yield f


@register
class JX007TransitiveHostDeviceCrossing(Rule):
    id = "JX007"
    title = ("host/device domain crossing (.item()/float()/np.asarray) "
             "in a loop, in code reached transitively from the trainer/"
             "fused/batcher entry points, on a value graftflow proves "
             "is a device array")
    guards = ("early readback fixes hand-hunted "
              "per-iteration device→host syncs; JX003 guards them "
              "syntactically but only inside its directory watchlist "
              "(ops/, serve/, train/trainer.py).  "
              "The coalesced recurrence paths and checkpoint/stream "
              "helpers sit OUTSIDE that list yet run inside the hot "
              "loops — JX007 replaces the per-file heuristic with "
              "call-graph reachability from the trainer/fused/batcher "
              "entry points and fires only when the engine PROVES the "
              "converted value lives on device, so host-side numpy "
              "plumbing stays silent without a watchlist exemption")

    # entry points of the hot planes; reachability (not directory
    # membership) decides what is hot
    ENTRY_SUFFIXES = (("train", "trainer.py"), ("serve", "fused.py"),
                      ("serve", "batcher.py"))

    @classmethod
    def _is_entry_rel(cls, rel: str) -> bool:
        parts = tuple(rel.replace("\\", "/").split("/"))
        return any(parts[-len(s):] == s for s in cls.ENTRY_SUFFIXES
                   if len(parts) >= len(s))

    # crossings that read a tensor back whatever its domain proves: in
    # captured code each one fails the capture unless the value is host
    CAPTURE_READBACKS = (".item()", ".cpu()", ".tolist()", ".numpy()",
                         "torch.cuda.synchronize()")

    def run(self, project: Project) -> Iterator[Finding]:
        from deeprest_tpu_torch.analysis.dataflow import ValueFlow

        flow = ValueFlow.of(project)
        seen: set[tuple[str, int, int]] = set()
        yield from self._captured(project, flow, seen)
        graph = project.call_graph()
        seeds = [k for k in graph.functions if self._is_entry_rel(k.rel)]
        if not seeds:
            return
        reach = graph.reachable(seeds)
        jx003 = JX003ReadbackInHotLoop()
        for c in flow.crossings:
            if c.key is None or c.key not in reach:
                continue
            if c.arg_domain != "device":
                continue                 # only PROVEN device values fire
            if jx003._is_hot(c.rel):
                continue                 # JX003's syntactic beat
            sf = project.by_rel.get(c.rel)
            if sf is None or not in_loop(sf, c.node):
                continue
            dk = (c.rel, getattr(c.node, "lineno", 0),
                  getattr(c.node, "col_offset", 0))
            if dk in seen:
                continue
            seen.add(dk)
            yield sf.finding(
                c.node, self.id,
                f"{c.kind} on a device array inside a loop, in code "
                f"reached from the {'/'.join(p[-1] for p in self.ENTRY_SUFFIXES)} "
                "hot entry points: each iteration is a device→host "
                "sync stalling the pipeline; accumulate on device and "
                "read back once after the loop (or suppress with a "
                "reason if this is the designed sink)")

    def _captured(self, project: Project, flow, seen) -> Iterator[Finding]:
        """The capture arm: the port's captured code (rules_torch) is a
        second set of entry points, where any crossing fires, loop or
        not — a host sync cannot be recorded into a CUDA graph, so the
        capture fails at run time."""

        scope = captured_scope(project)
        if not scope.ids:
            return
        for c in flow.crossings:
            sf = project.by_rel.get(c.rel)
            if sf is None or not scope.contains(sf, c.node):
                continue
            if c.kind in self.CAPTURE_READBACKS:
                if c.arg_domain == "host":
                    continue
            elif c.arg_domain != "device":
                continue
            dk = (c.rel, getattr(c.node, "lineno", 0),
                  getattr(c.node, "col_offset", 0))
            if dk in seen:
                continue
            seen.add(dk)
            yield sf.finding(
                c.node, self.id,
                f"{c.kind} inside captured code (a body handed to a "
                "CUDA-graph capture or torch.compile, or a function it "
                "reaches): a device→host sync cannot be recorded into a "
                "graph, so the capture fails at run time "
                "(GraphCaptureError names this line); read the value back "
                "after the replay")


@register
class QT001SilentInt8Promotion(Rule):
    id = "QT001"
    title = ("int8 quantized weight promoted to float outside the "
             "sanctioned dequant helper (ops/quantize.py dequantize): "
             "the per-channel scale multiply was skipped")
    guards = ("round 22 stores GRU/dense weights as per-output-channel "
              "symmetric int8 with a separate f32 scale; the ONLY legal "
              "way for that int8 tensor to meet float math is "
              "ops/quantize.py dequantize, which applies the scale.  A "
              "raw astype(f32), an i8 x float BinOp, or an int8 operand "
              "handed straight to einsum/dot/matmul promotes inside XLA "
              "with the scale never applied — outputs wrong by ~1/scale "
              "per channel, and nothing crashes.  graftflow's dtype "
              "lattice tracks i8 as its own member and records every "
              "such escape interprocedurally; the rule scopes to ops/ "
              "and serve/ (the planes quantized weights live in) so "
              "analysis fixtures and host tooling stay silent")

    # directories where quantized weight tensors actually circulate;
    # an i8 escape anywhere else is not weight data (fixture files,
    # host-side tooling) and stays silent
    HOT_DIRS = ("ops", "serve")

    def run(self, project: Project) -> Iterator[Finding]:
        from deeprest_tpu_torch.analysis.dataflow import ValueFlow

        flow = ValueFlow.of(project)
        seen: set[tuple] = set()
        for h in flow.i8_hazards:
            parts = tuple(h.rel.replace("\\", "/").split("/"))
            if not any(d in parts[:-1] for d in self.HOT_DIRS):
                continue
            sf = project.by_rel.get(h.rel)
            if sf is None:
                continue
            dk = (h.rel, getattr(h.node, "lineno", 0),
                  getattr(h.node, "col_offset", 0), h.why[:40])
            if dk in seen:
                continue
            seen.add(dk)
            yield sf.finding(
                h.node, self.id,
                f"int8 value reaches float math here ({h.why}) without "
                "the sanctioned dequant: route it through "
                "ops/quantize.py dequantize() so the per-channel scale "
                "is applied — a raw promotion serves outputs wrong by "
                "~1/scale and nothing crashes")
