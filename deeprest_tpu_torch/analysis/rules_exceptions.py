"""Rule pack EX: exception-safety for the serving/training plane.

The chaos half of ROADMAP item 7 will kill replicas and preempt slices
under live load; the static half is proving that an exception anywhere on
the hot path cannot strand the plane.  Four ways it historically could:

- EX001 — a bare ``lock.acquire()`` whose ``release()`` is not reached on
  a raising path (beyond TH004's per-attribute discipline: TH004 proves
  accesses hold the lock, this proves the lock itself cannot be wedged
  shut).  ``with lock:`` is structurally safe and stays silent, as does
  the ``if not lock.acquire(blocking=False): raise Busy`` fast-fail shape
  — on that branch the lock was never taken.
- EX002 — state published in paired points (``drain()`` … ``resume()``,
  a predictor swap begun but not completed) with raise-capable calls
  between them and no try/finally: the exception leaves the plane
  half-published — replicas drained forever, a router serving a
  half-swapped stack.
- EX003 — a swallowed exception (``except: pass`` / ``except Exception:
  pass``) in the serve/train/obs watchlists: the plane's failure signal
  is silently discarded exactly where the obs plane (round 14) exists to
  surface it.  Narrow, typed excepts with a pass body are a deliberate
  idiom (best-effort shutdown sends) and stay silent.
- EX004 — the device-loss family (``XlaRuntimeError``/``DeviceLossError``
  explicitly, or a broad except around a step/superstep/jit dispatch)
  caught in ``train/``/``parallel/`` and neither re-raised nor routed to
  the remesh handler: the round-20 elastic fault barrier must stay the
  ONLY swallow point for device loss — a second one quietly turns a
  recoverable preemption into corrupted training state (the dispatch's
  progress is gone but the cursor marches on).

EX001/EX002 ride the same path-sensitive paired-operation walker as the
RS pack (core.ObligationWalker) — through try/finally, with, early
return, and raise edges.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    Finding, ObligationWalker, Project, Rule, SourceFile, dotted_name,
    guarded_if_closes, method_call_on, register,
)
from deeprest_tpu_torch.analysis.rules_lifecycle import (
    _function_rel_functions, _in_with_item, _stmt_of,
)


@register
class EX001LockNotReleasedOnRaise(Rule):
    id = "EX001"
    title = ("bare lock .acquire() whose release() is not reached on a "
             "raising path")
    guards = ("the serving plane's locks gate every request thread "
              "(service state, admission, replica registries, the one "
              "profiler window): an exception between a bare acquire() "
              "and its release() wedges the lock shut and every later "
              "request deadlocks behind it — `with lock:` or try/finally "
              "is the contract (obs/profiler.py's fast-fail capture "
              "window is the reference shape)")

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None:
                continue
            for fn, _cls in _function_rel_functions(sf):
                yield from self._check(sf, fn)

    def _acquire_sites(self, sf: SourceFile, fn: ast.AST):
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"):
                recv = dotted_name(node.func.value)
                if recv is None or _in_with_item(sf, node):
                    continue
                yield recv, node

    def _check(self, sf: SourceFile, fn: ast.AST) -> Iterator[Finding]:
        seen: set[str] = set()
        for recv, call in self._acquire_sites(sf, fn):
            if recv in seen:
                continue
            seen.add(recv)
            stmt = _stmt_of(sf, call)
            if stmt is None:
                continue
            open_at, mode = stmt, "after"
            if isinstance(stmt, ast.If) and self._in_test(stmt, call):
                # `if not lock.acquire(...):` — the body runs NOT holding
                # the lock (fast-fail), the fall-through path holds it;
                # `if lock.acquire(...):` — the body holds it.
                mode = "after" if self._under_not(stmt, call) else "body"

            def closes(s: ast.stmt, _recv=recv) -> bool:
                if isinstance(s, ast.If):
                    return guarded_if_closes(s, _recv, ("release",))
                return method_call_on(s, _recv, ("release",)) is not None

            walker = ObligationWalker(fn, open_at, closes, open_mode=mode)
            for leak in walker.run():
                how = ("an exception here escapes with the lock held"
                       if leak.kind == "exception"
                       else "this path exits with the lock held")
                yield sf.finding(
                    leak.node, self.id,
                    f"{recv}.acquire() (line {call.lineno}) is not "
                    f"released on every path: {how}; use `with "
                    f"{recv}:` or release in a finally")
                break

    @staticmethod
    def _in_test(stmt: ast.If, call: ast.Call) -> bool:
        return any(n is call for n in ast.walk(stmt.test))

    @staticmethod
    def _under_not(stmt: ast.If, call: ast.Call) -> bool:
        for n in ast.walk(stmt.test):
            if isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
                if any(m is call for m in ast.walk(n.operand)):
                    return True
        return False


@register
class EX002StrandedBetweenPublishPoints(Rule):
    id = "EX002"
    title = ("exception between paired publish points (drain → resume) "
             "strands half-published plane state")
    guards = ("round 16: ReplicaRouter.scale_to's shrink path had "
              "raise-capable wait_idle/close calls between drain() and "
              "the discharge with no try/finally — one exception left "
              "replicas drained but registered, a plane that looks live "
              "and serves nothing; rolling_reload_from's finally-resume "
              "is the contract this rule enforces plane-wide")

    # paired publish points: opener method → the calls that complete it
    PAIRS = {"drain": ("resume", "close", "terminate", "kill",
                       "shutdown")}
    HOT_DIRS = ("serve",)

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return any(d in parts[:-1] for d in self.HOT_DIRS)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for fn, _cls in _function_rel_functions(sf):
                yield from self._check(sf, fn)

    def _check(self, sf: SourceFile, fn: ast.AST) -> Iterator[Finding]:
        seen: set[tuple[str, str]] = set()
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr in self.PAIRS):
                continue
            opener = node.value.func.attr
            recv = dotted_name(node.value.func.value)
            if recv is None or (recv, opener) in seen:
                continue
            seen.add((recv, opener))
            completers = self.PAIRS[opener]

            def closes(s: ast.stmt, _recv=recv,
                       _completers=completers) -> bool:
                if isinstance(s, ast.If):
                    return guarded_if_closes(s, _recv, _completers)
                return method_call_on(s, _recv, _completers) is not None

            walker = ObligationWalker(fn, node, closes,
                                      assume_loops_run=True)
            for leak in walker.run():
                if leak.kind != "exception":
                    continue       # missing-completer paths are RS002's
                yield sf.finding(
                    leak.node, self.id,
                    f"an exception here strands the plane between "
                    f"{recv}.{opener}() (line {node.lineno}) and its "
                    f"completion: the raise-capable region between "
                    "paired publish points needs a try/finally (resume "
                    "on the reload path, close on scale-down) so a "
                    "failure cannot leave state half-published")
                break


@register
class EX003SwallowedException(Rule):
    id = "EX003"
    title = ("swallowed exception (bare/broad except with a pass-only "
             "body) in the serve/train/obs watchlists")
    guards = ("a replica that dies mid-request must surface through the "
              "obs plane (error-tagged spans, /metrics counters — round "
              "14) and the router's health logic, not vanish into an "
              "`except: pass`; the chaos harness asserts zero wrong "
              "answers, which is unprovable if failures are silently "
              "discarded.  Narrow typed excepts with a pass body "
              "(best-effort shutdown sends on a closing pipe) are a "
              "deliberate idiom and stay silent")

    HOT_DIRS = ("serve", "train", "obs")
    _BROAD = ("Exception", "BaseException")

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return any(d in parts[:-1] for d in self.HOT_DIRS)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for node in sf.walk():
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if not self._broad(node.type):
                    continue
                if all(isinstance(s, ast.Pass) for s in node.body):
                    what = ("bare except" if node.type is None else
                            f"except {dotted_name(node.type)}")
                    yield sf.finding(
                        node, self.id,
                        f"{what}: pass swallows every failure on a hot "
                        "path — the obs plane and the router's health "
                        "logic never see it; catch the narrow expected "
                        "type, or record the failure (error-tagged "
                        "span/metric) before continuing")

    def _broad(self, type_node: ast.AST | None) -> bool:
        if type_node is None:
            return True
        name = dotted_name(type_node)
        if name in self._BROAD:
            return True
        if isinstance(type_node, ast.Tuple):
            return any(dotted_name(e) in self._BROAD
                       for e in type_node.elts)
        return False


@register
class EX004DeviceLossSwallowedOutsideBarrier(Rule):
    id = "EX004"
    title = ("device-loss exception caught outside the elastic fault "
             "barrier (neither re-raised nor routed to the remesh "
             "handler)")
    guards = ("round 20 (elastic remeshing): the fault barrier "
              "(Trainer._run_epochs_elastic and the stream's refresh "
              "twin) is the ONLY sanctioned swallow point for the "
              "device-loss family — it restores the newest cursor "
              "snapshot, so nothing from the failed dispatch survives.  "
              "A second catch site that logs-and-continues keeps the "
              "old cursor marching over a dispatch that never happened: "
              "silently corrupted training state, the exact class the "
              "kill-at-step-K bit-parity contract exists to exclude.  "
              "Handlers that re-raise, or route to a "
              "remesh/device-loss handler, are the barrier and stay "
              "silent")

    HOT_DIRS = ("train", "parallel")
    # explicit device-loss family (terminal name of the except type)
    _FAMILY = ("XlaRuntimeError", "JaxRuntimeError", "DeviceLossError")
    _BROAD = ("Exception", "BaseException")
    # a broad except is only the family when its try body holds a
    # jit-dispatch-looking call — the shape the barrier wraps
    _DISPATCH_RE = re.compile(r"(?i)(step|dispatch|\bjit\b)")
    # routing a caught loss to the remesh machinery discharges it
    _HANDLER_RE = re.compile(r"(?i)(remesh|device_loss)")

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return any(d in parts[:-1] for d in self.HOT_DIRS)

    @staticmethod
    def _terminal(node: ast.AST | None) -> str | None:
        name = dotted_name(node) if node is not None else None
        return name.rsplit(".", 1)[-1] if name else None

    def _type_names(self, type_node: ast.AST | None) -> list[str | None]:
        if type_node is None:
            return [None]                      # bare except
        if isinstance(type_node, ast.Tuple):
            return [self._terminal(e) for e in type_node.elts]
        return [self._terminal(type_node)]

    def _try_dispatches(self, try_node: ast.Try) -> bool:
        for stmt in try_node.body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    name = self._terminal(node.func)
                    if name and self._DISPATCH_RE.search(name):
                        return True
        return False

    def _handler_discharges(self, handler: ast.ExceptHandler) -> bool:
        for node in ast.walk(handler):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                name = self._terminal(node.func)
                if name and self._HANDLER_RE.search(name):
                    return True
        return False

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for node in sf.walk():
                if not isinstance(node, ast.Try):
                    continue
                for handler in node.handlers:
                    names = self._type_names(handler.type)
                    explicit = [n for n in names if n in self._FAMILY]
                    broad = any(n is None or n in self._BROAD
                                for n in names)
                    if explicit:
                        what = f"except {'/'.join(explicit)}"
                    elif broad and self._try_dispatches(node):
                        what = ("broad except around a step/superstep "
                                "dispatch")
                    else:
                        continue
                    if self._handler_discharges(handler):
                        continue
                    yield sf.finding(
                        handler, self.id,
                        f"{what} swallows the device-loss family "
                        "outside the elastic fault barrier: the failed "
                        "dispatch's progress is gone but this handler "
                        "continues with the old cursor — re-raise, or "
                        "route to the remesh handler "
                        "(_handle_device_loss), which restores the "
                        "newest snapshot; the barrier must stay the "
                        "only swallow point")
