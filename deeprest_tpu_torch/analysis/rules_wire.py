"""Rule pack WR: wire-receiver hot-loop discipline.

Round 24's span firehose (data/wire.py) sustains millions of spans/sec
on one host because the per-frame recv loop does frame accounting ONLY:
reusable header buffer, one struct.unpack, dispatch.  Everything
allocation- or blocking-shaped lives in helpers outside the loop, and
the single buffered append is bounded by an explicit ``len() >= cap``
backpressure check.  WR001 keeps future edits from re-introducing
per-frame allocations or blocking calls into that loop — the failure
mode is invisible in tests (correct output, 10x slower) and only shows
up as a wire_bench regression.
"""

from __future__ import annotations

import ast
from typing import Iterator

from deeprest_tpu_torch.analysis.core import Finding, Project, Rule, register


def _call_name(node: ast.Call) -> str:
    """Terminal name of a call target: ``sock.recv_into`` -> "recv_into",
    ``open`` -> "open"."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _expr_key(node: ast.expr) -> str | None:
    """Dotted-path key for a Name/Attribute chain (``self._out`` ->
    "self._out"); None for anything dynamic (subscripts, calls)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@register
class WR001BlockingOrUnboundedInRecvLoop(Rule):
    id = "WR001"
    title = ("per-frame allocation or blocking call in a wire receiver's "
             "recv hot loop")
    guards = ("round 24: the firehose's >=10x-over-tailer bar "
              "(benchmarks/wire_bench.json) holds because the per-frame "
              "recv loop is frame accounting only — no file I/O, no "
              "stdout, no whole-connection json.loads, no unbounded "
              "buffering.  Each of those is a silent throughput cliff: "
              "open()/print() block the handler thread mid-frame, "
              "json.loads of an accumulated connection buffer re-parses "
              "O(connection) bytes per frame, and an append with no "
              "len() bound grows until the process OOMs under a slow "
              "consumer instead of shedding with accounting")

    # Scope: wire-transport modules under the package (basename match, so
    # a future serve/wire_fanin.py is covered without a list edit).
    def _is_hot(self, rel: str) -> bool:
        base = rel.replace("\\", "/").rsplit("/", 1)[-1]
        return "wire" in base and base.endswith(".py")

    @staticmethod
    def _recv_loops(fn: ast.AST) -> Iterator[ast.While]:
        """While-loops that read from a socket: contain a call whose
        terminal name mentions recv (recv, recv_into, _recv_exact...).
        That is the per-frame hot loop this rule polices."""
        for node in ast.walk(fn):
            if not isinstance(node, ast.While):
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and "recv" in _call_name(sub):
                    yield node
                    break

    @staticmethod
    def _aug_targets(fn: ast.AST) -> set[str]:
        """Names accumulated with ``+=`` in this function — the
        whole-connection-buffer shape (buf += sock.recv(...))."""
        out: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.op, ast.Add):
                key = _expr_key(node.target)
                if key is not None:
                    out.add(key)
        return out

    @staticmethod
    def _len_guarded(fn: ast.AST) -> set[str]:
        """Container keys whose ``len()`` is compared somewhere in this
        function — the explicit-bound idiom that makes an append
        backpressure-honest (``if len(self._out) >= cap: drop``)."""
        out: set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Compare):
                continue
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call) and _call_name(sub) == "len"
                        and len(sub.args) == 1):
                    key = _expr_key(sub.args[0])
                    if key is not None:
                        out.add(key)
        return out

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for fn in sf.walk():
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                aug = self._aug_targets(fn)
                guarded = self._len_guarded(fn)
                for loop in self._recv_loops(fn):
                    yield from self._check_loop(sf, loop, aug, guarded)

    def _check_loop(self, sf, loop: ast.While, aug: set[str],
                    guarded: set[str]) -> Iterator[Finding]:
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "open" and isinstance(node.func, ast.Name):
                yield sf.finding(
                    node, self.id,
                    "open() inside the per-frame recv loop: file I/O "
                    "blocks the handler thread mid-frame — hoist it out "
                    "of the loop or hand the work to the drain side")
            elif name == "print" and isinstance(node.func, ast.Name):
                yield sf.finding(
                    node, self.id,
                    "print() inside the per-frame recv loop: stdout is a "
                    "blocking, lock-shared stream — use the obs registry "
                    "counters (delta-flushed at poll()) instead")
            elif name in ("loads", "load") and node.args:
                key = _expr_key(node.args[0])
                if key is not None and key in aug:
                    yield sf.finding(
                        node, self.id,
                        f"json.{name}({key}) where {key} is a "
                        "+=-accumulated connection buffer: re-parsing "
                        "the whole buffer every frame is O(connection) "
                        "per frame — frame the payloads (length-prefix) "
                        "and parse each exactly once")
            elif name == "append" and isinstance(node.func, ast.Attribute):
                key = _expr_key(node.func.value)
                if key is not None and key not in guarded:
                    yield sf.finding(
                        node, self.id,
                        f"unbounded {key}.append() in the per-frame recv "
                        "loop: no len() bound is checked in this "
                        "function, so a slow consumer grows the buffer "
                        "until OOM — gate the append on an explicit "
                        "capacity check and shed with drop accounting")
