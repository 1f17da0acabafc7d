"""Rule pack OB: observability discipline.

Round 14 built deeprest_tpu/obs (ported as deeprest_tpu_torch/obs):
spans, metrics, and the Stopwatch, precisely so latency numbers stop
living in scattered ``perf_counter`` pairs that no scrape, no trace, and
no corpus can see.  OB001 keeps the hot serving/training modules from
growing new ad-hoc timers after the migration.
"""

from __future__ import annotations

import ast
from typing import Iterator

from deeprest_tpu_torch.analysis.core import (
    Finding, Project, Rule, call_name, register,
)


@register
class OB001AdHocLatencyTimer(Rule):
    id = "OB001"
    title = ("ad-hoc wall-clock latency measurement in a hot module "
             "(use an obs span/metric or obs.metrics.Stopwatch)")
    guards = ("round 14: the serving plane measured its in-plane latency "
              "with bare monotonic() pairs and the stream its ETL stall "
              "with the same pattern — invisible to /metrics, spans, and "
              "the self-ingestion corpus.  Latency in serve/ and train/ "
              "now flows through deeprest_tpu_torch/obs (Stopwatch/Histogram/"
              "span); an elapsed-time subtraction outside a deadline "
              "comparison, or any time.time() call, is a number the obs "
              "plane cannot see")

    # Hot watchlist: whole package directories (the JX003 lesson — a name
    # list silently exempts new modules).  Host-side ETL (data/,
    # workload/), the load generator, and obs/ itself (the owner of the
    # sanctioned clock) are out of scope by construction.
    HOT_DIRS = ("serve", "train")

    _TIMERS = {"time.monotonic", "time.perf_counter", "monotonic",
               "perf_counter", "_time.monotonic", "_time.perf_counter"}
    _WALL = {"time.time", "_time.time"}

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return any(d in parts[:-1] for d in self.HOT_DIRS)

    @classmethod
    def _timer_call(cls, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and call_name(node.func) in cls._TIMERS)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for node in sf.walk():
                if (isinstance(node, ast.Call)
                        and call_name(node.func) in self._WALL):
                    yield sf.finding(
                        node, self.id,
                        "time.time() in a hot module: wall clock is the "
                        "wrong latency instrument (NTP steps) and the "
                        "number is invisible to the obs plane; use "
                        "obs.metrics.Stopwatch / a span, or suppress "
                        "with a reason if this is a timestamp, not a "
                        "duration")
                    continue
                # elapsed-time pattern: `<timer>() - t0` with the result
                # USED (stored/accumulated/passed).  A deadline check —
                # the same subtraction consumed directly by a comparison
                # (`monotonic() - t0 > budget`) — is control flow, not a
                # latency sample, and stays silent; so do
                # `deadline - monotonic()` remaining-time computations.
                if (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.Sub)
                        and self._timer_call(node.left)):
                    parent = sf.parents().get(node)
                    if isinstance(parent, ast.Compare):
                        continue
                    yield sf.finding(
                        node, self.id,
                        "elapsed-time measurement with a bare clock pair "
                        "in a hot module: route it through an obs span "
                        "or obs.metrics.Stopwatch so the latency reaches "
                        "/metrics and the trace corpus (suppress with a "
                        "reason only for the obs layer's own designed "
                        "clock sites)")
