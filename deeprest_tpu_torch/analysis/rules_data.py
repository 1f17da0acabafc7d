"""Rule pack DN: sparse-first data-plane discipline.

Round 15 made the traffic pipeline sparse-first end to end: at the
10k-endpoint width a per-window call-path count vector is >99% zeros, so
featurization emits ``(cols, counts)`` pairs, the streaming corpus keeps
padded-COO rings, and densification happens ONCE, on device, inside the
existing executables (ops/densify.py).  DN001 keeps the hot ingest/refresh
modules from quietly re-growing ``[..., F]``-wide dense traffic
allocations after that migration.

Since round 19 both rules ride the graftflow value-flow engine
(analysis/dataflow.py): DN001 is a pure filter over the engine's
syntactic allocation-site table (verdicts pinned bit-for-bit against the
pre-migration rule by tests/test_analysis.py), and DN002 is the
interprocedural generalization — a dense F-trailing HOST allocation
anywhere in the repo whose *value* reaches the sparse-first hot zones
(train/stream, serve/, obs/) through any call chain, attribute store, or
tuple unpacking fires at the ORIGIN allocation, not the sink.
"""

from __future__ import annotations

from typing import Iterator

from deeprest_tpu_torch.analysis.core import Finding, Project, Rule, register
from deeprest_tpu_torch.analysis.dataflow import ValueFlow, in_zone


def _dn001_watch(rel: str) -> bool:
    """The DN001 watchlist: the two modules the sparse-first migration
    converted, plus ALL of obs/ (round 18).  Component-wise suffix match
    (the JX003 lesson: bare-name lists silently exempt moved files)."""
    parts = tuple(rel.replace("\\", "/").split("/"))
    if any(d in parts[:-1] for d in DN001DenseTrafficMaterialization
           .WATCH_DIRS):
        return True
    return any(parts[-2:] == w or parts[-len(w):] == w
               for w in DN001DenseTrafficMaterialization.WATCH
               if len(parts) >= len(w))


@register
class DN001DenseTrafficMaterialization(Rule):
    id = "DN001"
    title = ("dense [..., capacity]-wide traffic allocation in a "
             "sparse-first hot module (carry padded-COO and densify on "
             "device — ops/densify.py)")
    guards = ("round 15: the sparse-first 10k-endpoint pipeline exists "
              "precisely so F-wide dense traffic tensors (a month-scale "
              "F=10240 retained corpus is ~3.5 GB of ring; a normalized "
              "window stack ~10 GB) never materialize on the ingest/"
              "refresh hot paths — featurize emits (cols, counts), the "
              "ring stores padded-COO, and the one densify is an "
              "on-device scatter inside the staged executables.  A "
              "np.zeros/np.empty/np.ones/np.full whose trailing shape "
              "dimension is a capacity/feature width in train/stream.py "
              "or data/featurize.py reintroduces exactly that "
              "allocation; the pinned dense REFERENCE paths carry "
              "reasoned suppressions instead of silent exemptions")

    # Watchlist: the two modules the sparse-first migration converted,
    # plus ALL of obs/ (round 18: the quality monitors touch the F-wide
    # feature space on every sweep — their contract is COO rows in with
    # the one dense window built through ops/densify.py, so a dense
    # per-sweep allocation here is exactly the regression DN001 exists
    # to catch).  Round 21 adds serve/surface.py: a capacity-surface
    # build folds hundreds of scenario programs through the estimator,
    # so an F-trailing dense staging buffer there multiplies by the
    # whole mix grid.  Round 22 adds ops/quantize.py: quantization walks
    # every weight tensor at load time — a host-side F-trailing staging
    # buffer there would charge the whole feature width per reload.
    # Round 24 adds data/wire.py: the firehose decodes straight into
    # padded-COO rows — a dense [.,F] staging buffer in the receiver
    # would re-dense every frame of a millions-of-spans/sec stream.
    WATCH = (("train", "stream.py"), ("data", "featurize.py"),
             ("serve", "surface.py"), ("ops", "quantize.py"),
             ("data", "wire.py"))
    WATCH_DIRS = ("obs",)

    def run(self, project: Project) -> Iterator[Finding]:
        flow = ValueFlow.of(project)
        for site in flow.alloc_sites.values():
            if not (site.host and site.literal_tuple
                    and site.trailing_marker
                    and _dn001_watch(site.rel)):
                continue
            sf = project.by_rel.get(site.rel)
            if sf is None:
                continue
            yield sf.finding(
                site.node, self.id,
                "dense traffic allocation with a capacity-wide "
                "trailing dimension in a sparse-first hot module: "
                "carry (cols, vals) padded-COO rows and let "
                "ops/densify.py scatter on device (suppress with "
                "a reason only for the pinned dense reference "
                "paths)")


@register
class DN002InterproceduralDenseTaint(Rule):
    id = "DN002"
    title = ("dense F-trailing host allocation whose value reaches a "
             "sparse-first hot zone (train/stream, serve/, obs/) through "
             "the call graph — fires at the origin allocation")
    guards = ("round 19: DN001 only sees allocations INSIDE its "
              "watchlist, so a dense [.., F] buffer built in a helper "
              "module and handed to the stream/serving/obs planes "
              "through a call chain (the exact shape the fleet tier's "
              "per-app axes and the push-ingest firehose are about to "
              "multiply — ROADMAP items 3-4, where one dense F-wide "
              "alloc at F=10240 re-inflates the 80x byte win) landed "
              "unseen.  graftflow propagates denseness taint through "
              "returns, call args, attribute stores, and tuple "
              "unpacking, and this rule fires at the ORIGIN allocation "
              "of any tainted value that reaches the zones")

    def run(self, project: Project) -> Iterator[Finding]:
        flow = ValueFlow.of(project)
        for origin in sorted(flow.zone_hits):
            site = flow.alloc_sites.get(origin)
            if site is None or not site.host:
                continue
            # DN001's beat: a marker-shaped allocation inside its own
            # watchlist already fires (or carries a reasoned
            # suppression) there — one owner per site
            if (site.literal_tuple and site.trailing_marker
                    and _dn001_watch(site.rel)):
                continue
            sf = project.by_rel.get(site.rel)
            if sf is None:
                continue
            sink = flow.zone_hits[origin]
            where = ("this sparse-first hot zone" if in_zone(site.rel)
                     else f"the sparse-first hot zone ({sink})")
            yield sf.finding(
                site.node, self.id,
                "dense F-trailing host allocation reaches "
                f"{where} through the call graph: the hot zones "
                "(train/stream, serve/, obs/) carry padded-COO "
                "(cols, vals) rows and densify ONCE on device "
                "(ops/densify.py); keep the dense buffer out of the "
                "zone or suppress here with a reason if this is a "
                "pinned dense reference path")
