"""Fleet tier: M tenant applications on one serving plane
(``deeprest_tpu/serve/fleet.py``).

The paper's deployment story is many applications, each with its own
trace corpus and trained model, behind one serving plane.  The scaling
hazard is never the weights (a flagship tenant is 89 MB) but the serving
programs: a naive plane captures a fresh set of rung graphs per tenant, so
capture time and device memory grow linearly in M.  This module pins both
flat:

:class:`PredictorPool`
    Tenant → predictor entries keyed by ``(checkpoint_path,
    params_digest, quant)``, with three storage tiers:

    - **device-resident**: up to ``hbm_budget`` tenants' weights and stats
      live on the card, managed as an LRU on the request path
      (``resolve``);
    - **host spill**: evicted tenants' tensors are copied to pinned host
      memory (plain host tensors on the CPU) and restored by one
      host-to-device copy per tensor on next touch: never a disk read and
      never a capture;
    - **disk**: the checkpoint itself, touched only at admission.

    The first admission makes the plane (``Predictor.share_executables_
    from``, serve/predictor.py): a predictor over copies of that tenant's
    weights whose tensors are the bound slot the rung graphs read.  Every
    admitted predictor, the first included, serves through the plane's
    graphs, and each run copies the caller's weights and stats into the
    slot first (the bind, serve/graphs.py ``BoundSlot``), so
    ``jit_cache_size`` stays flat in M.  The plane is not a tenant: it is
    not counted in ``stats()["tenants"]`` nor in the LRU, and its bytes
    are reported apart (``stats()["plane"]``).  Admission loads no
    executable: CUDA graphs cannot be serialized (serve/aot.py), so the
    plane captures at its first ``warm()`` and ``compile_fallbacks``
    counts those captures.

Eviction never breaks an in-flight request: a spill REPLACES the
predictor's device tensors with pinned host copies of the same bytes
after the copies (and every bind queued before them) have landed, so a
request that resolved the entry before the eviction still binds the same
values, host to device; the next ``resolve`` restores the host copy.

Pool-entry accessor discipline, as in the JAX package: every per-tenant
mutable object (the predictor, the host spill, the per-tenant
QualityMonitor, the reason-labeled invalidation counters) lives on
:class:`PoolEntry` attributes named ``_tenant_*`` and is reached only
through the entry's accessor methods outside this module.
"""

from __future__ import annotations

import collections
import threading

import numpy as np

from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans


class UnknownTenantError(KeyError):
    """Raised by ``resolve``/``peek`` for a tenant never admitted to the
    pool: the HTTP layer maps this to a 404, never to a silent
    fall-through onto another tenant's model."""


class PoolEntry:
    """One tenant's serving state.  Mutable per-tenant objects live on
    ``_tenant_*`` attributes and are reached through the accessors
    below."""

    def __init__(self, tenant: str, key: tuple, predictor, quality=None):
        self.tenant = tenant
        self.key = key                       # (ckpt_path, digest, quant)
        self.resident = True
        self.spills = 0
        self.restores = 0
        self.served = 0
        self._tenant_predictor = predictor
        self._tenant_spill = None            # pinned host tensors when spilled
        self._tenant_quality = quality
        self._tenant_invalidations: dict[str, int] = {}

    # -- accessors (the only sanctioned read path) -----------------------

    def predictor(self):
        """The tenant's serving backend (device-resident tensors when the
        entry is resident; pinned host tensors, still correct, once
        spilled)."""
        return self._tenant_predictor

    def quality(self):
        """The tenant's QualityMonitor, or None when the pool was built
        without per-tenant quality."""
        return self._tenant_quality

    def invalidations(self) -> dict[str, int]:
        """Reason → count of this tenant's weight-swap invalidations."""
        return dict(self._tenant_invalidations)

    def note_invalidation(self, reason: str) -> None:
        self._tenant_invalidations[reason] = (
            self._tenant_invalidations.get(reason, 0) + 1)


def _state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


class PredictorPool:
    """Checkpoint-keyed predictor pool with a device-resident LRU, pinned
    host spill, one shared graph set, and the AOT manifest check at the
    first admission (module docstring).

    ``quality_config`` (a QualityConfig with ``enabled=True``) attaches
    one QualityMonitor per pool entry, each with a PRIVATE metrics
    registry; per-tenant gauges render through the serving collector
    (server.py) with a ``tenant`` label and top-K + ``__other__``
    cardinality bounding instead.
    """

    def __init__(self, hbm_budget: int = 4, aot: bool = True,
                 quality_config=None, top_k_tenants: int = 8,
                 default_tenant: str = "default"):
        if hbm_budget < 1:
            raise ValueError(f"hbm_budget {hbm_budget} must be >= 1")
        if top_k_tenants < 1:
            raise ValueError(f"top_k_tenants {top_k_tenants} must be >= 1")
        self.hbm_budget = int(hbm_budget)
        self.aot = bool(aot)
        self.top_k_tenants = int(top_k_tenants)
        self.default_tenant = str(default_tenant)
        self._quality_config = (quality_config
                                if quality_config is not None
                                and getattr(quality_config, "enabled", False)
                                else None)
        # Guards the LRU order, entry residency, and the ledger below.
        # Restores run under the lock (rare by design, one host-to-device
        # weight transfer); no replay ever does (callers get the entry and
        # predict outside).
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, PoolEntry]" = \
            collections.OrderedDict()
        # The plane: a predictor over copies of the first admission's
        # weights, whose rung graphs every tenant serves through.
        self._template = None
        self._frozen_cache: int | None = None
        self.admissions = 0
        self.hits = 0
        self.unknown_tenants = 0
        self.spill_count = 0
        self.restore_count = 0
        self.evictions = 0
        self.aot_loaded = 0
        self.aot_bytes = 0
        self.compile_fallbacks = 0
        self.aot_last_reason = None
        # host ms of the latest spills and restores, copies landed
        self._ms = {"spill": collections.deque(maxlen=4096),
                    "restore": collections.deque(maxlen=4096)}

    # -- admission --------------------------------------------------------

    def admit(self, tenant: str, predictor, checkpoint_path: str = "") \
            -> PoolEntry:
        """Admit a tenant's predictor.  The first admission makes the
        plane from it and checks the AOT manifest next to
        ``checkpoint_path`` (serve/aot.py); every admission then serves
        through the plane's graphs and captures nothing."""
        from deeprest_tpu_torch.serve.predictor import Predictor

        if not isinstance(predictor, Predictor):
            raise TypeError(
                f"can only share executables between Predictors, got "
                f"{type(predictor).__name__}")
        key = (str(checkpoint_path), predictor.params_digest(),
               getattr(predictor, "quant", "off"))
        with self._lock:
            if tenant in self._entries:
                raise ValueError(
                    f"tenant {tenant!r} already admitted; use reload() "
                    "for a weight hot-swap")
            with obs_spans.RECORDER.span("fleet.admit",
                                         component="deeprest-fleet") as sp:
                sp.tag(tenant=tenant, quant=key[2])
                if self._template is None:
                    plane = predictor.fleet_plane()
                    if self.aot and checkpoint_path:
                        from deeprest_tpu_torch.serve.aot import load_aot

                        res = load_aot(plane, checkpoint_path)
                        self.aot_loaded += res["loaded"]
                        self.aot_bytes += res["bytes"]
                        self.compile_fallbacks += len(res["fallback_rungs"])
                        self.aot_last_reason = res["reason"]
                        sp.tag(aot_loaded=res["loaded"],
                               aot_fallbacks=len(res["fallback_rungs"]))
                    elif self.aot:
                        self.aot_last_reason = "no checkpoint_path"
                    self._template = plane
                predictor.share_executables_from(self._template)
                quality = None
                if self._quality_config is not None:
                    from deeprest_tpu_torch.obs import metrics as obs_metrics
                    from deeprest_tpu_torch.obs.quality import QualityMonitor

                    quality = QualityMonitor(
                        predictor.metric_names,
                        config=self._quality_config,
                        registry=obs_metrics.MetricsRegistry())
                entry = PoolEntry(tenant, key, predictor, quality)
                self._entries[tenant] = entry
                self.admissions += 1
                self._evict_over_budget_locked(keep=entry)
        return entry

    # -- the request path -------------------------------------------------

    def resolve(self, tenant: str | None) -> PoolEntry:
        """Tenant → pool entry, on the dispatch path: LRU touch, restore
        from the host spill if evicted (one host-to-device copy per
        tensor: no disk, no capture), and the serve counter.  ``None``
        resolves to the pool's default tenant."""
        t = tenant if tenant is not None else self.default_tenant
        with self._lock:
            entry = self._entries.get(t)
            if entry is None:
                self.unknown_tenants += 1
                raise UnknownTenantError(t)
            self._entries.move_to_end(t)
            entry.served += 1
            self.hits += 1
            if not entry.resident:
                self._restore_locked(entry)
                self._evict_over_budget_locked(keep=entry)
        return entry

    def peek(self, tenant: str | None) -> PoolEntry:
        """Read-only entry lookup: no LRU touch, no restore, no counters,
        for metadata paths (verdicts, response metric names) that must
        not perturb the eviction order the dispatch path maintains."""
        t = tenant if tenant is not None else self.default_tenant
        with self._lock:
            entry = self._entries.get(t)
        if entry is None:
            raise UnknownTenantError(t)
        return entry

    # -- weight hot-swap --------------------------------------------------

    def reload(self, tenant: str, fresh, reason: str = "manual") \
            -> PoolEntry:
        """Per-tenant weight hot-swap.  The swap is one reference
        assignment under the pool lock: requests in flight finish on the
        predictor they resolved (its tensors stay alive on their stack),
        and every later ``resolve`` serves the fresh weights.  ``reason``
        labels the tenant's invalidation counter end to end."""
        with self._lock:
            entry = self._entries.get(tenant)
            if entry is None:
                raise UnknownTenantError(tenant)
            with obs_spans.RECORDER.span("fleet.reload",
                                         component="deeprest-fleet") as sp:
                sp.tag(tenant=tenant, reason=reason)
                if self._template is not None and fresh is not self._template:
                    fresh.share_executables_from(self._template)
                entry.key = (entry.key[0], fresh.params_digest(),
                             getattr(fresh, "quant", "off"))
                entry._tenant_predictor = fresh
                entry._tenant_spill = None
                entry.resident = True
                entry.note_invalidation(reason)
                quality = entry._tenant_quality
                self._evict_over_budget_locked(keep=entry)
        if quality is not None:
            quality.on_model_refresh()
        return entry

    # -- LRU / spill / restore (callers hold self._lock) ------------------

    def _resident_locked(self):
        return [e for e in self._entries.values() if e.resident]

    def _evict_over_budget_locked(self, keep: PoolEntry | None = None):
        resident = self._resident_locked()
        while len(resident) > self.hbm_budget:
            victim = next((e for e in resident if e is not keep), None)
            if victim is None:       # budget 0-vs-keep degenerate: keep wins
                break
            self._spill_locked(victim)
            self.evictions += 1
            resident = self._resident_locked()

    def _spill_locked(self, entry: PoolEntry) -> None:
        """Device → pinned host (``Predictor.spill``): every weight and
        stats tensor copied, the copies (and every bind queued before
        them on the stream) landed, then the predictor pointed at the
        host copies, which drops its device tensors.  Same bytes, so a
        request that resolved the entry before the spill still binds
        bit-exact values.  A mesh tenant spills on every rank."""
        pred = entry._tenant_predictor
        with obs_spans.RECORDER.span("fleet.spill",
                                     component="deeprest-fleet") as sp:
            sp.tag(tenant=entry.tenant)
            sw = obs_metrics.Stopwatch()
            host = pred.spill()
            self._ms["spill"].append(sw.elapsed() * 1e3)
        entry._tenant_spill = host
        entry.resident = False
        entry.spills += 1
        self.spill_count += 1

    def _restore_locked(self, entry: PoolEntry) -> None:
        """Pinned host → device (``Predictor.restore``): one copy per
        tensor from the spill.  Never a disk read, never a capture: the
        restored tensors have the shapes and dtypes the plane's graphs
        were captured for, and only their values are bound into the slot.
        A mesh tenant restores on every rank, and stays on its mesh."""
        pred = entry._tenant_predictor
        with obs_spans.RECORDER.span("fleet.restore",
                                     component="deeprest-fleet") as sp:
            sp.tag(tenant=entry.tenant)
            sw = obs_metrics.Stopwatch()
            pred.restore(entry._tenant_spill)
            self._ms["restore"].append(sw.elapsed() * 1e3)
        entry._tenant_spill = None
        entry.resident = True
        entry.restores += 1
        self.restore_count += 1

    # -- executable ledger ------------------------------------------------

    def _jit_cache_size_locked(self) -> int | None:
        tmpl = self._template
        if tmpl is None:
            return None
        solo = tmpl.device_plane
        return tmpl.jit_cache_size() + (
            solo.jit_cache_size() if solo is not None else 0)

    def jit_cache_size(self) -> int | None:
        """The plane-wide rung-graph count (keys dispatched on the CPU):
        every tenant serves through the plane's graphs.  A mesh template
        adds its one-device plane's, which every one-device tenant shares
        (serve/predictor.py)."""
        with self._lock:
            return self._jit_cache_size_locked()

    def device_plane(self):
        """A mesh template's one-device plane, which every one-device
        tenant shares (serve/predictor.py), or None."""
        with self._lock:
            tmpl = self._template
        return None if tmpl is None else tmpl.device_plane

    def freeze(self) -> int | None:
        """Pin the current graph count as the post-warmup ceiling.  After
        this, ``assert_frozen`` (and the fleet bench's ledger gate) treats
        ANY growth as a per-tenant capture leak."""
        with self._lock:
            self._frozen_cache = self._jit_cache_size_locked()
            return self._frozen_cache

    def assert_frozen(self) -> int | None:
        with self._lock:
            now = self._jit_cache_size_locked()
            frozen = self._frozen_cache
        if frozen is not None and now is not None and now > frozen:
            raise RuntimeError(
                f"jit cache grew post-freeze: {frozen} -> {now} — a "
                "tenant dispatch compiled a new executable (per-tenant "
                "executables are exactly what the fleet tier exists to "
                "prevent)")
        return now

    # -- observability ----------------------------------------------------

    def tenant_meta(self, limit: int | None = None) -> dict:
        """Per-tenant ``{quant, params_digest, resident}`` map (the
        /healthz ``fleet.tenants`` view).  ``limit`` bounds the map to the
        top-N by serve count with the remainder rolled into ``__other__``
        counts."""
        with self._lock:
            entries = list(self._entries.values())
        entries.sort(key=lambda e: e.served, reverse=True)
        cut = entries if limit is None else entries[:limit]
        out = {e.tenant: {"quant": e.key[2], "params_digest": e.key[1],
                          "resident": e.resident} for e in cut}
        rest = entries[len(cut):]
        if rest:
            out["__other__"] = {
                "tenants": len(rest),
                "resident": sum(e.resident for e in rest),
            }
        return out

    def plane_stats(self) -> dict | None:
        """The plane, apart from the tenants: its bound slot's bytes, the
        binds made, and the tenant the slot holds (port-only); a mesh
        template's one-device plane under ``device_plane``."""
        with self._lock:
            tmpl = self._template
        if tmpl is None:
            return None
        out = self._slot_stats(tmpl)
        if tmpl.device_plane is not None:
            out["device_plane"] = self._slot_stats(tmpl.device_plane)
        return out

    def _slot_stats(self, plane) -> dict:
        slot = plane.graphs.slot
        owner = slot.owner
        holder = next((e.tenant for e in self._entries_snapshot()
                       if e.predictor() is owner), None)
        return {"slot_bytes": slot.nbytes, "binds": slot.binds,
                "bound_tenant": holder}

    def timings(self) -> dict[str, list[float]]:
        """Host ms of the latest spills and restores (each waits for its
        copies to land), oldest first (port-only)."""
        with self._lock:
            return {k: list(v) for k, v in self._ms.items()}

    def _entries_snapshot(self) -> list[PoolEntry]:
        with self._lock:
            return list(self._entries.values())

    def host_bytes(self) -> int:
        """Bytes of the spilled tenants' pinned host copies."""
        return sum(_state_bytes(e._tenant_spill)
                   for e in self._entries_snapshot()
                   if e._tenant_spill is not None)

    def stats(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
            resident = sum(e.resident for e in entries)
            per_tenant = {
                e.tenant: {
                    "resident": e.resident,
                    "served": e.served,
                    "spills": e.spills,
                    "restores": e.restores,
                    "invalidations": e.invalidations(),
                }
                for e in sorted(entries, key=lambda e: e.served,
                                reverse=True)[:self.top_k_tenants]
            }
            out = {
                "hbm_budget": self.hbm_budget,
                "tenants": len(entries),
                "resident": resident,
                "spilled": len(entries) - resident,
                "admissions": self.admissions,
                "hits": self.hits,
                "unknown_tenants": self.unknown_tenants,
                "spills": self.spill_count,
                "restores": self.restore_count,
                "evictions": self.evictions,
                "aot": {
                    "enabled": self.aot,
                    "loaded": self.aot_loaded,
                    "bytes": self.aot_bytes,
                    "compile_fallbacks": self.compile_fallbacks,
                    "last_reason": self.aot_last_reason,
                },
                "jit_cache_size": self._jit_cache_size_locked(),
                "frozen": self._frozen_cache is not None,
                "frozen_cache_size": self._frozen_cache,
                "per_tenant": per_tenant,
            }
        out["plane"] = self.plane_stats()
        if out["plane"] is not None:
            # port-only: host ms of the latest spills and restores
            out["plane"]["copy_ms"] = {k: v[-16:]
                                       for k, v in self.timings().items()}
        return out

    def quality_rollup(self) -> list[tuple[str, dict]]:
        """``(tenant_label, verdict_summary)`` rows for the /metrics
        collector: the top-K tenants by serve count get their own
        ``tenant`` label; everyone else aggregates under ``__other__``
        (worst state, max scores, summed sweeps)."""
        with self._lock:
            entries = [e for e in self._entries.values()
                       if e.quality() is not None]
        entries.sort(key=lambda e: e.served, reverse=True)
        state_rank = {"ok": 0, "drift": 1, "anomaly": 2}

        def summarize(entry):
            v = entry.quality().verdicts()
            metrics = v.get("metrics", {})
            worst = max((state_rank.get(m.get("state"), 0)
                         for m in metrics.values()), default=0)
            scores = [m.get("anomaly_score") or 0.0
                      for m in metrics.values()]
            coverages = [m["coverage"] for m in metrics.values()
                         if isinstance(m, dict)
                         and m.get("coverage") is not None]
            pinballs = [m["pinball"] for m in metrics.values()
                        if isinstance(m, dict)
                        and m.get("pinball") is not None]
            return {
                "sweeps": v.get("sweeps", 0),
                "verdict": worst,
                "anomaly_score": max(scores, default=0.0),
                "coverage": (float(np.mean(coverages))
                             if coverages else None),
                "pinball": float(np.mean(pinballs)) if pinballs else None,
            }

        rows = [(e.tenant, summarize(e))
                for e in entries[:self.top_k_tenants]]
        rest = entries[self.top_k_tenants:]
        if rest:
            summaries = [summarize(e) for e in rest]
            rows.append(("__other__", {
                "sweeps": sum(s["sweeps"] for s in summaries),
                "verdict": max(s["verdict"] for s in summaries),
                "anomaly_score": max(s["anomaly_score"]
                                     for s in summaries),
                "coverage": None,
                "pinball": None,
            }))
        return rows

    def tenants(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
