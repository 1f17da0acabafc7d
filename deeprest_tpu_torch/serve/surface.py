"""Capacity surfaces: precomputed what-if answers with microsecond reads
(``deeprest_tpu/serve/surface.py``, whole: numpy and the obs package only;
the port keys surfaces on its own ``Predictor.params_digest``, which equals
the JAX one on the same checkpoint).

The reference ships its interactive demo over a PRECOMPUTED results
pickle (web-demo/dataloader.py) — the honest admission that users ask
capacity questions faster than models answer them.  This module makes
that precomputation a first-class serving subsystem instead of an
offline artifact, in the Clipper mold (PAPERS.md [2]): a cache and a
batching layer between the user and the model, so what-if rps decouples
from model latency.

Shape of the thing:

- A :class:`MixSpace` is a per-endpoint scale grid around one base
  traffic program (plus Monte-Carlo jitter probes for the parity
  envelope).  Its vertices are scaled copies of the base, built with the
  exact ``int(round(n * s))`` convention :meth:`WhatIfEstimator.sweep`
  uses, so a surface vertex IS a sweep point.
- Building a :class:`CapacitySurface` estimates every vertex and every
  jitter probe in ONE folded batch through
  ``WhatIfEstimator.estimate_many_raw`` — thousands of mixes amortize
  into the fused scenario×window device axis (serve/fused.py), paging
  through already-captured rung graphs (already-compiled executables in
  the JAX package).
- The surface stores per-(component, resource, quantile) prediction
  series as one host-resident float32 grid; queries inside the mix
  space answer by multilinear interpolation over that grid (no lock, no
  dispatch, microseconds).  Queries outside it fall back to a direct
  model call at the cache frontier while the surface warms
  asynchronously.
- :class:`CapacitySurfaceManager` holds surfaces in an LRU keyed by
  ``(params_hash, mix_space_hash)`` with bounded byte accounting, and
  invalidates EAGERLY on backend reloads (``begin_reload``/
  ``end_reload(reason=...)`` bracketing ``rolling_reload_from``): the
  reason label — "watch" cadence vs the DriftController's "drift"/
  "manual" triggers — rides into the invalidation counter, and a stale
  capacity answer can never outlive the model that produced it.

Parity is measured, not assumed: every build interpolates its held-out
jitter probes and compares against their direct estimates from the SAME
folded batch; the resulting envelope is stored on the surface, exposed
on /healthz, and pinned by tests and benchmarks/whatif_bench.py.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict

import numpy as np

from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans

# Shared-axis sentinel: a MixSpace over more endpoints than max_axes
# collapses to ONE scale axis applied to every endpoint (grid**k vertex
# counts are exponential; beyond the cap a uniform scale is the honest
# sweep, exactly what WhatIfEstimator.sweep's scalar factor does).
SHARED_AXIS = "*"

# At most this many warm builds in flight at once: each build is a real
# folded prediction train, and an unbounded thread fleet would let one
# misbehaving client turn cache warming into a denial of service.
_MAX_INFLIGHT_WARMS = 2


def _canonical_program(base_traffic) -> list[dict[str, int]]:
    out: list[dict[str, int]] = []
    prev: dict[str, int] | None = None
    for step in base_traffic:
        cur = {str(ep): int(n) for ep, n in step.items()}
        if prev is not None and cur == prev:
            cur = prev       # share the object: repeated ticks (the
        out.append(cur)      # common shape) dedupe by identity downstream
        prev = cur
    return out


class MixSpace:
    """A per-endpoint scale grid around one base traffic program.

    ``axes`` are the base program's active (nonzero-total) endpoints,
    sorted, capped at ``max_axes`` (beyond which one shared axis scales
    everything together); ``grid`` is the per-axis scale ladder.  The
    vertex at scales ``(s_0, ..., s_k)`` is the program
    ``{ep: int(round(n * s_axis(ep)))}`` per tick — byte-identical to
    what ``WhatIfEstimator.sweep`` would estimate at that factor.
    """

    def __init__(self, base_traffic, grid, max_axes: int = 3,
                 seed: int = 0):
        self.base = _canonical_program(base_traffic)
        if not self.base:
            raise ValueError("mix space needs a non-empty base program")
        # graftlint: disable=JX003 -- host data: grid scales are python floats from config, never device values
        self.grid = tuple(float(g) for g in grid)
        if len(self.grid) < 2 or list(self.grid) != sorted(set(self.grid)):
            raise ValueError(
                f"grid must be >=2 strictly-increasing scales, got "
                f"{self.grid}")
        if self.grid[0] < 0:
            raise ValueError(f"grid scales must be >= 0, got {self.grid}")
        totals: dict[str, int] = {}
        for step in self.base:
            for ep, n in step.items():
                totals[ep] = totals.get(ep, 0) + n
        active = sorted(ep for ep, n in totals.items() if n > 0)
        if not active:
            raise ValueError(
                "mix space needs at least one endpoint with traffic")
        self.axes: tuple[str, ...] = (tuple(active)
                                      if len(active) <= int(max_axes)
                                      else (SHARED_AXIS,))
        self.seed = int(seed)
        self.key = hashlib.sha1(json.dumps(
            {"base": self.base, "grid": self.grid, "axes": self.axes,
             "seed": self.seed},
            sort_keys=True, separators=(",", ":")).encode()).hexdigest()[:16]

    @property
    def num_vertices(self) -> int:
        return len(self.grid) ** len(self.axes)

    def _axis_of(self, ep: str) -> int:
        if self.axes == (SHARED_AXIS,):
            return 0
        return self.axes.index(ep)       # axes are tiny (<= max_axes)

    def program_at(self, scales) -> list[dict[str, int]]:
        """The traffic program at one point of the scale space —
        sweep()'s exact rounding convention."""
        # graftlint: disable=JX003 -- host data: scales are python floats from the request payload
        scales = tuple(float(s) for s in scales)
        if len(scales) != len(self.axes):
            raise ValueError(
                f"{len(scales)} scales for {len(self.axes)} axes")
        return [
            {ep: int(round(n * scales[self._axis_of(ep)]))
             for ep, n in step.items()}
            for step in self.base
        ]

    def vertices(self) -> list[tuple[float, ...]]:
        """All grid vertices as scale tuples, in the flat (C-order)
        enumeration the surface's value grid is stacked in."""
        g = self.grid
        shape = (len(g),) * len(self.axes)
        return [tuple(g[i] for i in idx) for idx in np.ndindex(*shape)]

    def jitter_scales(self, count: int) -> list[tuple[float, ...]]:
        """``count`` Monte-Carlo probe points strictly inside the hull —
        the held-out mixes the parity envelope is measured on.
        Deterministic per (space key, seed): rebuilding the same space
        re-measures the same probes."""
        rng = np.random.default_rng(
            (self.seed & 0xFFFFFFFF) ^ int(self.key[:8], 16))
        lo, hi = self.grid[0], self.grid[-1]
        # graftlint: disable=JX003 -- host data: host-RNG jitter points, never device values
        return [tuple(float(x) for x in rng.uniform(lo, hi, len(self.axes)))
                for _ in range(int(count))]

    def contains(self, scales) -> bool:
        lo, hi = self.grid[0], self.grid[-1]
        # graftlint: disable=JX003 -- host data: scales are python floats from the request payload
        return all(lo <= float(s) <= hi for s in scales)

    def match(self, program) -> tuple[float, ...] | None:
        """Is ``program`` an int-rounded scaling of this space's base?

        Returns the per-axis scales (inside the grid hull) when it is,
        else None.  Rounding makes the scale a FEASIBLE INTERVAL per
        count (``m == round(n*s)`` ⇒ ``s ∈ [(m-.5)/n, (m+.5)/n]``); the
        intervals intersect across every tick and endpoint of an axis,
        and the returned scale snaps to a grid vertex whenever one lies
        in the intersection (so vertex queries read stored values
        bit-exactly).  A miss here only costs a frontier fallback —
        correctness never depends on matching — so this runs allocation-
        free on the raw request program (string endpoint keys, the
        /v1/whatif wire format): a tick identical to its predecessor
        contributes the same interval and is skipped outright, making
        uniform programs O(ticks) dict comparisons instead of O(ticks *
        endpoints) interval math — the /v1/whatif interception budget.
        """
        steps = list(program)
        if len(steps) != len(self.base):
            return None
        k = len(self.axes)
        lo = [self.grid[0]] * k
        hi = [self.grid[-1]] * k
        prev_b = prev_p = None
        for b_step, p_step in zip(self.base, steps):
            if b_step is prev_b and p_step == prev_p:
                continue
            prev_b, prev_p = b_step, p_step
            if len(p_step) != len(b_step):
                return None
            for ep, n in b_step.items():
                try:
                    m = int(p_step[ep])
                except (KeyError, TypeError, ValueError):
                    return None
                if n == 0:
                    if m != 0:
                        return None
                    continue
                a = self._axis_of(ep)
                lo[a] = max(lo[a], (m - 0.5) / n)
                hi[a] = min(hi[a], (m + 0.5) / n)
        scales = []
        for a in range(k):
            if lo[a] > hi[a]:
                return None
            snapped = None
            for g in self.grid:
                if lo[a] <= g <= hi[a]:
                    snapped = g
                    break
            scales.append(snapped if snapped is not None
                          else (lo[a] + hi[a]) / 2.0)
        return tuple(scales)

    def to_meta(self) -> dict:
        return {"key": self.key, "axes": list(self.axes),
                "grid": list(self.grid), "seed": self.seed,
                "ticks": len(self.base), "vertices": self.num_vertices}


def _bracket(grid: tuple[float, ...], s: float) -> tuple[int, float]:
    """Cell index + weight for one coordinate: ``grid[i] <= s <=
    grid[i+1]``, ``w`` the fractional position.  Out-of-hull coordinates
    clamp to the boundary (callers gate on :meth:`MixSpace.contains`
    before trusting the answer)."""
    if s <= grid[0]:
        return 0, 0.0
    if s >= grid[-1]:
        return len(grid) - 2, 1.0
    for i in range(len(grid) - 1):
        if s == grid[i]:
            return i, 0.0
        if grid[i] < s < grid[i + 1]:
            return i, (s - grid[i]) / (grid[i + 1] - grid[i])
    return len(grid) - 2, 1.0


class CapacitySurface:
    """One built surface: the full ``[g]*k + [T, E, Q]`` prediction grid
    for a mix space, host-resident and immutable."""

    __slots__ = ("space", "params_hash", "values", "parity", "build_s",
                 "programs_folded", "_meta")

    def __init__(self, space: MixSpace, params_hash: str,
                 values: np.ndarray, parity: dict, build_s: float,
                 programs_folded: int):
        self.space = space
        self.params_hash = params_hash
        self.values = values            # read-only float32
        self.parity = parity            # measured envelope (see build)
        self.build_s = build_s
        self.programs_folded = programs_folded
        self._meta = None       # built lazily: see meta()

    @property
    def nbytes(self) -> int:
        return int(self.values.nbytes)

    def interpolate(self, scales) -> np.ndarray:
        """Multilinear interpolation at one point of the scale space →
        the ``[T, E, Q]`` prediction series.  Pure host numpy over a few
        tiny slices — this is the microsecond read path.  Exact grid
        coordinates take the stored slice directly, so vertex reads are
        bit-identical to the direct estimate they were built from."""
        vals = self.values
        for s in scales:
            # graftlint: disable=JX003 -- host data: the query point is python floats; values is host numpy by design
            i, w = _bracket(self.space.grid, float(s))
            if w == 0.0:
                vals = vals[i]
            elif w == 1.0:
                vals = vals[i + 1]
            else:
                vals = vals[i] * (1.0 - w) + vals[i + 1] * w
        return vals

    def meta(self, scales=None) -> dict:
        # the static half is snapshotted on first use (after the build
        # finishes measuring parity) and shallow-copied per hit — the
        # microsecond read path allocates one small dict, not four
        base = self._meta
        if base is None:
            base = self._meta = {
                "hit": True, "params_hash": self.params_hash,
                "space": self.space.to_meta(),
                "parity": dict(self.parity)}
        out = dict(base)
        if scales is not None:
            # graftlint: disable=JX003 -- host data: response metadata built from python floats
            out["scales"] = [float(s) for s in scales]
        return out


def peaks_from_series(series: np.ndarray, metric_names, quantiles,
                      delta_mask) -> dict[str, dict[str, float]]:
    """``[T, E, Q]`` series → sweep()-convention peaks: delta-trained
    metrics report peak GROWTH over the program (peak minus start, the
    demo's post-re-anchor semantics), absolute metrics the plain peak."""
    peaks: dict[str, dict[str, float]] = {}
    for e, metric in enumerate(metric_names):
        # graftlint: disable=JX003 -- host data: delta_mask is a small host numpy vector
        relative = delta_mask is not None and bool(delta_mask[e])
        per_q = {}
        for qi, q in enumerate(quantiles):
            col = series[:, e, qi]
            key = f"q{int(q * 100):02d}"
            if relative:
                # graftlint: disable=JX003 -- host data: estimate_many_raw series are host numpy by design
                per_q[key] = max(float(np.max(col) - col[0]), 0.0)
            else:
                # graftlint: disable=JX003 -- host data: same host-resident series
                per_q[key] = float(np.max(col))
        peaks[metric] = per_q
    return peaks


def _relative_err(interp: np.ndarray, direct: np.ndarray,
                  scale: np.ndarray) -> float:
    """Parity metric between two ``[T, E, Q]`` series: the worst
    absolute gap, normalized per (metric, quantile) by ``scale`` — the
    peak |value| of that capacity series over the WHOLE surface.
    Normalizing by the signal's dynamic range — not pointwise values —
    is deliberate: a 1e-6-clipped quantile would otherwise turn an
    absolutely-negligible gap into an unbounded ratio."""
    a = np.asarray(interp, np.float64)
    b = np.asarray(direct, np.float64)
    return float(np.max(np.abs(a - b) / (scale + 1e-6)))


class CapacitySurfaceManager:
    """LRU of capacity surfaces keyed ``(params_hash, mix_space_hash)``
    with bounded memory, async warming, and reload-eager invalidation.

    Locking (TH001/TH002 discipline): ``_lock`` guards the store, byte
    count, epoch, in-flight set, and stats dict — and NOTHING that
    dispatches.  Surface builds (seconds) run entirely outside it;
    lookups copy the surface reference out and interpolate lock-free on
    the immutable value grid.

    Reload safety: reload paths bracket the backend swap with
    ``begin_reload()``/``end_reload(reason)``.  While a reload is in
    flight, lookups miss (direct answers ride the backend's own
    per-request consistency) and warm builds are refused; ``end_reload``
    clears the store and bumps the epoch.  Builds additionally record
    the epoch they started under and are DISCARDED on insert if a reload
    landed meanwhile — so even a router backend (same object identity
    across reloads, no params to hash) can never serve a surface built
    from pre-reload params after the swap.
    """

    def __init__(self, config):
        self.config = config
        self._lock = threading.Lock()
        self._surfaces: OrderedDict[tuple[str, str], CapacitySurface] = \
            OrderedDict()
        self._bytes = 0
        self._epoch = 0
        self._reload_depth = 0
        self._inflight: set[tuple[str, str]] = set()
        self._threads: list[threading.Thread] = []
        self._closed = False
        self._stats = {"hits": 0, "misses": 0, "frontier": 0, "builds": 0,
                       "invalidations": 0, "evictions": 0,
                       "stale_builds_dropped": 0, "build_errors": 0}
        # Prometheus twins (replace-by-name: the newest plane owns the
        # exposition; each instance keeps counting for its own healthz)
        self._m_reads = obs_metrics.REGISTRY.expose(obs_metrics.Counter(
            "deeprest_surface_reads_total",
            "what-if surface reads by outcome",
            labelnames=("outcome",)))
        self._m_builds = obs_metrics.REGISTRY.expose(obs_metrics.Counter(
            "deeprest_surface_builds_total",
            "capacity surface builds by mode",
            labelnames=("mode",)))
        self._m_build_seconds = obs_metrics.REGISTRY.expose(
            obs_metrics.Histogram(
                "deeprest_surface_build_seconds",
                "wall time building one capacity surface"))
        self._m_invalidations = obs_metrics.REGISTRY.expose(
            obs_metrics.Counter(
                "deeprest_surface_invalidations_total",
                "surface cache invalidations by reload reason",
                labelnames=("reason",)))
        self._m_evictions = obs_metrics.REGISTRY.expose(obs_metrics.Counter(
            "deeprest_surface_evictions_total",
            "surfaces evicted by the LRU bounds"))
        self._m_cached = obs_metrics.REGISTRY.expose(obs_metrics.Gauge(
            "deeprest_surface_cached",
            "capacity surfaces currently resident"))
        self._m_bytes = obs_metrics.REGISTRY.expose(obs_metrics.Gauge(
            "deeprest_surface_bytes",
            "host bytes held by resident capacity surfaces"))

    # -- keys ------------------------------------------------------------

    def params_hash_of(self, predictor) -> str:
        """Cache key half #1.  Predictors fingerprint their own params
        (:meth:`Predictor.params_digest`); backends without one (the
        replica router) key on the invalidation epoch + object identity,
        which the reload bracket bumps — staleness is structurally
        impossible either way.

        The serving quant mode is recorded IN the key (round 22): a
        surface built from int8 predictions carries that mode's parity
        envelope, so an f32 (or bf16) predictor must never answer from
        it — the digest already differs leaf-wise, the explicit suffix
        makes the contract auditable in the key itself."""
        quant = getattr(predictor, "quant", "off")
        suffix = "" if quant == "off" else f":{quant}"
        digest = getattr(predictor, "params_digest", None)
        if callable(digest):
            try:
                return str(digest()) + suffix
            # graftlint: disable=EX003 -- designed fallback: an undigestable backend degrades to epoch keying, which is strictly safe (reload bumps the epoch)
            except Exception:
                pass
        with self._lock:
            epoch = self._epoch
        return f"epoch{epoch}:{id(predictor):x}"

    # -- reads -----------------------------------------------------------

    def _get(self, key: tuple[str, str]) -> CapacitySurface | None:
        with self._lock:
            if self._reload_depth:
                return None
            surf = self._surfaces.get(key)
            if surf is not None:
                self._surfaces.move_to_end(key)
            return surf

    def lookup_program(self, predictor, program, seed: int = 0):
        """The ``/v1/whatif`` interception: if ``program`` is an
        int-rounded scaling of any cached surface's base (for the
        CURRENT params, at the request's synthesis ``seed``), answer it
        by interpolation.

        Returns ``(series [T,E,Q], meta dict)`` or None.  One lock
        section covers the scan, the LRU touch, and the stats bump —
        matching is allocation-free and bounded by ``max_surfaces``, and
        a single crossing beats three under 16-thread contention (each
        contended acquire is a scheduler handoff on the microsecond read
        path); interpolation runs outside on the immutable surface."""
        phash = self.params_hash_of(predictor)
        seed = int(seed)
        found = None
        with self._lock:
            if self._reload_depth:
                return None
            for key, surf in self._surfaces.items():
                if key[0] != phash or surf.space.seed != seed:
                    continue
                scales = surf.space.match(program)
                if scales is not None:
                    found = (key, surf, scales)
                    break
            if found is None:
                return None
            self._surfaces.move_to_end(found[0])
            self._stats["hits"] += 1
        _, surf, scales = found
        self._m_reads.inc(outcome="hit")
        return surf.interpolate(scales), surf.meta(scales)

    def query(self, predictor, estimator, base_traffic, scales=None,
              factor=None, seed: int = 0, wait: bool = False) -> dict:
        """The ``/v1/whatif/surface`` handler body: peaks (sweep
        semantics) at one point of a mix space around ``base_traffic``.

        In-cache + in-hull → interpolated, microseconds.  Cache miss →
        frontier fallback (ONE direct estimate for the queried point)
        plus an async warm of the whole surface — unless ``wait`` is set
        or async warming is disabled, in which case the build runs
        synchronously and the answer comes off the fresh surface.
        Out-of-hull points always answer from the frontier (the surface
        cannot honestly extrapolate) but still warm the space for the
        in-hull queries that follow.
        """
        cfg = self.config
        space = MixSpace(base_traffic, cfg.grid, max_axes=cfg.max_axes,
                         seed=seed)
        point = self._point_of(space, scales, factor)
        phash = self.params_hash_of(predictor)
        key = (phash, space.key)
        surf = self._get(key)
        in_hull = space.contains(point)
        if surf is None and in_hull:
            if wait or not cfg.warm_async:
                surf = self._build(predictor, estimator, space, mode="sync")
            else:
                self.maybe_warm(predictor, estimator, space)
        elif surf is None:
            self.maybe_warm(predictor, estimator, space)
        if surf is not None and in_hull:
            series = surf.interpolate(point)
            self._note_read("hit")
            meta = surf.meta(point)
        else:
            # frontier fallback: one direct (memoized) estimate of the
            # exact queried program — full model fidelity, no surface
            series = estimator.estimate_many_raw(
                [space.program_at(point)], seeds=[space.seed])[0]
            self._note_read("frontier")
            meta = {"hit": False, "frontier": True, "in_hull": in_hull,
                    "params_hash": phash, "space": space.to_meta(),
                    # graftlint: disable=JX003 -- host data: response metadata built from python floats
                    "scales": [float(s) for s in point]}
        peaks = peaks_from_series(series, predictor.metric_names,
                                  predictor.quantiles,
                                  getattr(predictor, "delta_mask", None))
        return {"peaks": peaks, "surface": meta}

    def _point_of(self, space: MixSpace, scales, factor):
        if (scales is None) == (factor is None):
            raise ValueError(
                "provide exactly one of 'scales' (per-endpoint) or "
                "'factor' (uniform)")
        if factor is not None:
            try:
                f = float(factor)
            except (TypeError, ValueError):
                raise ValueError(f"bad factor: {factor!r}") from None
            return (f,) * len(space.axes)
        if not isinstance(scales, dict):
            raise ValueError("'scales' must be {endpoint: scale}")
        point = [1.0] * len(space.axes)
        for ep, s in scales.items():
            try:
                # graftlint: disable=JX003 -- host data: payload scale values are python scalars
                v = float(s)
            except (TypeError, ValueError):
                raise ValueError(f"bad scale for {ep!r}: {s!r}") from None
            if space.axes == (SHARED_AXIS,):
                point[0] = v      # shared axis: last writer wins
                continue
            if ep not in space.axes:
                raise KeyError(
                    f"endpoint {ep!r} not an axis of this mix space "
                    f"(axes: {list(space.axes)})")
            point[space.axes.index(ep)] = v
        return tuple(point)

    # -- builds ----------------------------------------------------------

    def estimated_bytes(self, space: MixSpace, predictor) -> int:
        t = len(space.base)
        e = len(predictor.metric_names)
        q = len(predictor.quantiles)
        return space.num_vertices * t * e * q * 4

    def _build(self, predictor, estimator, space: MixSpace,
               mode: str) -> CapacitySurface | None:
        """Estimate every vertex + jitter probe in one folded batch and
        publish the surface (unless a reload landed meanwhile)."""
        cfg = self.config
        phash = self.params_hash_of(predictor)
        key = (phash, space.key)
        with self._lock:
            epoch0 = self._epoch
        if self.estimated_bytes(space, predictor) > cfg.max_bytes:
            raise ValueError(
                f"mix space too large for the surface budget: "
                f"{space.num_vertices} vertices x {len(space.base)} ticks "
                f"would exceed max_bytes={cfg.max_bytes}")
        sw = obs_metrics.Stopwatch()
        with obs_spans.RECORDER.span("surface.build",
                                     component="deeprest-surface") as sp:
            verts = space.vertices()
            probes = space.jitter_scales(cfg.jitter)
            programs = ([space.program_at(v) for v in verts]
                        + [space.program_at(p) for p in probes])
            # One folded prediction train for the WHOLE surface, sized to
            # page through the fused engine instead of looping the host.
            # Every program synthesizes at the SAME seed (the space's):
            # a vertex is then bit-identical to a direct estimate at that
            # seed, and synthesis noise is CORRELATED across vertices, so
            # interpolation error measures model nonlinearity — not
            # decorrelated noise.
            raws = estimator.estimate_many_raw(
                programs, seeds=[space.seed] * len(programs), cache=False)
            nv = len(verts)
            gshape = (len(space.grid),) * len(space.axes)
            values = np.stack(raws[:nv]).reshape(
                gshape + raws[0].shape).astype(np.float32)
            values.setflags(write=False)
            surf = CapacitySurface(space, phash, values,
                                   parity={}, build_s=0.0,
                                   programs_folded=len(programs))
            # parity envelope: the held-out probes were estimated
            # directly in the SAME batch; interpolate them off the fresh
            # surface and record the worst gap relative to each capacity
            # series' dynamic range over the surface
            flat = values.reshape(-1, *raws[0].shape)
            scale = np.max(np.abs(flat), axis=(0, 1))       # [E, Q]
            errs = [_relative_err(surf.interpolate(p), raws[nv + j], scale)
                    for j, p in enumerate(probes)]
            surf.parity = {
                "probes": len(probes),
                "max_rel_err": max(errs) if errs else 0.0,
                "mean_rel_err": (sum(errs) / len(errs)) if errs else 0.0,
            }
            surf.build_s = sw.elapsed()
            sp.tag(space=space.key, vertices=nv, probes=len(probes),
                   mode=mode)
        self._m_build_seconds.observe(surf.build_s)
        self._m_builds.inc(mode=mode)
        published = self._insert(key, surf, epoch0)
        with self._lock:
            self._stats["builds"] += 1
            if not published:
                self._stats["stale_builds_dropped"] += 1
        return surf if published else None

    def _insert(self, key, surf: CapacitySurface, epoch0: int) -> bool:
        evicted = 0
        with self._lock:
            if (self._closed or self._reload_depth
                    or self._epoch != epoch0):
                return False          # built from pre-reload params: drop
            if key not in self._surfaces:
                self._surfaces[key] = surf
                self._bytes += surf.nbytes
            self._surfaces.move_to_end(key)
            cfg = self.config
            while (len(self._surfaces) > 1
                   and (len(self._surfaces) > cfg.max_surfaces
                        or self._bytes > cfg.max_bytes)):
                _, old = self._surfaces.popitem(last=False)
                self._bytes -= old.nbytes
                evicted += 1
            self._stats["evictions"] += evicted
            n, b = len(self._surfaces), self._bytes
        if evicted:
            self._m_evictions.inc(evicted)
        self._m_cached.set(n)
        self._m_bytes.set(b)
        return True

    def maybe_warm(self, predictor, estimator, space_or_program,
                   seed: int = 0) -> bool:
        """Kick off one async build of a surface (deduplicated against
        resident surfaces and in-flight builds; bounded concurrency).
        Accepts a MixSpace or a raw traffic program to anchor one at
        (``seed`` applies only in the latter case)."""
        cfg = self.config
        space = space_or_program
        if not isinstance(space, MixSpace):
            try:
                space = MixSpace(space_or_program, cfg.grid,
                                 max_axes=cfg.max_axes, seed=seed)
            except ValueError:
                return False
        if self.estimated_bytes(space, predictor) > cfg.max_bytes:
            return False
        phash = self.params_hash_of(predictor)
        key = (phash, space.key)
        with self._lock:
            if (self._closed or self._reload_depth
                    or key in self._surfaces or key in self._inflight
                    or len(self._inflight) >= _MAX_INFLIGHT_WARMS):
                return False
            self._inflight.add(key)
            self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(
                target=self._warm_one,
                args=(predictor, estimator, space, key),
                daemon=True, name="deeprest-surface-warm")
            self._threads.append(t)
        t.start()
        return True

    def _warm_one(self, predictor, estimator, space, key) -> None:
        try:
            self._build(predictor, estimator, space, mode="warm")
        except Exception as exc:
            with self._lock:
                self._stats["build_errors"] += 1
                first = self._stats["build_errors"] == 1
            if first:
                import sys

                print(f"surface warm failed: {type(exc).__name__}: {exc}",
                      file=sys.stderr)
        finally:
            with self._lock:
                self._inflight.discard(key)

    # -- invalidation ----------------------------------------------------

    def begin_reload(self) -> None:
        """Enter the reload bracket: lookups miss and builds are refused
        until :meth:`end_reload` — no reader can observe a surface while
        the backend underneath it is mid-swap."""
        with self._lock:
            self._reload_depth += 1

    def end_reload(self, reason: str = "manual") -> None:
        """Leave the reload bracket and invalidate eagerly: the store is
        cleared and the epoch bumped, labeled with the reload ``reason``
        ("watch" cadence, the DriftController's "drift", or "manual")."""
        with self._lock:
            self._reload_depth = max(0, self._reload_depth - 1)
        self.invalidate(reason=reason)

    def invalidate(self, reason: str = "manual") -> int:
        """Drop every resident surface NOW (reason-labeled).  Returns
        the number dropped.  In-flight builds that started before this
        point are discarded at insert (epoch check)."""
        with self._lock:
            n = len(self._surfaces)
            self._surfaces.clear()
            self._bytes = 0
            self._epoch += 1
            self._stats["invalidations"] += 1
        self._m_invalidations.inc(reason=reason)
        self._m_cached.set(0)
        self._m_bytes.set(0)
        return n

    # -- lifecycle / observability ---------------------------------------

    def _note_read(self, outcome: str) -> None:
        with self._lock:
            if outcome == "hit":
                self._stats["hits"] += 1
            elif outcome == "frontier":
                self._stats["frontier"] += 1
                self._stats["misses"] += 1
            else:
                self._stats["misses"] += 1
        self._m_reads.inc(outcome=outcome)

    def note_miss(self) -> None:
        """A /v1/whatif request no cached surface could answer."""
        self._note_read("miss")

    def stats(self) -> dict:
        """The /healthz "surface" key: resident set, byte budget, and
        the full hit/miss/build/invalidation ledger, plus the parity
        envelope of the worst resident surface (honesty on the probe)."""
        with self._lock:
            surfaces = list(self._surfaces.values())
            out = {"enabled": True,
                   "surfaces": len(surfaces),
                   "bytes": self._bytes,
                   "max_surfaces": self.config.max_surfaces,
                   "max_bytes": self.config.max_bytes,
                   "inflight_warms": len(self._inflight),
                   "epoch": self._epoch,
                   **dict(self._stats)}
        out["parity_max_rel_err"] = max(
            (s.parity.get("max_rel_err", 0.0) for s in surfaces),
            default=None)
        return out

    def close(self) -> None:
        """Refuse new builds, drop the store, and JOIN the warm threads
        (idempotent) — a leaked builder would pin the estimator stack and
        trip the chaos tests' thread census."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = list(self._threads)
            self._threads = []
            self._surfaces.clear()
            self._bytes = 0
        for t in threads:
            t.join(timeout=30.0)
        self._m_cached.set(0)
        self._m_bytes.set(0)
