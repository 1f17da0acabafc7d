"""The prediction service: predict / what-if / anomaly over HTTP
(``deeprest_tpu/serve/server.py``, single engine).

Routes (all JSON but ``/metrics``):

    GET  /healthz             liveness + model dims
    GET  /v1/meta             metric names, quantiles, window, endpoints
    GET  /metrics             Prometheus text exposition (obs/metrics.py)
    GET  /v1/spans            retained spans as Jaeger query-API JSON
    GET  /v1/verdict          the streaming ok|drift|anomaly surface (503 with
                              no quality monitor attached)
    POST /v1/predict          {"traffic": [[F floats] x T]}          → [T,E,Q]
    POST /v1/whatif           {"expected_traffic": [{endpoint: n}xT]} → series
    POST /v1/whatif/scaling   {"baseline_traffic", "hypothetical_traffic"}
    POST /v1/whatif/surface   {"base_traffic", "scales"|"factor"}     → peaks
    POST /v1/anomaly          {"traffic", "observed", "tolerance"?, "min_run"?}
    POST /v1/profile          {"seconds"?, "out_dir"?} → torch.profiler window

Built on the stdlib ThreadingHTTPServer.  Concurrent requests do not each
pay a device dispatch: the service attaches a cross-request MicroBatcher
(serve/batcher.py) to the predictor, so windows from simultaneous
/v1/predict, /v1/whatif* and /v1/anomaly calls coalesce into shared
shape-laddered device batches (one captured CUDA graph per rung on a GPU)
and demultiplex back per request; ``/healthz`` exposes queue depth, the
ladder's hit statistics and the graph ledger.

The streaming verdict surface: :class:`VerdictIngestor` tails the
collector's JSONL (or takes pushed span batches, ``data/wire.py``) on a
host thread, featurizes against the served model's call-path space, feeds
an ``obs/quality.QualityMonitor`` and sweeps it through the service's
predictor snapshot (its rung graphs on a GPU); ``attach_quality`` wires it
to ``GET /v1/verdict`` and the ``deeprest_quality_*`` gauges on
``/metrics``.

The backend may also be the multi-replica routing front
(serve/router.ReplicaRouter): the same serving protocol plus an admission
hook, so every route above runs unchanged over engine or process replicas.
With it the handler meters each POST through the router's bounded,
tenant-fair admission (fast 429 + ``Retry-After`` on overload), reloads
roll one replica at a time, and ``/healthz`` gains a ``router`` key
(per-replica outstanding work, health and served counts, admission
counters, the autoscaler's decision).

The fleet tier (serve/fleet.py): ``attach_fleet`` installs a
PredictorPool, and ``X-Tenant`` then selects the MODEL on
``/v1/predict`` (the response names the tenant) and the tenant's own
monitor on ``/v1/verdict``; ``/healthz`` grows the pool's ``fleet`` view
and ``/metrics`` the ``deeprest_fleet_*`` series and the per-tenant
quality rollup, bounded to the top-K tenants plus ``__other__``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans
from deeprest_tpu_torch.serve.anomaly import AnomalyDetector
from deeprest_tpu_torch.serve.batcher import BatcherConfig, MicroBatcher
from deeprest_tpu_torch.serve.surface import CapacitySurfaceManager
from deeprest_tpu_torch.serve.whatif import WhatIfEstimator


class ServingError(ValueError):
    """Client error carrying an HTTP status (and optional extra response
    headers — e.g. ``Retry-After`` on admission-control 429s)."""

    def __init__(self, message: str, status: int = 400,
                 headers: dict[str, str] | None = None):
        super().__init__(message)
        self.status = status
        self.headers = dict(headers) if headers else {}


class CheckpointReloader:
    """Follow a checkpoint directory being written by a live trainer:
    ``poll()`` returns a fresh, warmed Predictor when a newer complete step
    has appeared, else None.

    Assumes the architecture is fixed across steps, so a mid-request swap
    only changes params/normalization stats, which are internally
    consistent within each Predictor.  The load and the fresh predictor's
    :meth:`~deeprest_tpu_torch.serve.predictor.Predictor.warm` (on CUDA,
    the capture of every rung graph) run on a background thread before
    the handoff, so no request pays a capture.

    ``load=False`` is the trigger of a process-replica plane, whose
    workers load the newest step themselves when they restart: ``poll()``
    then hands over the new step number and the front loads nothing.

    On a mesh of more than one rank (``serve --mesh``) only rank 0 holds a
    reloader, and it loads through the plane's mesh front
    (:meth:`attach_front`, serve/mesh_front.py), which has every rank load,
    warm and digest the step in step and agree before the swap.  A step
    the mesh refused is tried again after an interval that doubles with
    each refusal, up to ``MESH_RETRY_CAP`` intervals; a newer step is
    tried at once.
    """

    MESH_RETRY_CAP = 64

    def __init__(self, ckpt_dir: str, min_interval_s: float = 2.0,
                 ladder: tuple[int, ...] | None = None,
                 fused: bool = True, page_windows: int | None = None,
                 coalesce_pages: int | None = None,
                 coalesce_groups: int = 1,
                 sparse_feed: bool = False,
                 sparse_nnz_cap: int = 64,
                 quant: str = "off", device=None, load: bool = True):
        from deeprest_tpu_torch.train.checkpoint import latest_step

        self.ckpt_dir = ckpt_dir
        self.load = load
        self.min_interval_s = min_interval_s
        self.ladder = ladder      # reloaded predictors keep the serving ladder
        self.fused = fused        # ... and the fused-inference config
        self.page_windows = page_windows
        self.coalesce_pages = coalesce_pages
        self.coalesce_groups = coalesce_groups
        self.sparse_feed = sparse_feed   # ... and the sparse-feed plane
        self.sparse_nnz_cap = sparse_nnz_cap
        self.quant = quant        # ... and the quant mode (parity-gated
        #                           per reload against the stored envelope)
        self.device = device
        self._front = None         # rank 0's mesh front, once attached
        self._refused = (None, 0)  # a step the mesh refused, and how often
        self._retry_at = 0.0
        self._last_step = latest_step(ckpt_dir)
        self._next_check = 0.0
        self._pending = None       # loaded Predictor awaiting pickup
        self._loading = False
        self._lock = threading.Lock()

    def attach_front(self, front) -> None:
        """Load every new step through ``front`` (rank 0's ``MeshFront``
        of a mesh above one rank): the step is loaded on every rank."""
        # graftlint: disable=TH001,TH004 -- lifecycle handle: attach_front runs once on the serving main thread before the reloader's first poll, never in a request handler
        self._front = front

    def poll(self):
        from deeprest_tpu_torch.train.checkpoint import latest_step

        # The seconds-long load and warm-up run on a background thread:
        # the request that notices a new step must not stall on it.
        # poll() itself only hands over a finished load or kicks one off.
        with self._lock:
            if self._pending is not None:
                fresh, self._pending = self._pending, None
                return fresh
            if self._loading:
                return None
            now = time.monotonic()
            if now < self._next_check:
                return None
            self._next_check = now + self.min_interval_s
        # The directory listing stays OUTSIDE the lock: on a slow
        # filesystem a listing held under the lock would serialize every
        # concurrent request behind it.
        step = latest_step(self.ckpt_dir)
        with self._lock:
            if self._loading or step is None or step == self._last_step:
                return None
            if step == self._refused[0] and now < self._retry_at:
                return None
            self._loading = True
        threading.Thread(target=self._load, args=(step,), daemon=True).start()
        return None

    def _load(self, step: int) -> None:
        from deeprest_tpu_torch.serve.predictor import Predictor

        fresh = None
        if not self.load:
            with self._lock:
                self._last_step = step
                self._pending = step
                self._loading = False
            return
        try:
            if self._front is not None:
                fresh = self._front.reload(step)
            else:
                fresh = Predictor.from_checkpoint(
                    self.ckpt_dir, step=step, ladder=self.ladder,
                    fused=self.fused, page_windows=self.page_windows,
                    coalesce_pages=self.coalesce_pages,
                    coalesce_groups=self.coalesce_groups,
                    sparse_feed=self.sparse_feed,
                    sparse_nnz_cap=self.sparse_nnz_cap, quant=self.quant,
                    device=self.device)
                fresh.warm()
        except Exception as e:
            # Mid-write/pruned steps are expected (FileNotFoundError/
            # ValueError); anything else is printed but must never wedge
            # the reloader: _loading MUST be cleared or the server would
            # silently never reload again.  A violated quant parity
            # envelope is a ValueError but never benign: the server keeps
            # the old step and says so.
            from deeprest_tpu_torch.ops.quantize import QuantParityError

            fresh = None
            if isinstance(e, QuantParityError) or not isinstance(
                    e, (FileNotFoundError, ValueError)):
                import sys

                print(f"checkpoint reload of step {step} failed: {e!r}",
                      file=sys.stderr)
        finally:
            with self._lock:
                if fresh is not None:
                    self._last_step = step
                    self._pending = fresh
                elif self._front is not None:
                    n = (self._refused[1] + 1 if step == self._refused[0]
                         else 1)
                    self._refused = (step, n)
                    self._retry_at = time.monotonic() + self.min_interval_s \
                        * min(2 ** n, self.MESH_RETRY_CAP)
                self._loading = False


def _as_array(payload: dict, key: str, ndim: int) -> np.ndarray:
    if key not in payload:
        raise ServingError(f"missing field {key!r}")
    try:
        arr = np.asarray(payload[key], dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ServingError(f"field {key!r} is not numeric: {e}") from None
    if arr.ndim != ndim:
        raise ServingError(f"field {key!r} must be {ndim}-d, got {arr.ndim}-d")
    return arr


def _kernel_launches() -> dict[str, int]:
    from deeprest_tpu_torch.ops.cuda_gru import MODEL_KERNELS

    return {k.name: k.launches for k in MODEL_KERNELS}


def _device_memory() -> dict | None:
    """Bytes this process holds on the current card (None when it never
    set up CUDA, as the front of a process-replica plane does not)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved()}


class PredictionService:
    """Route handlers over a serving Predictor, transport-free, so tests
    can call it directly.

    ``reloader`` (optional) makes the service follow a live training
    process: before each request it is asked for a fresh predictor (or
    None to keep the current one); see :class:`CheckpointReloader`.

    ``batching`` (optional :class:`~deeprest_tpu_torch.serve.batcher.
    BatcherConfig`) attaches a cross-request MicroBatcher to the
    predictor: windows from concurrent requests coalesce into shared
    device batches.  None keeps the per-request dispatch path, through
    the same shape ladder.

    ``surface`` (optional :class:`~deeprest_tpu_torch.config.SurfaceConfig`
    with ``enabled=True``) attaches the capacity-surface plane
    (serve/surface.py): in-space ``/v1/whatif`` reads answer by
    interpolation over precomputed surfaces, ``/v1/whatif/surface`` serves
    sweep-style peak queries, and every reload invalidates the cache
    eagerly with its reason label.
    """

    def __init__(self, predictor, synthesizer=None, backend: str = "",
                 reloader=None, batching: BatcherConfig | None = None,
                 surface=None):
        self.backend = backend
        self._synthesizer = synthesizer
        self._reloader = reloader
        # HTTP-plane metrics (per-service objects, exposed replace-by-name
        # into the default registry so the newest plane owns /metrics).
        self._m_requests = obs_metrics.REGISTRY.expose(obs_metrics.Counter(
            "deeprest_http_requests_total",
            "requests by route and status code",
            labelnames=("route", "code")))
        self._m_latency = obs_metrics.REGISTRY.expose(obs_metrics.Histogram(
            "deeprest_http_request_seconds",
            "wall time handling a request, by route",
            labelnames=("route",)))
        # Guards the SWAPPABLE serving state below: ThreadingHTTPServer
        # runs every request on its own thread, and maybe_reload() swaps
        # these mid-flight.  Handlers snapshot the references under the
        # lock and then work on locals, so no device dispatch ever runs
        # while holding it; batcher drains also happen outside it.
        self._lock = threading.Lock()
        self.predictor = predictor
        self.reloads = 0
        self.batcher: MicroBatcher | None = None
        self.batching = None
        # Streaming verdict surface (obs/quality.py): attach_quality wires
        # a QualityMonitor (+ optional VerdictIngestor feeding it from the
        # collector JSONL); GET /v1/verdict renders its state.
        self.quality = None
        self._quality_ingestor = None
        # Wire firehose (data/wire.py): attach_wire registers a started
        # SpanFirehoseReceiver so /healthz renders its accounting; its
        # poller (the VerdictIngestor) owns and closes it.
        self._wire = None
        # Fleet tier (serve/fleet.py): attach_fleet installs a
        # PredictorPool; X-Tenant then selects the MODEL (pool entry),
        # not just the fairness bucket, on /v1/predict and /v1/verdict.
        self.fleet = None
        self.whatif = (WhatIfEstimator(predictor, synthesizer)
                       if synthesizer is not None else None)
        # Capacity-surface plane: a surface is built THROUGH the
        # estimator, so it stays off without a synthesizer (the CLI
        # refuses that combination up front).
        self.surface = (CapacitySurfaceManager(surface)
                        if surface is not None
                        and getattr(surface, "enabled", False)
                        and self.whatif is not None else None)
        if batching is not None:
            self.enable_batching(batching)
        # Registered LAST: the render-time collector snapshots state the
        # lines above create (replace-by-name: the newest plane owns the
        # /metrics exposition).
        obs_metrics.REGISTRY.register_collector(
            "serving", self._collect_metrics)

    # -- swappable-state management (all writes under self._lock) --------

    def _snapshot(self):
        """One consistent view of the serving backend for a request:
        ``(predictor, whatif, batcher, reloads)``.  A reload that lands
        mid-request affects the NEXT request."""
        with self._lock:
            return self.predictor, self.whatif, self.batcher, self.reloads

    def enable_batching(self, config: BatcherConfig) -> None:
        """(Re)build the cross-request MicroBatcher over the current
        predictor's shape ladder and route its traffic through it.

        A multi-replica router backend owns one batcher PER stack, so the
        config is delegated there and the service-level batcher slot stays
        empty (``/healthz`` reports per-replica batcher stats under the
        ``router`` key instead)."""
        with self._lock:
            pred = self.predictor
        if hasattr(pred, "replicas"):          # ReplicaRouter backend
            pred.enable_batching(config)
            with self._lock:
                self.batching = config
            return
        fresh = MicroBatcher(pred.ladder, config)
        pred.attach_batcher(fresh)
        with self._lock:
            old, self.batcher = self.batcher, fresh
            self.batching = config
        if old is not None:
            old.close()               # drain outside the lock

    def attach_fleet(self, pool) -> None:
        """Wire the fleet tier: ``pool`` (serve/fleet.PredictorPool)
        resolves ``X-Tenant`` to a per-tenant predictor on /v1/predict,
        serves per-tenant verdicts on /v1/verdict, and reports under the
        /healthz ``fleet`` key.  A router backend learns the pool too,
        so tenant resolution happens exactly once per request, on the
        dispatch path inside the router."""
        with self._lock:
            pred = self.predictor
        attach = getattr(pred, "attach_fleet", None)
        if callable(attach):
            attach(pool)
        with self._lock:
            self.fleet = pool

    @staticmethod
    def _fleet_entry(pool, tenant: str | None, touch: bool):
        """Tenant → pool entry, as HTTP: 404 for a tenant the pool never
        admitted.  ``touch`` picks the dispatch-path resolve (LRU touch +
        restore-if-spilled) vs the metadata peek: metadata reads must not
        perturb the eviction order, and the router path resolves inside
        the router, so the service only ever PEEKS there (one touch per
        request, never two)."""
        from deeprest_tpu_torch.serve.fleet import UnknownTenantError

        try:
            return pool.resolve(tenant) if touch else pool.peek(tenant)
        except UnknownTenantError as exc:
            raise ServingError(
                f"unknown tenant {exc.args[0]!r}: not admitted to the "
                "fleet pool", status=404) from None

    def attach_quality(self, monitor, ingestor=None) -> None:
        """Wire the streaming verdict surface: ``monitor`` backs
        ``GET /v1/verdict`` (and the deeprest_quality_* /metrics gauges
        it publishes); ``ingestor`` (a started VerdictIngestor) is owned
        by the service from here — close() stops it."""
        with self._lock:
            self.quality = monitor
            old, self._quality_ingestor = self._quality_ingestor, ingestor
        if old is not None:
            old.stop()

    def attach_wire(self, receiver) -> None:
        """Register a started SpanFirehoseReceiver for observability:
        /healthz gains a ``wire`` key with its span/drop/backpressure
        accounting.  Its lifecycle stays with its poller."""
        with self._lock:
            self._wire = receiver

    def close(self) -> None:
        """Release the batcher's worker thread, the surface builders and a
        router backend's replicas (idempotent)."""
        # Drop our render-time collector (conditionally: a rebuilt
        # service re-registers the name); a registered bound method in the
        # process-wide registry would pin the closed service and the
        # device buffers behind it forever.
        obs_metrics.REGISTRY.unregister_collector("serving",
                                                  self._collect_metrics)
        with self._lock:
            old, self.batcher = self.batcher, None
            self.batching = None
            pred = self.predictor
            ingestor, self._quality_ingestor = self._quality_ingestor, None
            surface, self.surface = self.surface, None
        if surface is not None:
            surface.close()       # join warm-builder threads
        if ingestor is not None:
            ingestor.stop()
        detach = getattr(pred, "attach_batcher", None)
        if callable(detach):
            detach(None)
        if old is not None:
            old.close()
        shutdown = getattr(pred, "close", None)   # router: drain replicas
        if callable(shutdown):
            shutdown()

    def maybe_reload(self) -> None:
        """Swap in a newer predictor if the reloader has one."""
        if self._reloader is None:
            return
        fresh = self._reloader.poll()
        if fresh is None:
            return
        self.reload_from(fresh, reason="watch")

    def reload_from(self, fresh, reason: str = "manual") -> None:
        """Swap in ``fresh`` NOW (warm it first on CUDA, or its first
        requests capture its graphs).  ``reason`` labels the reload end to
        end: a router's per-reason reload counter and the capacity-surface
        invalidation the swap forces ("watch" for the checkpoint-dir
        cadence, "manual" for operator swaps).  A router backend rolls:
        one replica stack at a time drains, swaps and rejoins.

        The surface cache is bracketed around the swap (``begin_reload``
        → swap → ``end_reload``): while the backend is mid-swap no cached
        surface is readable, and afterwards the store is empty, so no
        response can interpolate a surface built from pre-reload params.
        """
        with self._lock:
            current = self.predictor
            surface = self.surface
        if surface is not None:
            surface.begin_reload()
        try:
            self._swap_backend(current, fresh, reason)
        finally:
            if surface is not None:
                surface.end_reload(reason=reason)

    def _swap_backend(self, current, fresh, reason: str) -> None:
        if hasattr(current, "rolling_reload_from"):
            # Multi-replica router: drain and re-image one stack at a time
            # (each request is served end to end by the single backend its
            # replica held when it was dispatched).
            fresh_whatif = (WhatIfEstimator(current, self._synthesizer)
                            if self._synthesizer is not None else None)
            current.rolling_reload_from(fresh, reason=reason)
            with self._lock:
                self.whatif = fresh_whatif
                self.reloads += 1
            # rank 0 of a serving mesh: every replica was drained of the
            # older generations, so every rank drops them now
            front = getattr(fresh, "front", None)
            if front is not None:
                front.swapped(drop=True)
            return
        # Build the fresh predictor's batcher/estimator BEFORE publishing,
        # so other threads only ever see fully-wired predictors; the old
        # batcher drains and closes after the swap (a request that raced
        # it falls back to the direct laddered path: BatcherClosed is
        # handled in apply_windows).
        with self._lock:
            batching = self.batching
        fresh_batcher = None
        if batching is not None:
            fresh_batcher = MicroBatcher(fresh.ladder, batching)
            fresh.attach_batcher(fresh_batcher)
        fresh_whatif = (WhatIfEstimator(fresh, self._synthesizer)
                        if self._synthesizer is not None else None)
        with self._lock:
            old, self.batcher = self.batcher, fresh_batcher
            self.predictor = fresh
            self.whatif = fresh_whatif
            self.reloads += 1
        # rank 0 of a serving mesh: every rank now serves the fresh
        # generation (serve/mesh_front.py)
        front = getattr(fresh, "front", None)
        if front is not None:
            front.swapped()
        if old is not None:
            old.close()

    # -- GET ------------------------------------------------------------

    def admission(self, tenant: str | None):
        """Admission gate for one POST request: a router backend meters
        in-flight requests globally and per tenant (fast 429 +
        ``Retry-After`` when the plane is saturated); a single engine
        admits everything.  The handler enters this BEFORE parsing the
        request body, so shed load costs a header read, not a JSON
        parse."""
        with self._lock:
            pred = self.predictor
        admit = getattr(pred, "admit", None)
        if callable(admit):
            return admit(tenant)
        return contextlib.nullcontext()

    def _note_request(self, route: str, status: int) -> None:
        """One row in the HTTP request counter (called by the handler as
        each response is written; metric objects carry their own locks)."""
        self._m_requests.inc(route=route, code=str(status))

    def _observe_latency(self, route: str, stopwatch) -> None:
        stopwatch.observe_into(self._m_latency, route=route)

    def _collect_metrics(self, sink) -> None:
        """Render-time /metrics view of serving state already counted
        elsewhere (reload counter, batcher queue, fused-engine pages, the
        graph count, kernel launches): no hot-path cost, one source of
        truth with /healthz."""
        pred, _, batcher, reloads = self._snapshot()
        sink.counter("deeprest_serving_reloads_total", reloads,
                     help="backend hot reloads")
        if batcher is not None:
            s = batcher.stats()
            sink.gauge("deeprest_batcher_queue_windows",
                       s["queue_depth_windows"],
                       help="windows pending in the micro-batcher queue")
        fused = getattr(pred, "fused", None)
        if fused is not None:
            s = fused.stats()
            sink.counter("deeprest_fused_pages_total", s["pages"],
                         help="fused rolled-inference pages dispatched")
            sink.counter("deeprest_fused_windows_total", s["windows"],
                         help="windows through the fused engine")
        cache = getattr(pred, "jit_cache_size", None)
        if callable(cache):
            n = cache()
            if n is not None:
                sink.gauge("deeprest_plane_jit_executables", n,
                           help="compiled executables across distinct "
                                "stacks (captured CUDA graphs in the port)")
        for name, count in _kernel_launches().items():
            sink.counter("deeprest_kernel_launches_total", count,
                         help="launches of the port's CUDA kernels, graph "
                              "replays counted",
                         labels={"kernel": name})
        rec = obs_spans.RECORDER.stats()
        sink.gauge("deeprest_obs_spans_retained", rec["retained"],
                   help="spans currently in the recorder ring")
        sink.counter("deeprest_obs_spans_recorded_total", rec["recorded"],
                     help="spans committed since process start")
        with self._lock:
            pool = self.fleet
        if pool is not None:
            self._collect_fleet(sink, pool)

    @staticmethod
    def _collect_fleet(sink, pool) -> None:
        s = pool.stats()
        sink.gauge("deeprest_fleet_tenants", s["tenants"],
                   help="tenants admitted to the predictor pool")
        sink.gauge("deeprest_fleet_resident_tenants", s["resident"],
                   help="tenants with device-resident params (<= "
                        "hbm_budget)")
        sink.counter("deeprest_fleet_spills_total", s["spills"],
                     help="tenant weight sets spilled to host memory")
        sink.counter("deeprest_fleet_restores_total", s["restores"],
                     help="tenant weight sets restored from host memory")
        sink.counter("deeprest_fleet_aot_loaded_total",
                     s["aot"]["loaded"],
                     help="AOT executables loaded at admission (the "
                          "port's sidecar holds none: serve/aot.py)")
        sink.counter("deeprest_fleet_compile_fallbacks_total",
                     s["aot"]["compile_fallbacks"],
                     help="rung graphs the plane had to capture (no "
                          "executable loaded at admission)")
        # Per-tenant quality gauges, DISTINCT names from the global
        # deeprest_quality_* family (those carry a ``metric`` label; these
        # roll metrics up per tenant), bounded to the top-K tenants by
        # serve count + one __other__ row.
        for label, q in pool.quality_rollup():
            labels = {"tenant": label}
            sink.counter("deeprest_quality_tenant_sweeps_total",
                         q["sweeps"], help="quality sweeps per tenant",
                         labels=labels)
            sink.gauge("deeprest_quality_tenant_verdict", q["verdict"],
                       help="worst verdict state across the tenant's "
                            "metrics (0 ok, 1 drift, 2 anomaly)",
                       labels=labels)
            sink.gauge("deeprest_quality_tenant_anomaly_score",
                       q["anomaly_score"],
                       help="worst anomaly score across the tenant's "
                            "metrics", labels=labels)
            if q["coverage"] is not None:
                sink.gauge("deeprest_quality_tenant_band_coverage",
                           q["coverage"],
                           help="mean q-band coverage across the "
                                "tenant's metrics", labels=labels)
            if q["pinball"] is not None:
                sink.gauge("deeprest_quality_tenant_pinball_loss",
                           q["pinball"],
                           help="mean pinball loss across the "
                                "tenant's metrics", labels=labels)

    def metrics_text(self) -> str:
        """The Prometheus text exposition (``GET /metrics``)."""
        return obs_metrics.REGISTRY.render()

    def spans_jaeger(self) -> dict:
        """Retained spans as Jaeger query-API JSON (``GET /v1/spans``), the
        payload ``ingest --traces`` consumes for the self-ingestion loop
        (obs/export.py)."""
        from deeprest_tpu_torch.obs.export import spans_to_jaeger

        return spans_to_jaeger(obs_spans.RECORDER.snapshot())

    def profile(self, payload: dict) -> dict:
        """On-demand ``torch.profiler`` capture window (``POST
        /v1/profile``): the handler blocks for the window while the other
        handler threads keep serving, so the trace captures the plane
        under its live load.  One window at a time (409 when busy)."""
        import tempfile

        from deeprest_tpu_torch.obs import profiler

        try:
            seconds = float(payload.get("seconds", 1.0))
        except (TypeError, ValueError) as e:
            raise ServingError(f"bad seconds: {e}") from None
        out_dir = payload.get("out_dir") or tempfile.mkdtemp(
            prefix="deeprest-profile-")
        try:
            return profiler.capture(out_dir, seconds)
        except profiler.ProfilerBusy as e:
            raise ServingError(str(e), status=409) from None
        except ValueError as e:
            raise ServingError(str(e)) from None

    def healthz(self) -> dict:
        pred, _, batcher, reloads = self._snapshot()
        out = {
            "ok": True,
            "backend": self.backend,
            "num_metrics": len(pred.metric_names),
            "window_size": pred.window_size,
            "reloads": reloads,
        }
        router_stats = getattr(pred, "router_stats", None)
        if callable(router_stats):
            # replica plane: per-replica outstanding work and health,
            # admission counters, per-tenant grants, autoscaler decision
            out["router"] = router_stats()
        # Queue depth + shape-ladder hit stats ride on the liveness probe.
        # Batching disabled still reports the predictor's ladder.
        if batcher is not None:
            out["batcher"] = batcher.stats()
        elif getattr(pred, "ladder", None) is not None:
            out["batcher"] = None
            out["shape_ladder"] = pred.ladder.stats()
        fused = getattr(pred, "fused", None)
        if fused is not None:
            out["fused_infer"] = fused.stats()
        # the active quant mode and the stored envelope's worst cell
        envelope = getattr(pred, "parity_envelope", None)
        out["quant"] = {"mode": getattr(pred, "quant", "off")}
        if envelope is not None:
            measured = envelope.get("measured", {})
            out["quant"]["parity_max"] = (max(measured.values())
                                          if measured else None)
            out["quant"]["parity_cells"] = len(measured)
        # Fleet view: the pool's live per-tenant map and counters; without
        # one a one-tenant view over the same objects the keys above
        # render, so consumers can read fleet.tenants[...] unconditionally.
        with self._lock:
            pool = self.fleet
        if pool is not None:
            out["fleet"] = {"tenants": pool.tenant_meta(
                limit=pool.top_k_tenants), "pool": pool.stats()}
        else:
            digest = getattr(pred, "params_digest", None)
            out["fleet"] = {"tenants": {"default": {
                "quant": out["quant"]["mode"],
                "params_digest": digest() if callable(digest) else None,
                "resident": True,
            }}, "pool": None}
        with self._lock:
            wire = self._wire
        if wire is not None:
            out["wire"] = wire.stats()
        out["obs"] = obs_spans.RECORDER.stats()
        with self._lock:
            quality = self.quality
        if quality is not None:
            # summary; the per-metric table lives at GET /v1/verdict
            v = quality.verdicts()
            out["quality"] = {"armed": v.get("armed", False),
                              "sweeps": v.get("sweeps", 0),
                              "states": v.get("states")}
        with self._lock:
            surface = self.surface
        if surface is not None:
            out["surface"] = surface.stats()
        # Port-only keys: the rung graphs, the kernel launch ledger and
        # this process's device memory.
        stats = getattr(pred, "jit_cache_stats", None)
        if callable(stats):
            out["jit_cache"] = stats()
        out["kernel_launches"] = _kernel_launches()
        out["device_memory"] = _device_memory()
        front = getattr(pred, "front", None)
        if front is not None:
            # rank 0 of a serving mesh (one engine, or a router over it):
            # the calls mirrored to the others
            out["mesh"] = front.stats()
        return out

    def verdict(self, tenant: str | None = None) -> dict:
        """``GET /v1/verdict`` — the streaming per-(component,resource)
        ``ok|drift|anomaly`` surface (obs/quality.py).  503 when no monitor
        is attached (serve with --verdict-raw).

        With a fleet pool attached, ``X-Tenant`` selects the tenant's OWN
        monitor (one per pool entry): the verdict surface is per-model
        state, so it must never blend tenants."""
        with self._lock:
            pool = self.fleet
        if pool is not None:
            entry = self._fleet_entry(pool, tenant, touch=False)
            monitor = entry.quality()
            if monitor is None:
                raise ServingError(
                    f"tenant {entry.tenant!r} has no quality monitor: "
                    "build the pool with quality enabled "
                    "(FleetConfig.quality)", status=503)
            out = monitor.verdicts()
            out["tenant"] = {"name": entry.tenant,
                             "params_digest": entry.key[1],
                             "invalidations": entry.invalidations()}
            return out
        with self._lock:
            quality = self.quality
        if quality is None:
            raise ServingError(
                "no quality monitor attached: start the server with "
                "--verdict-raw <collector jsonl> (or attach_quality) to "
                "enable the streaming verdict surface", status=503)
        out = quality.verdicts()
        # the quant parity envelope: per-(metric, quantile) measured
        # deviation vs the f32 reference and the budget it is gated on
        pred, _, _, _ = self._snapshot()
        envelope = getattr(pred, "parity_envelope", None)
        if envelope is not None:
            out["quant_parity"] = {
                "mode": getattr(pred, "quant", "off"),
                "measured": dict(envelope.get("measured", {})),
                "budget": dict(envelope.get("budget", {})),
            }
        return out

    def meta(self) -> dict:
        pred, whatif, _, _ = self._snapshot()
        return {
            "backend": self.backend,
            "metric_names": pred.metric_names,
            "quantiles": list(pred.quantiles),
            "window_size": pred.window_size,
            "feature_dim": pred.feature_dim,
            "whatif_endpoints": (whatif.endpoints
                                 if whatif is not None else None),
        }

    # -- POST -----------------------------------------------------------

    @staticmethod
    def _traffic_array(payload: dict, pred) -> np.ndarray:
        traffic = _as_array(payload, "traffic", 2)
        if traffic.shape[1] != pred.feature_dim:
            raise ServingError(
                f"traffic feature dim {traffic.shape[1]} != model "
                f"{pred.feature_dim}")
        if len(traffic) < pred.window_size:
            raise ServingError(
                f"traffic length {len(traffic)} < window_size "
                f"{pred.window_size}")
        return traffic

    def predict(self, payload: dict, tenant: str | None = None) -> dict:
        pred, _, _, _ = self._snapshot()
        with self._lock:
            pool = self.fleet
        if pool is not None:
            # Fleet tier: X-Tenant selects the MODEL.  Router backends
            # resolve tenant → entry themselves (on the dispatch path,
            # exactly once); the service peeks only for the response
            # metadata.  Single-engine backends resolve here.
            router = callable(getattr(pred, "attach_fleet", None))
            entry = self._fleet_entry(pool, tenant, touch=not router)
            model = entry.predictor()
            traffic = self._traffic_array(payload, model)
            preds = (pred.predict_series(traffic, tenant=tenant)
                     if router else model.predict_series(traffic))
            pred = model               # response metadata is per-tenant
        else:
            traffic = self._traffic_array(payload, pred)
            preds = pred.predict_series(traffic)              # [T, E, Q]
        dm = getattr(pred, "delta_mask", None)
        out = {
            "metric_names": pred.metric_names,
            "quantiles": list(pred.quantiles),
            "predictions": preds.tolist(),
            # Delta-trained metrics are a RELATIVE (rollout-from-zero)
            # level series: clients must re-anchor them to an observed
            # level before treating values as absolute utilization.
            "relative_metrics": [
                m for e, m in enumerate(pred.metric_names)
                # graftlint: disable=JX003 -- host data: dm is the numpy delta mask, not a device array
                if dm is not None and bool(dm[e])
            ],
        }
        if pool is not None:
            # which pool entry answered (tenant + params_digest): clients
            # can pin responses to a weight generation across hot-swaps
            out["tenant"] = {"name": entry.tenant,
                             "params_digest": entry.key[1]}
        return out

    def _require_whatif(self, whatif) -> WhatIfEstimator:
        if whatif is None:
            raise ServingError(
                "what-if estimation unavailable: server started without a "
                "corpus to fit the trace synthesizer (--raw)", status=503)
        return whatif

    @staticmethod
    def _traffic_program(payload: dict, key: str, pred) -> list[dict]:
        prog = payload.get(key)
        if (not isinstance(prog, list) or not prog
                or not all(isinstance(p, dict) for p in prog)):
            raise ServingError(
                f"field {key!r} must be a non-empty list of "
                "{endpoint: count} objects")
        if len(prog) < pred.window_size:
            raise ServingError(
                f"{key!r} length {len(prog)} < window_size "
                f"{pred.window_size}")
        return prog

    @staticmethod
    def _seed(payload: dict) -> int:
        try:
            return int(payload.get("seed", 0))
        except (TypeError, ValueError) as e:
            raise ServingError(f"bad seed: {e}") from None

    def whatif_estimate(self, payload: dict) -> dict:
        pred, whatif, _, _ = self._snapshot()
        est = self._require_whatif(whatif)
        prog = self._traffic_program(payload, "expected_traffic", pred)
        with self._lock:
            surface = self.surface
        if surface is not None:
            # Capacity-surface interception: a program that is an
            # int-rounded scaling of a cached surface's base answers by
            # interpolation (microseconds, no dispatch).  The response
            # grows an additive "surface" key; the existing wire fields
            # are untouched.  Misses warm a surface anchored at this
            # program so the NEXT scaled variant hits.
            hit = surface.lookup_program(pred, prog,
                                         seed=self._seed(payload))
            if hit is not None:
                series_arr, meta = hit
                return {"estimates": self._bands_payload(est, series_arr),
                        "surface": meta}
            surface.note_miss()
            surface.maybe_warm(pred, est, prog, seed=self._seed(payload))
        try:
            series = est.estimate(prog, seed=self._seed(payload))
        except KeyError as e:   # unknown endpoint in the traffic program
            raise ServingError(str(e)) from None
        out = {"estimates": {
            metric: {q: v.tolist() for q, v in bands.items()}
            for metric, bands in series.items()
        }}
        if surface is not None:
            out["surface"] = {"hit": False}
        return out

    @staticmethod
    def _bands_payload(est, series_arr) -> dict:
        # one C-level transpose+tolist instead of metrics*quantiles
        # slice/tolist pairs — same payload as est._bands + tolist,
        # on the cached read path's serialization budget
        nested = np.asarray(series_arr).transpose(1, 2, 0).tolist()
        pred = est.predictor
        qkeys = [f"q{int(q * 100):02d}" for q in pred.quantiles]
        return {metric: dict(zip(qkeys, rows))
                for metric, rows in zip(pred.metric_names, nested)}

    def whatif_surface(self, payload: dict) -> dict:
        """``POST /v1/whatif/surface`` — sweep-semantics peaks at one
        point of a mix space around ``base_traffic`` (``scales`` per
        endpoint or a uniform ``factor``), answered from the capacity
        surface when resident (building it synchronously when ``wait``
        is set) and from a direct frontier estimate otherwise."""
        pred, whatif, _, _ = self._snapshot()
        est = self._require_whatif(whatif)
        with self._lock:
            surface = self.surface
        if surface is None:
            raise ServingError(
                "capacity surfaces disabled: start the server with "
                "--surface (requires --raw for the trace synthesizer)",
                status=503)
        base = self._traffic_program(payload, "base_traffic", pred)
        try:
            return surface.query(
                pred, est, base,
                scales=payload.get("scales"),
                factor=payload.get("factor"),
                seed=self._seed(payload),
                wait=bool(payload.get("wait", False)))
        except (KeyError, ValueError) as e:
            if isinstance(e, ServingError):
                raise
            raise ServingError(str(e)) from None

    def whatif_scaling(self, payload: dict) -> dict:
        pred, whatif, _, _ = self._snapshot()
        est = self._require_whatif(whatif)
        base = self._traffic_program(payload, "baseline_traffic", pred)
        hypo = self._traffic_program(payload, "hypothetical_traffic", pred)
        try:
            factors = est.scaling_factor(base, hypo, seed=self._seed(payload))
        except KeyError as e:   # unknown endpoint in either program
            raise ServingError(str(e)) from None
        return {"scaling_factors": factors}

    def anomaly(self, payload: dict) -> dict:
        pred, _, _, _ = self._snapshot()
        traffic = self._traffic_array(payload, pred)
        observed = _as_array(payload, "observed", 2)
        if len(traffic) != len(observed):
            raise ServingError("traffic and observed must have equal length")
        if observed.shape[1] != len(pred.metric_names):
            raise ServingError(
                f"observed has {observed.shape[1]} metrics, model has "
                f"{len(pred.metric_names)}")
        try:
            tolerance = float(payload.get("tolerance", 0.10))
            min_run = int(payload.get("min_run", 5))
        except (TypeError, ValueError) as e:
            raise ServingError(f"bad tolerance/min_run: {e}") from None
        detector = AnomalyDetector(pred, tolerance=tolerance,
                                   min_run=min_run)
        reports = detector.check(traffic, observed)
        return {"reports": [{
            "metric": r.metric,
            "score": r.score,
            "flagged": r.flagged,
            "first_flag_index": r.first_flag_index,
        } for r in reports], "flagged": [r.metric for r in reports if r.flagged]}


class VerdictIngestor:
    """Feed the serving plane's QualityMonitor from the collector's raw
    JSONL — the serve-side half of the streaming verdict surface.

    A daemon thread tails the same growing file the streaming trainer
    tails (train/stream.BucketTailer), featurizes each bucket against the
    SERVED model's call-path space (``predictor.space()`` — column-exact
    with training by construction), and feeds the monitor; every
    ``sweep_every_buckets`` buckets it runs a quality sweep THROUGH the
    current serving backend snapshot: the sweep's model calls ride the
    ordinary dispatch path, as any request's do (the MicroBatcher's when
    batching is on; on a GPU the predictor's captured rung graphs, a
    single-window sweep landing on the smallest rung).

    Reference handling: the drift reference auto-arms from the first
    ``live_window`` tailed buckets ("the stream you trusted at attach
    time"), and RE-ANCHORS whenever the service hot-reloads a new
    checkpoint (the fresh params trained on recent data, so recent data
    is the new no-drift baseline) — which also restarts the
    model-conditioned calibration/anomaly streams via
    ``on_model_refresh``, making post-reload band-coverage recovery
    visible instead of averaged into the stale model's tail.
    """

    def __init__(self, service: PredictionService, tailer, space, monitor,
                 poll_interval_s: float = 0.5):
        self._service = service
        self._tailer = tailer               # ingestor-thread-owned
        self._space = space
        self.monitor = monitor              # carries its own lock
        self._poll_interval_s = float(poll_interval_s)
        self._stop = threading.Event()
        # Guards the error counter (read by tests/healthz from handler
        # threads while the ingestor thread increments) and the thread
        # handle across start/stop.
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._errors = 0

    def start(self) -> "VerdictIngestor":
        t = threading.Thread(target=self._loop, daemon=True,
                             name="deeprest-verdict-ingest")
        with self._lock:
            self._thread = t
        t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)
        close = getattr(self._tailer, "close", None)
        if callable(close):
            close()

    @property
    def errors(self) -> int:
        with self._lock:
            return self._errors

    # -- the loop (ingestor thread only; cross-iteration state lives in
    # locals so nothing here is shared off-lock) -------------------------

    def _loop(self) -> None:
        since_sweep = 0
        last_reloads: int | None = None
        while not self._stop.is_set():
            try:
                got = self._tailer.poll()
                for bucket in got:
                    cols, vals = self._space.extract_sparse(bucket.traces)
                    self.monitor.observe(
                        cols, vals,
                        {m.key: m.value for m in bucket.metrics})
                    since_sweep += 1
                last_reloads = self._maybe_rebase(last_reloads)
                if (self.monitor.drift.ready and since_sweep
                        >= self.monitor.config.sweep_every_buckets):
                    since_sweep = 0
                    pred = self._service._snapshot()[0]
                    self.monitor.sweep(pred)
            except Exception as exc:
                # A malformed bucket or a mid-reload model error must not
                # kill the surface; count it (scrapeable) and keep
                # tailing — the first occurrence is printed for triage.
                with self._lock:
                    self._errors += 1
                    first = self._errors == 1
                obs_metrics.REGISTRY.counter(
                    "deeprest_verdict_ingest_errors_total",
                    "verdict-ingest loop errors (kept running)").inc()
                if first:
                    print(f"verdict-ingest: {type(exc).__name__}: {exc}")
            if not getattr(self._tailer, "backlog", False):
                self._stop.wait(self._poll_interval_s)

    def _maybe_rebase(self, last_reloads: int | None) -> int:
        cfg = self.monitor.config
        reloads = self._service._snapshot()[3]   # lock-protected read
        if last_reloads is not None and reloads != last_reloads:
            # a fresh checkpoint rolled in: recent traffic is the new
            # no-drift baseline, and calibration/anomaly restart against
            # the fresh band
            if self.monitor.observed_buckets >= cfg.min_sweep_buckets:
                self.monitor.rebase_reference()
            self.monitor.on_model_refresh()
            return reloads
        if (not self.monitor.drift.ready
                and self.monitor.observed_buckets >= cfg.live_window):
            self.monitor.rebase_reference()     # auto-arm
        return reloads


_GET_ROUTES = {"/healthz": "healthz", "/v1/meta": "meta",
               "/v1/spans": "spans_jaeger", "/v1/verdict": "verdict"}
_POST_ROUTES = {
    "/v1/predict": "predict",
    "/v1/whatif": "whatif_estimate",
    "/v1/whatif/scaling": "whatif_scaling",
    "/v1/whatif/surface": "whatif_surface",
    "/v1/anomaly": "anomaly",
}
# Ops routes skip the admission gate (as in the JAX server).
_POST_OPS_ROUTES = {"/v1/profile": "profile"}


class PredictionServer:
    """ThreadingHTTPServer wrapper owning a PredictionService.

    >>> srv = PredictionServer(service, port=0).start()
    >>> ... http requests against srv.address ...
    >>> srv.stop()

    ``batching`` forwards a :class:`BatcherConfig` to the service; None
    leaves the service's own setting alone.
    """

    def __init__(self, service: PredictionService, host: str = "127.0.0.1",
                 port: int = 0, batching: BatcherConfig | None = None):
        self.service = service
        if batching is not None:
            service.enable_batching(batching)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # quiet by default
                pass

            def _reply(self, status: int, body: dict,
                       headers: dict | None = None):
                self._reply_raw(status, json.dumps(body).encode(),
                                "application/json", headers)

            def _reply_raw(self, status: int, blob: bytes,
                           content_type: str,
                           headers: dict | None = None):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(blob)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(blob)
                outer.service._note_request(self.path, status)

            def do_GET(self):
                if self.path == "/metrics":
                    # Prometheus text exposition (0.0.4)
                    try:
                        return self._reply_raw(
                            200, outer.service.metrics_text().encode(),
                            obs_metrics.PROMETHEUS_CONTENT_TYPE)
                    except Exception as e:
                        return self._reply(500, {"error": f"internal: {e}"})
                name = _GET_ROUTES.get(self.path)
                if name is None:
                    return self._reply(404, {"error": f"no route {self.path}"})
                try:
                    outer.service.maybe_reload()
                    if name == "verdict":
                        # the verdict surface is per-tenant under a fleet
                        # pool: same header as the WRR front
                        body = outer.service.verdict(
                            self.headers.get("X-Tenant"))
                    else:
                        body = getattr(outer.service, name)()
                    self._reply(200, body)
                except ServingError as e:   # e.g. /v1/verdict unattached
                    self._reply(e.status, {"error": str(e)},
                                headers=e.headers)
                except Exception as e:  # never drop the connection silently
                    self._reply(500, {"error": f"internal: {e}"})

            def do_POST(self):
                ops_name = _POST_OPS_ROUTES.get(self.path)
                name = ops_name or _POST_ROUTES.get(self.path)
                if name is None:
                    return self._reply(404, {"error": f"no route {self.path}"})
                sw = obs_metrics.Stopwatch()
                try:
                    # the request-scoped trace root: every span recorded
                    # below it (batcher worker, fused engine, across
                    # threads) shares this request's trace id
                    with obs_spans.RECORDER.span(
                            self.path,
                            component="deeprest-predictor") as root:
                        outer.service.maybe_reload()
                        length = int(self.headers.get("Content-Length", 0))
                        # the body must be drained either way (keep-alive
                        # framing), but it stays UNPARSED until admission:
                        # a shed request costs a read, not a JSON decode
                        raw = self.rfile.read(length)
                        # the tenant tag of the JAX plane's admission
                        # gate; absent header = the shared default tenant
                        tenant = self.headers.get("X-Tenant")
                        root.tag(tenant=tenant or "default")
                        if ops_name is not None:
                            # ops route: no admission gate (see
                            # _POST_OPS_ROUTES)
                            payload = json.loads(raw or b"{}")
                            if not isinstance(payload, dict):
                                raise ServingError(
                                    "request body must be a JSON object")
                            self._reply(
                                200, getattr(outer.service, name)(payload))
                        else:
                            with outer.service.admission(tenant):
                                payload = json.loads(raw or b"{}")
                                if not isinstance(payload, dict):
                                    raise ServingError(
                                        "request body must be a JSON object")
                                if name == "predict":
                                    # tenant → model under a fleet pool
                                    # (no pool: the kwarg is ignored)
                                    body = outer.service.predict(
                                        payload, tenant=tenant)
                                else:
                                    body = getattr(
                                        outer.service, name)(payload)
                                self._reply(200, body)
                except ServingError as e:
                    self._reply(e.status, {"error": str(e)},
                                headers=e.headers)
                except json.JSONDecodeError as e:
                    self._reply(400, {"error": f"bad JSON: {e}"})
                except Exception as e:  # handler bug: 500, not a dead socket
                    self._reply(500, {"error": f"internal: {e}"})
                finally:
                    outer.service._observe_latency(self.path, sw)

        class _Server(ThreadingHTTPServer):
            # The stdlib default listen backlog (5) drops SYNs when many
            # clients connect at once; the kernel's ~1s retransmit then
            # shows up as a phantom p99 latency cliff.
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    def start(self) -> "PredictionServer":
        # graftlint: disable=TH001 -- lifecycle handle: start/stop run on the owning driver thread only, never in a request handler
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.service.close()       # drain + join the batcher worker
