"""The prediction service: predict / what-if / anomaly over HTTP
(``deeprest_tpu/serve/server.py``, single engine).

Routes (all JSON but ``/metrics``):

    GET  /healthz             liveness + model dims
    GET  /v1/meta             metric names, quantiles, window, endpoints
    GET  /metrics             Prometheus text exposition (obs/metrics.py)
    GET  /v1/spans            retained spans as Jaeger query-API JSON
    GET  /v1/verdict          503: no quality monitor (ROADMAP queue 1, item 5)
    POST /v1/predict          {"traffic": [[F floats] x T]}          → [T,E,Q]
    POST /v1/whatif           {"expected_traffic": [{endpoint: n}xT]} → series
    POST /v1/whatif/scaling   {"baseline_traffic", "hypothetical_traffic"}
    POST /v1/whatif/surface   {"base_traffic", "scales"|"factor"}     → peaks
    POST /v1/anomaly          {"traffic", "observed", "tolerance"?, "min_run"?}
    POST /v1/profile          501: the profiler is ROADMAP queue 1, item 7

Built on the stdlib ThreadingHTTPServer.  Concurrent requests do not each
pay a device dispatch: the service attaches a cross-request MicroBatcher
(serve/batcher.py) to the predictor, so windows from simultaneous
/v1/predict, /v1/whatif* and /v1/anomaly calls coalesce into shared
shape-laddered device batches (one captured CUDA graph per rung on a GPU)
and demultiplex back per request; ``/healthz`` exposes queue depth, the
ladder's hit statistics and the graph ledger.

The JAX server's replica router, fleet pool, verdict ingestor, span wire
and profiler belong to later slices of the port; admission admits
everything, as on a single JAX engine.
"""

from __future__ import annotations

import contextlib
import json
import threading
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
    """

    def __init__(self, ckpt_dir: str, min_interval_s: float = 2.0,
                 ladder: tuple[int, ...] | None = None,
                 fused: bool = True, page_windows: int | None = None,
                 coalesce_pages: int | None = None,
                 coalesce_groups: int = 1, device=None):
        from deeprest_tpu_torch.train.checkpoint import latest_step

        self.ckpt_dir = ckpt_dir
        self.min_interval_s = min_interval_s
        self.ladder = ladder      # reloaded predictors keep the serving ladder
        self.fused = fused        # ... and the fused-inference config
        self.page_windows = page_windows
        self.coalesce_pages = coalesce_pages
        self.coalesce_groups = coalesce_groups
        self.device = device
        self._last_step = latest_step(ckpt_dir)
        self._next_check = 0.0
        self._pending = None       # loaded Predictor awaiting pickup
        self._loading = False
        self._lock = threading.Lock()

    def poll(self):
        import time

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
            self._loading = True
        threading.Thread(target=self._load, args=(step,), daemon=True).start()
        return None

    def _load(self, step: int) -> None:
        from deeprest_tpu_torch.serve.predictor import Predictor

        fresh = None
        try:
            fresh = Predictor.from_checkpoint(
                self.ckpt_dir, step=step, ladder=self.ladder,
                fused=self.fused, page_windows=self.page_windows,
                coalesce_pages=self.coalesce_pages,
                coalesce_groups=self.coalesce_groups, device=self.device)
            fresh.warm()
        except Exception as e:
            # Mid-write/pruned steps are expected (FileNotFoundError/
            # ValueError); anything else is printed but must never wedge
            # the reloader: _loading MUST be cleared or the server would
            # silently never reload again.
            fresh = None
            if not isinstance(e, (FileNotFoundError, ValueError)):
                import sys

                print(f"checkpoint reload of step {step} failed: {e!r}",
                      file=sys.stderr)
        finally:
            with self._lock:
                if fresh is not None:
                    self._last_step = step
                    self._pending = fresh
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
        predictor's shape ladder and route its traffic through it."""
        with self._lock:
            pred = self.predictor
        fresh = MicroBatcher(pred.ladder, config)
        pred.attach_batcher(fresh)
        with self._lock:
            old, self.batcher = self.batcher, fresh
            self.batching = config
        if old is not None:
            old.close()               # drain outside the lock

    def close(self) -> None:
        """Release the batcher's worker thread and the surface builders
        (idempotent)."""
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
            surface, self.surface = self.surface, None
        if surface is not None:
            surface.close()       # join warm-builder threads
        detach = getattr(pred, "attach_batcher", None)
        if callable(detach):
            detach(None)
        if old is not None:
            old.close()

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
        requests capture its graphs).  ``reason`` labels the capacity-
        surface invalidation the swap forces: "watch" for the
        checkpoint-dir cadence, "manual" for operator swaps.

        The surface cache is bracketed around the swap (``begin_reload``
        → swap → ``end_reload``): while the backend is mid-swap no cached
        surface is readable, and afterwards the store is empty, so no
        response can interpolate a surface built from pre-reload params.
        """
        with self._lock:
            surface = self.surface
            batching = self.batching
        if surface is not None:
            surface.begin_reload()
        try:
            # Build the fresh predictor's batcher/estimator BEFORE
            # publishing, so other threads only ever see fully-wired
            # predictors; the old batcher drains and closes after the
            # swap (a request that raced it falls back to the direct
            # laddered path: BatcherClosed is handled in apply_windows).
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
            if old is not None:
                old.close()
        finally:
            if surface is not None:
                surface.end_reload(reason=reason)

    # -- GET ------------------------------------------------------------

    def admission(self, tenant: str | None):
        """Admission gate for one POST request: a single engine admits
        everything (the JAX router's 429 path is a later slice)."""
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
        """``POST /v1/profile``: not ported yet (501)."""
        raise ServingError(
            "profiling is not ported yet: the torch.profiler capture window "
            "is ROADMAP queue 1, item 7 (serving plane and tools)",
            status=501)

    def healthz(self) -> dict:
        pred, _, batcher, reloads = self._snapshot()
        out = {
            "ok": True,
            "backend": self.backend,
            "num_metrics": len(pred.metric_names),
            "window_size": pred.window_size,
            "reloads": reloads,
        }
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
        out["quant"] = {"mode": "off"}
        # One-tenant fleet view over the same objects the keys above
        # render, so consumers can read fleet.tenants[...] unconditionally.
        digest = getattr(pred, "params_digest", None)
        out["fleet"] = {"tenants": {"default": {
            "quant": "off",
            "params_digest": digest() if callable(digest) else None,
            "resident": True,
        }}, "pool": None}
        out["obs"] = obs_spans.RECORDER.stats()
        with self._lock:
            surface = self.surface
        if surface is not None:
            out["surface"] = surface.stats()
        # Port-only keys: the rung graphs and the kernel launch ledger.
        stats = getattr(pred, "jit_cache_stats", None)
        if callable(stats):
            out["jit_cache"] = stats()
        out["kernel_launches"] = _kernel_launches()
        return out

    def verdict(self) -> dict:
        """``GET /v1/verdict``: 503, as the JAX server answers with no
        quality monitor attached; the streaming verdict surface is a later
        slice of the port."""
        raise ServingError(
            "no quality monitor attached: the streaming verdict surface "
            "(--verdict-raw) is not ported yet (ROADMAP queue 1, item 5)",
            status=503)

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

    def predict(self, payload: dict) -> dict:
        pred, _, _, _ = self._snapshot()
        traffic = self._traffic_array(payload, pred)
        preds = pred.predict_series(traffic)                  # [T, E, Q]
        dm = getattr(pred, "delta_mask", None)
        return {
            "metric_names": pred.metric_names,
            "quantiles": list(pred.quantiles),
            "predictions": preds.tolist(),
            # Delta-trained metrics are a RELATIVE (rollout-from-zero)
            # level series: clients must re-anchor them to an observed
            # level before treating values as absolute utilization.
            "relative_metrics": [
                m for e, m in enumerate(pred.metric_names)
                if dm is not None and bool(dm[e])
            ],
        }

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
                                body = getattr(outer.service, name)(payload)
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
