"""The routing front: least-outstanding-work dispatch, admission control,
per-tenant fairness, health ejection with retry, and zero-downtime rolling
reload over engine replicas (``deeprest_tpu/serve/router.py``, less the
fleet tier).

The replicas are :mod:`serve/replica.py` stacks, and this router IS the
serving backend the HTTP service sees: it exposes the protocol of a single
Predictor (``predict_series``, ``predict_series_many``, metadata,
``y_stats``, ``space``, ``median_index``), so PredictionService,
WhatIfEstimator and AnomalyDetector run unchanged on one engine or on
many.

Policies:

- **Dispatch**: least outstanding work.  Each request goes to the live
  replica with the fewest windows in flight (ties round-robin).
- **Admission**: a bounded global in-flight depth.  Beyond it requests
  FAIL FAST with 429 + ``Retry-After`` instead of queueing into collapse;
  a small bounded wait absorbs micro-bursts, and the queue is bounded.
- **Fairness**: smooth weighted round-robin over the ``X-Tenant`` key
  (unknown tenants weigh 1).
- **Health**: a dead worker ejects at once, a live one after
  ``eject_after_failures`` consecutive failures; a request that provably
  never executed is retried on a survivor within ``retry_budget``; a
  background probe restarts ejected process replicas and rejoins them.
- **Rolling reload**: drain one stack at a time, swap it, and re-admit it
  before touching the next, so no response mixes old and new params.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np

from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans
from deeprest_tpu_torch.serve.replica import (
    EngineReplica, ProcessReplica, ReplicaDeadError, _canonical_device,
    clone_backend,
)
from deeprest_tpu_torch.serve.server import ServingError


class AdmissionError(ServingError):
    """The plane is saturated: fast 429 with a Retry-After hint."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message, status=429,
                         headers={"Retry-After": f"{retry_after_s:.3f}"})
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Admission/fairness/health knobs for :class:`ReplicaRouter`.

    ``admission_depth`` bounds concurrently ADMITTED requests across the
    whole plane; ``max_waiting`` bounds the short fairness queue behind it
    (everything beyond fails fast).  ``max_wait_s`` is how long a request
    may sit in that queue before it too turns into a 429.

    Health: ``replica_timeout_s`` is the per-request deadline handed to
    process replicas; ``eject_after_failures`` consecutive dead-replica
    failures eject a replica from dispatch; ``retry_budget`` bounds how
    many times one request may be re-dispatched onto survivors (ONLY for
    failures proving the request never produced, and never will produce,
    a response: worker dead or send failed); ``probe_interval_s`` paces
    the background probe that restarts ejected process replicas and
    rejoins them.
    """

    admission_depth: int = 64
    max_waiting: int | None = None        # default: == admission_depth
    max_wait_s: float = 0.25
    retry_after_s: float = 0.05
    tenant_weights: dict[str, float] | None = None
    default_tenant: str = "default"
    replica_timeout_s: float | None = 30.0
    eject_after_failures: int = 3
    retry_budget: int = 1
    probe_interval_s: float = 0.5

    def __post_init__(self):
        if self.admission_depth < 1:
            raise ValueError(
                f"admission_depth {self.admission_depth} must be >= 1")
        if self.max_waiting is not None and self.max_waiting < 0:
            raise ValueError(f"max_waiting {self.max_waiting} must be >= 0")
        if self.max_wait_s < 0 or self.retry_after_s < 0:
            raise ValueError("max_wait_s/retry_after_s must be >= 0")
        for t, w in (self.tenant_weights or {}).items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight {w} must be > 0")
        if self.replica_timeout_s is not None and self.replica_timeout_s <= 0:
            raise ValueError(
                f"replica_timeout_s {self.replica_timeout_s} must be > 0 "
                "(None = no deadline)")
        if self.eject_after_failures < 1:
            raise ValueError(f"eject_after_failures "
                             f"{self.eject_after_failures} must be >= 1")
        if self.retry_budget < 0:
            raise ValueError(f"retry_budget {self.retry_budget} "
                             "must be >= 0")
        if self.probe_interval_s <= 0:
            raise ValueError(f"probe_interval_s {self.probe_interval_s} "
                             "must be > 0")

    @property
    def waiting_bound(self) -> int:
        return (self.admission_depth if self.max_waiting is None
                else self.max_waiting)


@dataclasses.dataclass
class _ReplicaHealth:
    """Per-replica health the router tracks across dispatches (all
    mutations under the router lock)."""

    consecutive_failures: int = 0
    ejected: bool = False
    ejections: int = 0
    rejoins: int = 0
    last_error: str | None = None


class _Waiter:
    __slots__ = ("event", "granted")

    def __init__(self):
        self.event = threading.Event()
        self.granted = False


class WeightedAdmission:
    """Bounded in-flight slots granted in smooth-WRR order per tenant.

    Smooth weighted round-robin (the nginx algorithm): each grant adds
    every waiting tenant's weight to its credit, picks the max-credit
    tenant, and charges it the total active weight; over time grants
    converge to the weight ratio, without bursts.
    """

    def __init__(self, config: RouterConfig):
        self.config = config
        self._lock = threading.Lock()
        self._inflight = 0
        self._waiting: dict[str, collections.deque[_Waiter]] = {}
        self._credit: dict[str, float] = {}
        # The admission counters are obs metrics (one source of truth for
        # stats(), the autoscaler's demand read and /metrics), per
        # instance and exposed replace-by-name.  "queued" is monotone.
        self._m_admission = obs_metrics.Counter(
            "deeprest_admission_requests_total",
            "admission outcomes across the serving plane",
            labelnames=("outcome",))
        self._m_tenants = obs_metrics.Counter(
            "deeprest_admission_tenant_requests_total",
            "per-tenant admission outcomes (X-Tenant WRR key)",
            labelnames=("tenant", "outcome"))
        self._m_in_plane = obs_metrics.Histogram(
            "deeprest_in_plane_latency_seconds",
            "admission grant -> response written (the latency window "
            "the admission bound controls)")
        for m in (self._m_admission, self._m_tenants, self._m_in_plane):
            obs_metrics.REGISTRY.expose(m)
        # In-plane latency window (admission grant → response written);
        # the deque keeps the exact-percentile JSON view, the histogram
        # above is the scrapeable twin.
        self._latencies: collections.deque[float] = collections.deque(
            maxlen=8192)

    def _weight(self, tenant: str) -> float:
        return (self.config.tenant_weights or {}).get(tenant, 1.0)

    def _note(self, tenant: str, outcome: str) -> None:
        self._m_admission.inc(outcome=outcome)
        self._m_tenants.inc(tenant=tenant, outcome=outcome)

    def try_acquire(self, tenant: str | None) -> "_AdmissionTicket":
        cfg = self.config
        tenant = tenant or cfg.default_tenant
        waiter = None
        with self._lock:
            if self._inflight < cfg.admission_depth and not any(
                    self._waiting.values()):
                self._inflight += 1
                self._note(tenant, "admitted")
                return _AdmissionTicket(self, tenant)
            total_waiting = sum(len(q) for q in self._waiting.values())
            if cfg.max_wait_s <= 0 or total_waiting >= cfg.waiting_bound:
                self._note(tenant, "rejected")
                raise AdmissionError(
                    f"serving plane saturated ({self._inflight} in flight, "
                    f"{total_waiting} waiting); retry after "
                    f"{cfg.retry_after_s:.3f}s", cfg.retry_after_s)
            waiter = _Waiter()
            self._waiting.setdefault(tenant, collections.deque()).append(
                waiter)
            self._note(tenant, "queued")
        waiter.event.wait(cfg.max_wait_s)
        with self._lock:
            if waiter.granted:
                self._note(tenant, "admitted")
                return _AdmissionTicket(self, tenant)
            # timed out: withdraw from the queue (a grant may race us;
            # granted wins, checked under the lock)
            q = self._waiting.get(tenant)
            if q is not None and waiter in q:
                q.remove(waiter)
                if not q:
                    del self._waiting[tenant]
            if waiter.granted:
                self._note(tenant, "admitted")
                return _AdmissionTicket(self, tenant)
            self._note(tenant, "rejected")
        raise AdmissionError(
            f"serving plane saturated (waited {cfg.max_wait_s:.3f}s); "
            f"retry after {cfg.retry_after_s:.3f}s", cfg.retry_after_s)

    def release(self, in_plane_s: float | None = None) -> None:
        with self._lock:
            self._inflight -= 1
            if in_plane_s is not None:
                self._latencies.append(in_plane_s)
                self._m_in_plane.observe(in_plane_s)
            self._grant_next_locked()

    def reset_window(self) -> None:
        """Start a fresh in-plane latency window (bench cell boundary)."""
        with self._lock:
            self._latencies.clear()

    def _grant_next_locked(self) -> None:
        cfg = self.config
        while (self._inflight < cfg.admission_depth
               and any(self._waiting.values())):
            active = [t for t, q in self._waiting.items() if q]
            total = sum(self._weight(t) for t in active)
            best = None
            for t in active:
                self._credit[t] = self._credit.get(t, 0.0) + self._weight(t)
                if best is None or self._credit[t] > self._credit[best]:
                    best = t
            self._credit[best] -= total
            waiter = self._waiting[best].popleft()
            if not self._waiting[best]:
                del self._waiting[best]
            waiter.granted = True
            self._inflight += 1
            waiter.event.set()

    def counts(self) -> dict[str, int]:
        """Monotone admission outcome totals off the obs counters (what
        the autoscaler's demand read consumes)."""
        series = self._m_admission.series()
        return {k: int(series.get((k,), 0.0))
                for k in ("admitted", "rejected", "queued")}

    def stats(self) -> dict:
        tenants: dict[str, dict[str, int]] = {}
        for (tenant, outcome), v in self._m_tenants.series().items():
            if outcome in ("admitted", "rejected"):
                tenants.setdefault(
                    tenant, {"admitted": 0, "rejected": 0})[outcome] = int(v)
        with self._lock:
            lats = sorted(self._latencies)
            out = {
                "depth": self.config.admission_depth,
                "inflight": self._inflight,
                "waiting": sum(len(q) for q in self._waiting.values()),
                **self.counts(),
                "tenants": {t: tenants[t] for t in sorted(tenants)},
            }

        def pct(p):
            if not lats:
                return None
            k = min(len(lats) - 1, int(round(p / 100 * (len(lats) - 1))))
            return round(1e3 * lats[k], 3)

        out["in_plane_p50_ms"] = pct(50)
        out["in_plane_p99_ms"] = pct(99)
        return out


class _AdmissionTicket:
    """Context manager covering one admitted request end to end; its
    lifetime is the request's in-plane latency sample (observed into the
    admission latency histogram on release)."""

    __slots__ = ("_admission", "tenant", "_sw")

    def __init__(self, admission: WeightedAdmission, tenant: str):
        self._admission = admission
        self.tenant = tenant
        self._sw = obs_metrics.Stopwatch()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._admission.release(in_plane_s=self._sw.elapsed())
        return False


def _stack_key(replica) -> int:
    """Replicas sharing one in-process stack share a key; a process
    replica is its own."""
    backend = getattr(replica, "backend", None)
    return id(backend()) if callable(backend) else id(replica)


def _thread_devices(backend) -> list:
    """Every card for a CUDA backend (``torch.cuda.device_count()``), the
    backend's own device otherwise."""
    import torch

    device = _canonical_device(backend.device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _boot_all(spec: dict, names: list[str],
              request_timeout_s: float | None) -> list:
    """One ProcessReplica per name, booted concurrently (each worker
    builds its stack and captures its graphs on its own); a failing boot
    closes the workers that did come up, then raises."""
    from concurrent.futures import ThreadPoolExecutor

    if not names:
        return []
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = [pool.submit(ProcessReplica, spec, name=name,
                               request_timeout_s=request_timeout_s)
                   for name in names]
    booted, errors = [], []
    for f in futures:
        try:
            booted.append(f.result())
        except Exception as exc:
            errors.append(exc)
    if errors:
        for r in booted:
            r.close()
        raise errors[0]
    return booted


class ReplicaRouter:
    """N replicas behind the single-predictor serving protocol."""

    def __init__(self, replicas: list, config: RouterConfig | None = None,
                 batching=None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.config = config or RouterConfig()
        self.admission = WeightedAdmission(self.config)
        # Guards the replica registry (the autoscaler grows/shrinks it and
        # the rolling reload flips drain states while handler threads pick
        # replicas) and the counters below.
        self._lock = threading.Lock()
        self._replicas = list(replicas)
        self._rr = 0                   # round-robin tiebreak cursor
        self._reloads = 0
        self._last_reload_reason: str | None = None
        self._dispatched = 0
        self._batching = batching
        self._autoscaler_decision: dict | None = None
        # Per-replica health (keyed by object identity: names recycle
        # across scale_to generations) + the probe-and-rejoin thread,
        # started at the first ejection and parked once every replica is
        # live again.
        self._health: dict[int, _ReplicaHealth] = {}
        self._probe_thread: threading.Thread | None = None
        self._probe_stop = threading.Event()
        self._closed = False
        self._m_ejections = obs_metrics.Counter(
            "deeprest_router_ejections_total",
            "replicas ejected from dispatch by the health layer",
            labelnames=("replica",))
        self._m_retries = obs_metrics.Counter(
            "deeprest_router_retries_total",
            "requests re-dispatched onto a survivor after a dead replica",
            labelnames=("replica",))
        self._m_rejoins = obs_metrics.Counter(
            "deeprest_router_rejoins_total",
            "ejected replicas probed healthy and re-admitted to dispatch",
            labelnames=("replica",))
        self._m_reloads_by_reason = obs_metrics.Counter(
            "deeprest_router_reloads_by_reason_total",
            "rolling reloads by trigger (watch/drift/manual)",
            labelnames=("reason",))
        for m in (self._m_ejections, self._m_retries, self._m_rejoins,
                  self._m_reloads_by_reason):
            obs_metrics.REGISTRY.expose(m)
        self._meta = self._probe_meta(replicas[0])
        # Render-time /metrics view over the replica plane (replace-by-
        # name: the newest router owns the exposition).
        obs_metrics.REGISTRY.register_collector("router",
                                                self._collect_metrics)

    @staticmethod
    def _probe_meta(replica) -> dict:
        backend = getattr(replica, "backend", None)
        if callable(backend):
            b = backend()
            return {
                "metric_names": list(b.metric_names),
                "window_size": b.window_size,
                "feature_dim": b.feature_dim,
                "quantiles": tuple(b.quantiles),
                "median_index": b.median_index(),
                "delta_mask": (np.asarray(b.delta_mask, bool)
                               if b.delta_mask is not None else None),
                "space_dict": getattr(b, "space_dict", None),
                "y_stats": getattr(b, "y_stats", None),
            }
        meta = replica._meta            # ProcessReplica boot handshake
        y_stats = None
        if meta.get("y_stats") is not None:
            from deeprest_tpu_torch.data.windows import MinMaxStats

            y_stats = MinMaxStats.from_dict(meta["y_stats"])
        return {
            "metric_names": list(meta["metric_names"]),
            "window_size": int(meta["window_size"]),
            "feature_dim": int(meta["feature_dim"]),
            "quantiles": tuple(meta["quantiles"]),
            "median_index": int(meta["median_index"]),
            "delta_mask": (np.asarray(meta["delta_mask"], bool)
                           if meta.get("delta_mask") is not None else None),
            "space_dict": meta.get("space_dict"),
            "y_stats": y_stats,
        }

    # -- construction ----------------------------------------------------

    @classmethod
    def build(cls, backend, n: int, config: RouterConfig | None = None,
              batching=None, devices=None) -> "ReplicaRouter":
        """N in-process replicas over ``backend``, round-robin across
        ``devices`` (default: every card for a CUDA backend, else the
        backend's device).  Replicas on the SAME device share one stack
        (``backend`` itself on its own device, a clone elsewhere), so
        replicas beyond the device count add scheduling slots, not
        captured graphs."""
        if n < 1:
            raise ValueError(f"replica count {n} must be >= 1")
        if devices is None:
            devices = _thread_devices(backend)
        from deeprest_tpu_torch.serve.batcher import MicroBatcher

        by_device: dict = {_canonical_device(backend.device): backend}
        replicas = []
        for i in range(n):
            dev = _canonical_device(devices[i % len(devices)])
            stack = by_device.get(dev)
            if stack is None:
                stack = by_device[dev] = clone_backend(backend, device=dev)
            if batching is not None and stack.batcher is None:
                stack.attach_batcher(MicroBatcher(stack.ladder, batching))
            replicas.append(EngineReplica(stack, name=f"r{i}", device=dev,
                                          batching=batching))
        return cls(replicas, config=config, batching=batching)

    @classmethod
    def build_process(cls, spec: dict, n: int,
                      config: RouterConfig | None = None,
                      batching=None) -> "ReplicaRouter":
        """N worker-subprocess replicas from one spec, booted concurrently
        (each child builds and owns its full stack; see
        serve/replica.ProcessReplica)."""
        if n < 1:
            raise ValueError(f"replica count {n} must be >= 1")
        config = config or RouterConfig()
        if batching is not None:
            spec = dict(spec)
            spec["batching"] = {"max_batch": batching.max_batch,
                                "max_linger_s": batching.max_linger_s,
                                "max_queue": batching.max_queue}
        replicas = _boot_all(spec, [f"p{i}" for i in range(n)],
                             config.replica_timeout_s)
        return cls(replicas, config=config, batching=batching)

    # -- serving protocol (what PredictionService consumes) --------------

    def _meta_get(self, key: str):
        with self._lock:       # a rolling reload re-probes self._meta
            return self._meta[key]

    @property
    def metric_names(self) -> list[str]:
        return self._meta_get("metric_names")

    @property
    def window_size(self) -> int:
        return self._meta_get("window_size")

    @property
    def feature_dim(self) -> int:
        return self._meta_get("feature_dim")

    @property
    def quantiles(self) -> tuple[float, ...]:
        return self._meta_get("quantiles")

    @property
    def delta_mask(self):
        return self._meta_get("delta_mask")

    @property
    def space_dict(self):
        return self._meta_get("space_dict")

    @property
    def y_stats(self):
        """Target normalization stats (the AnomalyDetector's scale-floor
        source), probed from the lead replica like the rest of the
        metadata."""
        return self._meta_get("y_stats")

    def median_index(self) -> int:
        return self._meta_get("median_index")

    def space(self):
        space_dict = self._meta_get("space_dict")
        if space_dict is None:
            return None
        from deeprest_tpu_torch.data.featurize import CallPathSpace

        return CallPathSpace.from_dict(space_dict)

    def admit(self, tenant: str | None):
        """The PredictionService admission hook (fast 429 on overload)."""
        return self.admission.try_acquire(tenant)

    def _health_locked(self, replica) -> _ReplicaHealth:
        """The replica's health record (caller holds ``self._lock``)."""
        h = self._health.get(id(replica))
        if h is None:
            h = self._health[id(replica)] = _ReplicaHealth()
        return h

    def _pick(self, excluded: frozenset = frozenset()):
        """Least-outstanding-work LIVE replica (ties: round-robin),
        skipping ejected replicas and this request's ``excluded`` set
        (replicas that already failed it).  Waits briefly only through a
        rolling reload's drain gap; a plane whose every candidate is
        ejected or excluded sheds FAST with a 503 instead of hanging."""
        deadline = time.monotonic() + 5.0
        while True:
            with self._lock:
                candidates = [r for r in self._replicas
                              if id(r) not in excluded]
                live = [r for r in candidates
                        if r.available()
                        and not self._health_locked(r).ejected]
                if live:
                    self._rr += 1
                    best = min(
                        range(len(live)),
                        key=lambda i: (live[i].outstanding(),
                                       (i - self._rr) % len(live)))
                    self._dispatched += 1
                    return live[best]
                # a DRAINING (non-ejected) candidate is a reload gap, worth
                # a bounded wait; never wait when this request already
                # burned a replica
                recoverable = not excluded and any(
                    not self._health_locked(r).ejected
                    for r in candidates)
            if not recoverable or time.monotonic() > deadline:
                raise ServingError(
                    "no live replica (plane reloading, replicas ejected, "
                    "or shut down)", status=503)
            time.sleep(0.005)

    def _dispatch(self, call, tags: dict):
        """One request through the health layer: dispatch, and on a typed
        ReplicaDeadError note the failure (possibly ejecting the replica)
        and, ONLY when the error proves the request never produced and
        can never produce a response, re-dispatch onto a survivor, at
        most ``retry_budget`` times.  Every other exception is a
        request-level error and propagates untouched."""
        cfg = self.config
        excluded: set[int] = set()
        retries = 0
        while True:
            replica = self._pick(frozenset(excluded))
            try:
                with obs_spans.RECORDER.span(
                        "router.dispatch",
                        component="deeprest-router") as sp:
                    sp.tag(replica=replica.name, **tags)
                    if retries:
                        sp.tag(retry=retries)
                    out = call(replica)
            except ReplicaDeadError as exc:
                self._note_replica_failure(replica, exc)
                excluded.add(id(replica))
                if not exc.retriable:
                    raise ServingError(
                        f"replica {replica.name} failed mid-request and "
                        f"the request may still be executing ({exc}); "
                        "not retried — no double-execution", status=503,
                    ) from exc
                if retries >= cfg.retry_budget:
                    raise ServingError(
                        f"request failed on {retries + 1} replica(s), "
                        f"retry budget {cfg.retry_budget} exhausted "
                        f"({exc})", status=503) from exc
                retries += 1
                self._m_retries.inc(replica=replica.name)
                with obs_spans.RECORDER.span(
                        "router.retry",
                        component="deeprest-router") as sp:
                    sp.tag(replica=replica.name, attempt=retries)
                continue
            self._note_replica_ok(replica)
            return out

    def predict_series(self, traffic: np.ndarray,
                       integrate: bool = True) -> np.ndarray:
        return self._dispatch(
            lambda r: r.predict_series(traffic, integrate=integrate),
            {"series": 1})

    def predict_series_many(self, series_list, integrate: bool = True):
        series_list = list(series_list)
        return self._dispatch(
            lambda r: r.predict_series_many(series_list,
                                            integrate=integrate),
            {"series": len(series_list)})

    # -- replica health: ejection, retry, probe-and-rejoin ---------------

    def _note_replica_ok(self, replica) -> None:
        with self._lock:
            h = self._health.get(id(replica))
            if h is not None and h.consecutive_failures:
                h.consecutive_failures = 0

    def _replica_alive(self, replica) -> bool:
        alive = getattr(replica, "alive", None)
        return alive() if callable(alive) else True

    def _note_replica_failure(self, replica, exc) -> None:
        dead = not self._replica_alive(replica)
        with self._lock:
            h = self._health_locked(replica)
            h.consecutive_failures += 1
            h.last_error = str(exc)
            fails = h.consecutive_failures
            eject = (not h.ejected
                     and (dead or fails >= self.config.eject_after_failures))
            if eject:
                h.ejected = True
                h.ejections += 1
        if eject:
            self._m_ejections.inc(replica=replica.name)
            with obs_spans.RECORDER.span("router.eject",
                                         component="deeprest-router") as sp:
                sp.tag(replica=replica.name, dead=dead,
                       consecutive_failures=fails, error=str(exc)[:200])
            self._ensure_probe()

    def eject(self, name: str, reason: str = "manual eject") -> None:
        """Administratively eject a replica from dispatch (process
        replicas normally eject themselves through ReplicaDeadError).
        In-flight work on it finishes; the probe rejoins it."""
        with self._lock:
            target = next((r for r in self._replicas if r.name == name),
                          None)
            if target is None:
                raise KeyError(f"no replica named {name!r}")
            h = self._health_locked(target)
            fresh = not h.ejected
            if fresh:
                h.ejected = True
                h.ejections += 1
                h.last_error = reason
        if fresh:
            self._m_ejections.inc(replica=name)
            with obs_spans.RECORDER.span("router.eject",
                                         component="deeprest-router") as sp:
                sp.tag(replica=name, reason=reason)
            self._ensure_probe()

    def _ensure_probe(self) -> None:
        with self._lock:
            if self._closed:
                return
            if (self._probe_thread is not None
                    and self._probe_thread.is_alive()):
                return
            self._probe_stop = threading.Event()
            stop = self._probe_stop
            t = threading.Thread(target=self._probe_loop, args=(stop,),
                                 daemon=True,
                                 name="deeprest-router-probe")
            self._probe_thread = t
        t.start()

    def _probe_loop(self, stop: threading.Event) -> None:
        """Background probe-and-rejoin: each tick tries to bring every
        ejected replica back.  Process replicas REBOOT (a SIGKILLed worker
        comes back as a fresh spawn from the same spec, graphs captured
        before it answers); thread replicas rejoin directly.  A replica
        whose reboot fails stays ejected and is retried next tick (the
        tick interval is the backoff).  The thread parks once every
        replica is live; the next ejection starts a fresh one."""
        while not stop.wait(self.config.probe_interval_s):
            with self._lock:
                targets = [r for r in self._replicas
                           if self._health_locked(r).ejected]
            for r in targets:
                if stop.is_set():
                    return
                try:
                    self._revive(r)
                except Exception as exc:
                    with self._lock:
                        self._health_locked(r).last_error = \
                            f"rejoin failed: {exc}"
            with self._lock:
                if not any(self._health_locked(r).ejected
                           for r in self._replicas):
                    return              # park until the next ejection

    def _revive(self, replica) -> None:
        restart = getattr(replica, "restart", None)
        if callable(restart):
            restart()       # reboot-by-restart; raises when the boot fails
        with self._lock:
            h = self._health_locked(replica)
            if not h.ejected:
                return
            h.ejected = False
            h.consecutive_failures = 0
            h.rejoins += 1
        self._m_rejoins.inc(replica=replica.name)
        with obs_spans.RECORDER.span("router.rejoin",
                                     component="deeprest-router") as sp:
            sp.tag(replica=replica.name)

    # -- replica plane management ----------------------------------------

    @property
    def replicas(self) -> list:
        with self._lock:
            return list(self._replicas)

    def enable_batching(self, config) -> None:
        """Per-replica-stack MicroBatchers (one per distinct stack)."""
        with self._lock:
            replicas = list(self._replicas)
            self._batching = config
        seen = set()
        for r in replicas:
            key = _stack_key(r)
            if key in seen:
                continue
            seen.add(key)
            r.set_batching(config)

    def rolling_reload_from(self, fresh_backend,
                            reason: str = "watch") -> None:
        """Zero-downtime reload: drain → swap → re-admit, one stack at a
        time.  Replicas sharing a stack drain together and swap once.
        Never takes the router lock across a drain wait: requests keep
        flowing to the other replicas.

        ``reason`` labels the reload's obs counter and span: "watch"
        (checkpoint-dir follower), "drift" or "manual"."""
        with obs_spans.RECORDER.span("router.rolling_reload",
                                     component="deeprest-router") as sp:
            sp.tag(reason=reason)
            self._rolling_reload_inner(fresh_backend)
        with self._lock:
            self._last_reload_reason = reason
        self._m_reloads_by_reason.inc(reason=reason)

    @staticmethod
    def _fresh_stack(fresh_backend, device):
        """The fresh stack for a thread-replica group on ``device``:
        ``fresh_backend`` itself on its own device (already warmed by the
        reloader: no capture under load), else a clone there, warmed
        before its group drains."""
        if (device is None or _canonical_device(fresh_backend.device)
                == device):
            return fresh_backend
        clone = clone_backend(fresh_backend, device=device)
        clone.warm()
        return clone

    def _rolling_reload_inner(self, fresh_backend) -> None:
        with self._lock:
            replicas = list(self._replicas)
        groups: dict[int, list] = {}
        for r in replicas:
            groups.setdefault(_stack_key(r), []).append(r)
        for group in groups.values():
            lead = group[0]
            fresh = (self._fresh_stack(fresh_backend, lead.device)
                     if callable(getattr(lead, "backend", None))
                     else fresh_backend)
            for r in group:
                r.drain()
            try:
                for r in group:
                    if not r.wait_idle(timeout_s=60.0):
                        raise ServingError(
                            f"replica {r.name} failed to drain for reload",
                            status=503)
                for r in group:
                    r.reload_backend(fresh)
            finally:
                for r in group:
                    r.resume()
        with self._lock:
            self._reloads += 1
            # metadata may legitimately change shape-compatibly (fresh
            # normalization stats); re-probe from the reloaded lead
            self._meta = self._probe_meta(replicas[0])

    def scale_to(self, n: int, backend_factory=None) -> int:
        """Grow/shrink the replica plane to ``n`` (the autoscaler's
        actuator).  Growth reuses a device's stack, or clones the first
        replica's (or ``backend_factory()``) onto a new card; shrink
        drains and closes the tail."""
        if n < 1:
            raise ValueError(f"replica count {n} must be >= 1")
        with self._lock:
            replicas = list(self._replicas)
        if n == len(replicas):
            return n
        if n < len(replicas):
            with self._lock:
                keep, drop = self._replicas[:n], self._replicas[n:]
                self._replicas = keep
            for r in drop:
                r.drain()
            errors = []
            for r in drop:
                # one replica's failing drain-wait/close must not leave the
                # REST of the shrink set drained-but-live: reclaim every
                # replica, then report the failures together
                try:
                    r.wait_idle(timeout_s=30.0)
                    # shared-stack replicas must not close the survivors'
                    # stack
                    shared = any(_stack_key(k) == _stack_key(r)
                                 for k in keep)
                    if not shared:
                        r.close()
                except Exception as exc:
                    errors.append(f"{r.name}: {type(exc).__name__}: {exc}")
            if errors:
                raise ServingError(
                    "scale_to shrink could not reclaim every replica: "
                    + "; ".join(errors), status=500)
            return n
        lead = replicas[0]
        with self._lock:
            batching = self._batching
        if callable(getattr(lead, "backend", None)):       # thread plane
            base = backend_factory() if backend_factory else lead.backend()
            devices = _thread_devices(base)
            from deeprest_tpu_torch.serve.batcher import MicroBatcher

            stacks = {}
            for r in replicas:
                if callable(getattr(r, "backend", None)) \
                        and r.device is not None:
                    stacks[r.device] = r.backend()
            fresh = []
            for i in range(len(replicas), n):
                dev = _canonical_device(devices[i % len(devices)])
                stack = stacks.get(dev)
                if stack is None:
                    stack = clone_backend(base, device=dev)
                    if batching is not None and stack.batcher is None:
                        stack.attach_batcher(
                            MicroBatcher(stack.ladder, batching))
                    stacks[dev] = stack
                fresh.append(EngineReplica(stack, name=f"r{i}", device=dev,
                                           batching=batching))
        else:                                              # process plane
            fresh = _boot_all(lead.spec,
                              [f"p{i}" for i in range(len(replicas), n)],
                              self.config.replica_timeout_s)
        with self._lock:
            # revalidate before the act: a concurrent scale_to may have
            # grown the plane while the new stacks were building off-lock,
            # so cap at the room actually left
            room = max(0, n - len(self._replicas))
            publish, surplus = fresh[:room], fresh[room:]
            self._replicas.extend(publish)
        for r in surplus:
            # unpublished process workers own live subprocesses; thread
            # replicas may share a stack with a published survivor, so
            # they are dropped, never closed
            if not callable(getattr(r, "backend", None)):
                r.close()
        return n

    def note_autoscaler(self, decision: dict) -> None:
        """Latest control-loop decision, surfaced on /healthz."""
        with self._lock:
            self._autoscaler_decision = dict(decision)

    def close(self) -> None:
        # Deregister the render-time collector FIRST: the process-wide
        # registry would otherwise hold this router (and every stack's
        # device-resident params) alive forever.  Conditional on the bound
        # method, so a rebuilt plane's newer registration survives.
        obs_metrics.REGISTRY.unregister_collector("router",
                                                  self._collect_metrics)
        with self._lock:
            self._closed = True
            replicas = list(self._replicas)
            probe, stop = self._probe_thread, self._probe_stop
        stop.set()
        if probe is not None:
            probe.join(timeout=5)
        seen = set()
        for r in replicas:
            key = _stack_key(r)
            if key in seen:
                # shared-stack duplicates drain; the stack (and its
                # batcher) is closed once, via the group's first replica
                r.drain()
                continue
            seen.add(key)
            r.close()

    # -- observability ---------------------------------------------------

    def demand_totals(self) -> dict[str, int]:
        """Cumulative plane demand off the obs counters: requests served
        by any replica plus requests shed by admission (the autoscaler's
        observation source)."""
        with self._lock:
            replicas = list(self._replicas)
        served = sum(int(r.served_requests()) for r in replicas)
        return {"served": served,
                "shed": self.admission.counts()["rejected"]}

    def _collect_metrics(self, sink) -> None:
        """The /metrics view of the replica plane (render-time only)."""
        with self._lock:
            replicas = list(self._replicas)
            dispatched = self._dispatched
            reloads = self._reloads
            decision = self._autoscaler_decision
        sink.gauge("deeprest_router_replicas", len(replicas),
                   help="live replica count behind the routing front")
        sink.counter("deeprest_router_dispatched_total", dispatched,
                     help="requests dispatched by the router")
        sink.counter("deeprest_router_rolling_reloads_total", reloads,
                     help="zero-downtime rolling reloads completed")
        with self._lock:
            ejected = sum(1 for r in replicas
                          if self._health_locked(r).ejected)
        sink.gauge("deeprest_router_ejected_replicas", ejected,
                   help="replicas currently ejected from dispatch "
                        "(awaiting probe-and-rejoin)")
        for r in replicas:
            labels = {"replica": r.name}
            sink.gauge("deeprest_replica_outstanding_windows",
                       r.outstanding(),
                       help="windows currently dispatched to the replica",
                       labels=labels)
            sink.counter("deeprest_replica_served_requests_total",
                         r.served_requests(),
                         help="requests served by the replica",
                         labels=labels)
            sink.counter("deeprest_replica_served_windows_total",
                         r.served_windows(),
                         help="windows served by the replica",
                         labels=labels)
        if decision is not None:
            sink.gauge("deeprest_autoscaler_desired_replicas",
                       decision.get("desired", 0),
                       help="latest autoscaler decision")
        cache = self.jit_cache_size()
        if cache is not None:
            sink.gauge("deeprest_plane_jit_executables", cache,
                       help="compiled executables across distinct stacks "
                            "(captured CUDA graphs in the port)")

    def health_totals(self) -> dict[str, int]:
        """Cumulative ejection/retry/rejoin counts off the obs counters."""
        return {
            "ejections": int(sum(self._m_ejections.series().values())),
            "retries": int(sum(self._m_retries.series().values())),
            "rejoins": int(sum(self._m_rejoins.series().values())),
        }

    def router_stats(self) -> dict:
        with self._lock:
            replicas = list(self._replicas)
            reloads = self._reloads
            last_reload_reason = self._last_reload_reason
            dispatched = self._dispatched
            decision = self._autoscaler_decision
            health = {
                id(r): dataclasses.replace(self._health_locked(r))
                for r in replicas
            }
        entries = []
        for r in replicas:
            s = r.stats()
            h = health[id(r)]
            s["health"] = {
                "ejected": h.ejected,
                "consecutive_failures": h.consecutive_failures,
                "ejections": h.ejections,
                "rejoins": h.rejoins,
                "last_error": h.last_error,
            }
            entries.append(s)
        return {
            "replicas": entries,
            "num_replicas": len(replicas),
            "live_replicas": sum(
                1 for r in replicas
                if r.available() and not health[id(r)].ejected),
            "dispatched": dispatched,
            "rolling_reloads": reloads,
            "last_reload_reason": last_reload_reason,
            "admission": self.admission.stats(),
            "health": self.health_totals(),
            "autoscaler": decision,
        }

    def params_digest(self) -> str | None:
        """The lead replica's params digest."""
        with self._lock:
            replicas = list(self._replicas)
        if not replicas:
            return None
        backend = getattr(replicas[0], "backend", None)
        if callable(backend):
            probe = getattr(backend(), "params_digest", None)
            return probe() if callable(probe) else None
        fleet_meta = getattr(replicas[0], "fleet_meta", None)
        if callable(fleet_meta):     # ProcessReplica boot handshake
            meta = fleet_meta() or {}
            default = meta.get("tenants", {}).get("default", {})
            return default.get("params_digest")
        return None

    def jit_cache_stats(self) -> dict | None:
        """The rung graph ledger (captures, replays, captures after
        warm-up) summed over DISTINCT in-process stacks, for ``/healthz``'s
        ``jit_cache``; None for a process plane, whose workers report
        their own under ``router.replicas[i].worker``."""
        total, seen = None, set()
        for r in self.replicas:
            backend = getattr(r, "backend", None)
            if not callable(backend) or id(backend()) in seen:
                continue
            seen.add(id(backend()))
            probe = getattr(backend(), "jit_cache_stats", None)
            if not callable(probe):
                continue
            stats = probe()
            total = total or dict.fromkeys(
                ("captures", "replays", "captures_after_warmup"), 0)
            for key in total:
                total[key] += stats[key]
        return total

    def jit_cache_size(self) -> int | None:
        """Captured graphs across DISTINCT in-process stacks (shared stacks
        count once: zero new graphs per replica beyond the first)."""
        sizes, seen = [], set()
        for r in self.replicas:
            backend = getattr(r, "backend", None)
            if not callable(backend):
                continue
            b = backend()
            if id(b) in seen:
                continue
            seen.add(id(b))
            probe = getattr(b, "jit_cache_size", None)
            if callable(probe):
                s = probe()
                if s is not None:
                    sizes.append(s)
        return sum(sizes) if sizes else None
