"""Engine replicas: N serving stacks behind one routing front
(``deeprest_tpu/serve/replica.py``; serve/router.py is the front).

Two replica kinds behind ONE interface (``predict_series``,
``predict_series_many``, ``outstanding``, ``drain``/``resume``/
``wait_idle``, ``reload_backend``, ``close``):

``EngineReplica``
    In-process: a full serving stack (Predictor or ExportedPredictor +
    shape ladder + fused engine + rung graphs + optional per-stack
    MicroBatcher) on one ``torch.device``.  Replicas on the SAME device
    SHARE one stack: its captured rung graphs serve every one of them, so
    a second replica on a card captures nothing new; the scheduling state
    (outstanding-work counter, drain flag) stays per replica.

``ProcessReplica``
    A worker subprocess (``multiprocessing`` spawn context: no fork after
    CUDA is set up) building its own stack from a spec (checkpoint dir,
    artifact dir, or a ``module:function`` factory) on the spec's
    ``device``, capturing every rung graph before its boot handshake, and
    serving requests over a duplex pipe.  The parent side multiplexes
    concurrent requests by id (send lock + one reader thread resolving
    futures); the child answers on a small thread pool so its
    MicroBatcher still coalesces.  Each worker has its own interpreter
    and CUDA context.  Only numpy arrays and plain Python values cross
    the pipe: no CUDA tensor is pickled.

The router never sees the difference: both kinds expose the same
outstanding-work signal its least-outstanding-work dispatch reads.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans


class ReplicaDeadError(RuntimeError):
    """A replica cannot answer this request: its worker died, its pipe
    broke, or it blew through the per-request deadline.

    ``retriable`` encodes the router's no-double-execution rule: True only
    when the failure PROVES no response was or ever will be produced (the
    send never reached the worker, or the worker process is dead).  A
    deadline expiry on a LIVE worker is retriable=False: the request may
    still be executing on the device, so the router ejects the replica and
    answers a fast 503 instead of re-dispatching it.
    """

    def __init__(self, message: str, replica: str = "",
                 retriable: bool = False):
        super().__init__(message)
        self.replica = replica
        self.retriable = retriable


def _release_proc(proc) -> None:
    """Free a reaped worker's parent-side resources now (the Popen
    sentinel pipe fd otherwise lives until garbage collection).  No-op
    while the process still runs."""
    if proc is None or proc.is_alive():
        return
    try:
        proc.close()
    except ValueError:
        pass        # already closed / never started


def _num_windows(t: int, w: int) -> int:
    """Window count of a [T, F] series under the serving tiling (stride-W
    tiling + right-aligned ragged tail): the router's outstanding-work
    unit."""
    if t < w:
        return 1
    n = (t - w) // w + 1
    return n + (1 if (t - w) % w != 0 else 0)


def _fused_kwargs(backend) -> dict:
    fused = getattr(backend, "fused", None)
    # a clone captures its graphs unless the backend chose eager serving on
    # CUDA; a mesh serves eagerly only when gloo's collectives forbid the
    # capture, and a clone holds no collective
    return dict(
        ladder=backend.ladder.base_ladder,
        coalesce_groups=backend.ladder.coalesce_groups,
        fused=fused is not None,
        page_windows=fused.page if fused is not None else None,
        coalesce_pages=fused.coalesce_pages if fused is not None else None,
        cuda_graphs=backend.graphs.captured
        or backend.device.type != "cuda"
        or getattr(backend, "mesh", None) is not None)


def clone_backend(backend, device=None, **overrides):
    """A fresh serving stack sharing ``backend``'s restored host state.

    Params are copied onto ``device`` (default: the backend's own); the
    ladder, fused engine and rung graphs are NEW, so the clone captures
    for (and dispatches on) its own device.  Works for both in-process
    backends: Predictor (has ``params``) and ExportedPredictor (has the
    exported program).  A quantized Predictor keeps no f32 params to
    quantize again, so it cannot be cloned: serve quantized replicas as
    worker processes, each quantizing from the checkpoint.

    A Predictor on a mesh (``serve --mesh``) clones to a one-device
    predictor of its whole params (``Predictor.whole_params``: on a
    sharded mesh a gather, announced by rank 0's front to the other
    ranks, which join it); the clone has no front, so its calls are
    never announced."""
    device = backend.device if device is None else device
    kwargs = _fused_kwargs(backend)
    kwargs.update(overrides)
    if hasattr(backend, "params"):           # in-process Predictor
        from deeprest_tpu_torch.serve.predictor import Predictor

        if backend.quant != "off":
            raise ValueError(
                f"cannot clone a quantized ({backend.quant}) predictor: it "
                "keeps no f32 params to quantize again; serve quantized "
                "replicas with --replica-mode process")
        kwargs.setdefault("sparse_feed", backend.sparse_feed)
        kwargs.setdefault("sparse_nnz_cap", backend.sparse_nnz_cap)
        return Predictor(
            params=backend.whole_params(),
            model_config=backend.model_config,
            x_stats=backend.x_stats,
            y_stats=backend.y_stats,
            metric_names=backend.metric_names,
            window_size=backend.window_size,
            space_dict=backend.space_dict,
            delta_mask=backend.delta_mask,
            device=device, recurrence=backend.recurrence,
            **kwargs)
    if hasattr(backend, "program"):          # exported artifact
        from deeprest_tpu_torch.serve.export import ExportedPredictor

        return ExportedPredictor(backend.program, backend.manifest,
                                 quant=backend.quant, device=device,
                                 **kwargs)
    raise TypeError(f"cannot clone serving backend {type(backend).__name__}")


def _canonical_device(device):
    """``cuda`` → ``cuda:<current>``, so replicas keyed by device find the
    same stack whichever spelling their device came in."""
    import torch

    if device is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_ctx(device):
    """``torch.cuda.device`` ONLY when the replica's card differs from the
    current one: with one card every replica lands on it and enters
    nothing.  CPU replicas (and a None device) enter nothing either."""
    import torch

    if device is None or device.type != "cuda" or device.index is None:
        return contextlib.nullcontext()
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device.index)


class EngineReplica:
    """One in-process serving stack + the per-replica scheduling state the
    router reads (outstanding windows, drain flag).

    ``backend`` may be SHARED with other replicas on the same device (see
    the module docstring): the router's rolling reload groups such
    replicas and swaps their shared stack once, after draining all of
    them.
    """

    kind = "thread"

    def __init__(self, backend, name: str = "r0", device=None,
                 batching=None):
        from deeprest_tpu_torch.serve.batcher import MicroBatcher

        self.name = name
        self.device = _canonical_device(device)
        # Guards every mutable field below: the ThreadingHTTPServer front
        # calls replicas from concurrent handler threads while the router
        # reads outstanding counters and the reload path flips the drain
        # flag.
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._backend = backend
        self._outstanding = 0          # windows currently dispatched here
        # Served totals are obs Counters (per-instance objects): the
        # stats() JSON, the router's /metrics collector and the
        # autoscaler's demand read all consume the SAME objects.
        self._m_served_requests = obs_metrics.Counter(
            "deeprest_replica_served_requests_total",
            labelnames=("replica",))
        self._m_served_windows = obs_metrics.Counter(
            "deeprest_replica_served_windows_total",
            labelnames=("replica",))
        self._draining = False
        self._closed = False
        self._batching = batching
        if batching is not None and backend.batcher is None:
            backend.attach_batcher(MicroBatcher(backend.ladder, batching))

    # -- scheduling signal (read by the router's dispatch loop) ----------

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def available(self) -> bool:
        with self._lock:
            return not (self._draining or self._closed)

    @property
    def window_size(self) -> int:
        with self._lock:
            return self._backend.window_size

    def backend(self):
        with self._lock:
            return self._backend

    # -- serving ---------------------------------------------------------

    def _begin(self, windows: int):
        with self._lock:
            if self._closed:
                raise RuntimeError(f"replica {self.name} is closed")
            self._outstanding += windows
        return windows

    def _end(self, windows: int, requests: int = 1) -> None:
        with self._cv:
            self._outstanding -= windows
            self._cv.notify_all()      # wake wait_idle() drains
        self._m_served_requests.inc(requests, replica=self.name)
        self._m_served_windows.inc(windows, replica=self.name)

    def served_requests(self) -> int:
        return int(self._m_served_requests.value(replica=self.name))

    def served_windows(self) -> int:
        return int(self._m_served_windows.value(replica=self.name))

    def predict_series(self, traffic: np.ndarray,
                       integrate: bool = True, backend=None) -> np.ndarray:
        # ``backend`` override: the fleet tier (serve/fleet.py) resolves
        # tenant → pool-entry predictor BEFORE dispatch and serves this
        # one request through it; the replica still owns the scheduling
        # state (outstanding windows, drain flag), the pool owns the
        # per-tenant weights.  None keeps the replica's own stack.
        if backend is None:
            with self._lock:
                backend = self._backend
        n = self._begin(_num_windows(len(traffic), backend.window_size))
        try:
            with _device_ctx(self.device), \
                    obs_spans.RECORDER.span(
                        "replica.predict",
                        component="deeprest-replica") as sp:
                sp.tag(replica=self.name, windows=n)
                return backend.predict_series(traffic, integrate=integrate)
        finally:
            self._end(n)

    def predict_series_many(self, series_list, integrate: bool = True,
                            backend=None):
        if backend is None:
            with self._lock:
                backend = self._backend
        series_list = list(series_list)
        n = self._begin(sum(_num_windows(len(s), backend.window_size)
                            for s in series_list))
        try:
            with _device_ctx(self.device), \
                    obs_spans.RECORDER.span(
                        "replica.predict",
                        component="deeprest-replica") as sp:
                sp.tag(replica=self.name, windows=n,
                       series=len(series_list))
                return backend.predict_series_many(series_list,
                                                   integrate=integrate)
        finally:
            self._end(n, requests=len(series_list))

    # -- lifecycle (the router's rolling-reload path) --------------------

    def drain(self) -> None:
        """Stop receiving router dispatches (in-flight work finishes)."""
        with self._lock:
            self._draining = True

    def resume(self) -> None:
        with self._lock:
            self._draining = False

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        """Block until every dispatched window has completed."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._outstanding > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    def reload_backend(self, fresh) -> None:
        """Swap in a drained-and-rebuilt stack.  The caller (router) has
        already drained this replica, so no request straddles the swap:
        the no-mixed-params guarantee is structural."""
        from deeprest_tpu_torch.serve.batcher import MicroBatcher

        with self._lock:
            # ONE critical section from the batching/backend read to the
            # publish: two concurrent reloads (or a reload racing
            # set_batching) would otherwise both read the same `old`, and
            # the loser's published stack would retire with its batcher
            # never closed.  The MicroBatcher built here touches only the
            # unpublished `fresh`.
            batching = self._batching
            old = self._backend
            if batching is not None and fresh.batcher is None:
                fresh.attach_batcher(MicroBatcher(fresh.ladder, batching))
            self._backend = fresh
        old_b = old.batcher
        if old_b is not None and old_b is not fresh.batcher:
            old.attach_batcher(None)
            old_b.close()

    def set_batching(self, config) -> None:
        """(Re)attach a per-stack MicroBatcher (None detaches)."""
        from deeprest_tpu_torch.serve.batcher import MicroBatcher

        with self._lock:
            backend = self._backend
            self._batching = config
        old = backend.batcher
        fresh = (MicroBatcher(backend.ladder, config)
                 if config is not None else None)
        backend.attach_batcher(fresh)
        if old is not None:
            old.close()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._draining = True
            backend = self._backend
        b = backend.batcher
        if b is not None:
            backend.attach_batcher(None)
            b.close()

    def stats(self) -> dict:
        with self._lock:
            out = {
                "name": self.name,
                "kind": self.kind,
                "device": str(self.device) if self.device is not None else None,
                "outstanding_windows": self._outstanding,
                "served_requests": self.served_requests(),
                "served_windows": self.served_windows(),
                "state": ("closed" if self._closed
                          else "draining" if self._draining else "live"),
            }
            backend = self._backend
        b = backend.batcher
        if b is not None:
            out["batcher"] = b.stats()
        cache = getattr(backend, "jit_cache_size", None)
        if callable(cache):
            out["jit_cache_size"] = cache()
        return out


# ---------------------------------------------------------------------------
# Worker-subprocess replicas


def _resolve_factory(path: str):
    import importlib

    mod, _, fn = path.partition(":")
    if not fn:
        raise ValueError(f"bad factory spec {path!r} (want 'module:function')")
    return getattr(importlib.import_module(mod), fn)


def build_backend_from_spec(spec: dict):
    """Child-side stack construction: checkpoint dir, artifact dir, or a
    ``module:function`` factory, with optional serving kwargs; the first
    two on the spec's ``device`` (default "cuda")."""
    import sys

    for p in spec.get("sys_path", ()):     # test factories live off-package
        if p not in sys.path:
            sys.path.insert(0, p)
    kwargs = dict(spec.get("kwargs") or {})
    if spec.get("ckpt_dir"):
        from deeprest_tpu_torch.serve.predictor import Predictor

        return Predictor.from_checkpoint(
            spec["ckpt_dir"], device=spec.get("device", "cuda"), **kwargs)
    if spec.get("artifact"):
        from deeprest_tpu_torch.serve.export import ExportedPredictor

        return ExportedPredictor.load(
            spec["artifact"], device=spec.get("device", "cuda"), **kwargs)
    if spec.get("factory"):
        return _resolve_factory(spec["factory"])(**kwargs)
    raise ValueError(f"replica spec needs ckpt_dir, artifact, or factory: "
                     f"{sorted(spec)}")


def _worker_stats(backend) -> dict:
    """The worker's own view for the parent's ``/healthz``: its rung graph
    ledger, the kernel launches this process made, its batcher and its
    device memory (bytes; None on the CPU)."""
    import os

    import torch

    from deeprest_tpu_torch.ops.cuda_gru import MODEL_KERNELS

    out = {"pid": os.getpid(),
           "device": str(getattr(backend, "device", None)),
           "kernel_launches": {k.name: k.launches for k in MODEL_KERNELS},
           "memory": None}
    stats = getattr(backend, "jit_cache_stats", None)
    if callable(stats):
        out["jit_cache"] = stats()
    if backend.batcher is not None:
        out["batcher"] = backend.batcher.stats()
    dev = getattr(backend, "device", None)
    if dev is not None and dev.type == "cuda":
        out["memory"] = {
            "allocated": torch.cuda.memory_allocated(dev),
            "reserved": torch.cuda.memory_reserved(dev),
            "max_allocated": torch.cuda.max_memory_allocated(dev)}
    return out


def _worker_main(spec: dict, conn) -> None:
    """Subprocess entry: build the stack, capture its rung graphs
    (``warm()``), then serve pipe requests on a small thread pool (so the
    in-child MicroBatcher still coalesces).

    Observability: with ``spec["obs"]`` the child enables its own span
    recorder, adopts the parent's propagated ``(trace_id, span_id)``
    context per request, and forwards its committed spans back over the
    SAME duplex pipe as ``"__spans__"``-tagged messages; the parent's
    reader ingests them into its recorder, so a request's trace crosses
    the process boundary intact.
    """
    from concurrent.futures import ThreadPoolExecutor

    obs_on = bool(spec.get("obs"))
    if obs_on:
        from deeprest_tpu_torch import obs

        obs.configure(enabled=True)
    try:
        sw = obs_metrics.Stopwatch()
        backend = build_backend_from_spec(spec)
        if spec.get("batching"):
            from deeprest_tpu_torch.serve.batcher import (
                BatcherConfig, MicroBatcher,
            )

            cfg = BatcherConfig(**spec["batching"])
            backend.attach_batcher(MicroBatcher(backend.ladder, cfg))
        build_s = sw.elapsed()
        sw.restart()
        warm = getattr(backend, "warm", None)
        graphs = warm() if callable(warm) else None
        seconds = {"build": build_s, "warm": sw.elapsed()}
    except Exception as exc:   # surface the constructor error to the parent
        conn.send(("__boot__", False, f"{type(exc).__name__}: {exc}"))
        conn.close()
        return
    conn.send(("__boot__", True, {
        "window_size": backend.window_size,
        "metric_names": list(backend.metric_names),
        "feature_dim": backend.feature_dim,
        "quantiles": list(backend.quantiles),
        "median_index": backend.median_index(),
        "delta_mask": (np.asarray(backend.delta_mask, bool).tolist()
                       if backend.delta_mask is not None else None),
        # y_stats ride the handshake so the router can serve the full
        # AnomalyDetector protocol (scale floors of delta metrics)
        "y_stats": (backend.y_stats.to_dict()
                    if getattr(backend, "y_stats", None) is not None
                    else None),
        # per-tenant serving identity, shaped like the /healthz fleet view
        "fleet": {"tenants": {"default": {
            "quant": getattr(backend, "quant", "off"),
            "params_digest": (backend.params_digest()
                              if callable(getattr(backend, "params_digest",
                                                  None)) else None),
        }}},
        # port additions: the call-path space (so a process plane fits the
        # what-if synthesizer and featurizes verdicts like one engine) and
        # the rung graphs captured before this handshake
        "space_dict": getattr(backend, "space_dict", None),
        "graphs": graphs,
        "seconds": seconds,
    }))
    send_lock = threading.Lock()

    def handle(req_id, method, args, ctx=None):
        token = obs_spans.set_context(ctx) if ctx is not None else None
        try:
            with obs_spans.RECORDER.span("replica.worker",
                                         component="deeprest-replica") as sp:
                if method == "predict_series":
                    traffic, integrate = args
                    sp.tag(method=method, windows=_num_windows(
                        len(traffic), backend.window_size))
                    out = backend.predict_series(traffic,
                                                 integrate=integrate)
                elif method == "predict_series_many":
                    series_list, integrate = args
                    sp.tag(method=method, series=len(series_list))
                    out = backend.predict_series_many(series_list,
                                                      integrate=integrate)
                elif method == "stats":
                    out = _worker_stats(backend)
                else:
                    raise ValueError(f"unknown method {method!r}")
            with send_lock:
                conn.send((req_id, True, out))
        except Exception as exc:
            with send_lock:
                conn.send((req_id, False, f"{type(exc).__name__}: {exc}"))
        finally:
            if token is not None:
                obs_spans.set_context(None)
            if obs_on:
                batch = [r.to_dict() for r in obs_spans.RECORDER.drain()]
                if batch:
                    with send_lock:
                        conn.send(("__spans__", True, batch))

    try:
        with ThreadPoolExecutor(
                max_workers=int(spec.get("worker_threads", 4))) as pool:
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    break              # parent went away: drain and exit
                if msg is None:        # shutdown sentinel
                    break
                pool.submit(handle, *msg)
    finally:
        # close the child's pipe end on EVERY exit path, so a handler bug
        # escaping the pool cannot strand the parent's reader thread on a
        # half-open pipe
        conn.close()


class ProcessReplica:
    """Worker-subprocess replica behind the EngineReplica interface."""

    kind = "process"

    def __init__(self, spec: dict, name: str = "p0",
                 boot_timeout_s: float = 300.0,
                 request_timeout_s: float | None = None):
        from concurrent.futures import Future

        self.name = name
        self.device = None             # the child owns its device binding
        self.spec = dict(spec)
        # Per-request deadline (None = wait indefinitely).  Without it a
        # worker that dies mid-request between heartbeats wedges its caller
        # forever on the response future.
        self.request_timeout_s = request_timeout_s
        # The child mirrors the parent's span-recording state at boot (an
        # explicit spec["obs"] wins).
        self.spec.setdefault("obs", obs_spans.RECORDER.enabled)
        self.boot_timeout_s = boot_timeout_s
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._outstanding = 0
        self._m_served_requests = obs_metrics.Counter(
            "deeprest_replica_served_requests_total",
            labelnames=("replica",))
        self._m_served_windows = obs_metrics.Counter(
            "deeprest_replica_served_windows_total",
            labelnames=("replica",))
        self._draining = False
        self._closed = False
        self._next_id = 0
        self._futures: dict[int, Future] = {}
        # Dedicated send lock: a pipe send can block when the OS buffer
        # fills, and blocking while holding the bookkeeping lock would
        # stall the reader thread (which needs it per response).
        self._send_lock = threading.Lock()
        self._conn = None
        self._proc = None
        self._meta = None
        self._boot()

    def _boot(self) -> None:
        """Spawn a worker and wait for its stack to come up (built and its
        graphs captured).  Called from __init__ and from restart; the
        caller guarantees no requests are in flight."""
        import multiprocessing as mp

        ctx = mp.get_context("spawn")  # no fork after CUDA is set up
        sw = obs_metrics.Stopwatch()
        conn, child = ctx.Pipe(duplex=True)
        proc = None
        try:
            proc = ctx.Process(target=_worker_main,
                               args=(self.spec, child), daemon=True)
            proc.start()
            child.close()
            if not conn.poll(self.boot_timeout_s):
                raise RuntimeError(
                    f"replica {self.name}: worker boot timed out")
            # recv itself can raise (EOFError when the worker dies after
            # start but before the handshake lands): the except below
            # cleans up on every failed-boot path
            tag, ok, meta = conn.recv()
            if tag != "__boot__" or not ok:
                raise RuntimeError(f"replica {self.name}: worker failed "
                                   f"to boot: {meta}")
            if isinstance(meta.get("seconds"), dict):
                meta["seconds"]["boot"] = sw.elapsed()
        except Exception:
            conn.close()
            child.close()
            if proc is not None and proc.pid is not None:
                if proc.is_alive():
                    proc.terminate()
                proc.join(timeout=5)
                _release_proc(proc)
            raise
        with self._lock:
            self._conn = conn
            self._proc = proc
            self._meta = meta
            self._next_id = 0
        reader = threading.Thread(target=self._read_loop, args=(conn,),
                                  daemon=True,
                                  name=f"replica-{self.name}-reader")
        reader.start()

    # -- parent-side metadata -------------------------------------------

    @property
    def window_size(self) -> int:
        with self._lock:       # a restart swaps self._meta
            return self._meta["window_size"]

    def fleet_meta(self) -> dict | None:
        """The worker's serving identity from the boot handshake
        (``{"tenants": {name: {quant, params_digest}}}``)."""
        with self._lock:
            meta = self._meta
        return meta.get("fleet") if meta is not None else None

    def boot_info(self) -> dict:
        """The latest boot: the rung graph stats the worker's ``warm()``
        returned, and its seconds (``build``: imports done, the stack
        built; ``warm``: its graphs captured; ``boot``: spawn to
        handshake, seen from here)."""
        with self._lock:
            meta = self._meta or {}
        return {"graphs": meta.get("graphs"), "seconds": meta.get("seconds")}

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def available(self) -> bool:
        with self._lock:
            return not (self._draining or self._closed)

    def alive(self) -> bool:
        """Is the worker subprocess running?  The router's health layer
        reads this to pick between retry (dead: the request provably has
        no surviving execution) and eject-without-retry (alive but
        wedged: possible double execution)."""
        with self._lock:
            proc = self._proc
        if proc is None:
            return False
        try:
            return proc.is_alive()
        except ValueError:
            return False       # reaped and released (close()/restart())

    def pid(self) -> int | None:
        with self._lock:
            proc = self._proc
        try:
            return proc.pid if proc is not None else None
        except ValueError:
            return None

    # -- request multiplexing -------------------------------------------

    def _read_loop(self, conn) -> None:
        """Resolve response futures from ONE pipe generation; a restart
        swaps the pipe, and this loop exits on its EOF.  ``"__spans__"``
        messages are the worker's forwarded span batches, ingested into
        the parent's recorder, never a request response."""
        while True:
            try:
                req_id, ok, payload = conn.recv()
            except (EOFError, OSError, TypeError):
                # TypeError: close() or restart() closed this pipe end
                # under the blocked recv (its handle became None)
                with self._lock:
                    stale = self._conn is not conn
                    pending = ([] if stale
                               else list(self._futures.values()))
                    if not stale:
                        self._futures.clear()
                for f in pending:
                    # Worker death proves no response will ever come, and
                    # its device state died with it: retriable.
                    f.set_exception(ReplicaDeadError(
                        f"replica {self.name}: worker exited "
                        "mid-request", replica=self.name, retriable=True))
                return
            if req_id == "__spans__":
                if ok:
                    obs_spans.RECORDER.ingest(payload)
                continue
            with self._lock:
                fut = self._futures.pop(req_id, None)
            if fut is None:
                continue
            if ok:
                fut.set_result(payload)
            else:
                fut.set_exception(RuntimeError(payload))

    def _request(self, method: str, args, timeout_s: float | None):
        """Send one request to the worker and wait for its answer."""
        from concurrent.futures import Future
        from concurrent.futures import TimeoutError as FutureTimeout

        fut = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError(f"replica {self.name} is closed")
            req_id = self._next_id
            self._next_id += 1
            self._futures[req_id] = fut
            conn = self._conn
        # the propagated trace context rides in the request tuple, so the
        # child's spans join this request's trace
        ctx = obs_spans.current_context()
        try:
            with self._send_lock:
                conn.send((req_id, method, args, ctx))
        except (OSError, BrokenPipeError, ValueError) as exc:
            # the request never reached the worker: provably safe to
            # re-dispatch on a survivor
            with self._lock:
                self._futures.pop(req_id, None)
            raise ReplicaDeadError(
                f"replica {self.name}: request send failed ({exc})",
                replica=self.name, retriable=True) from exc
        try:
            return fut.result(timeout=timeout_s)
        except FutureTimeout:
            # Deadline blown.  Withdraw the future so a late answer is
            # dropped (the reader treats unknown ids as stale).  A DEAD
            # worker cannot be mid-execution (retriable); a live one may
            # still be running the request on its device.
            with self._lock:
                self._futures.pop(req_id, None)
            dead = not self.alive()
            why = ("worker dead" if dead else
                   "worker alive — not retried, the request may "
                   "still be executing")
            raise ReplicaDeadError(
                f"replica {self.name}: no response within "
                f"{timeout_s:.3f}s ({why})",
                replica=self.name, retriable=dead) from None

    def _call(self, method: str, args, windows: int, requests: int = 1):
        with self._lock:
            self._outstanding += windows
        try:
            return self._request(method, args, self.request_timeout_s)
        finally:
            with self._cv:
                self._outstanding -= windows
                self._cv.notify_all()
            self._m_served_requests.inc(requests, replica=self.name)
            self._m_served_windows.inc(windows, replica=self.name)

    def served_requests(self) -> int:
        return int(self._m_served_requests.value(replica=self.name))

    def served_windows(self) -> int:
        return int(self._m_served_windows.value(replica=self.name))

    def predict_series(self, traffic: np.ndarray,
                       integrate: bool = True) -> np.ndarray:
        traffic = np.ascontiguousarray(traffic, np.float32)
        n = _num_windows(len(traffic), self.window_size)
        return self._call("predict_series", (traffic, integrate), n)

    def predict_series_many(self, series_list, integrate: bool = True):
        series_list = [np.ascontiguousarray(s, np.float32)
                       for s in series_list]
        n = sum(_num_windows(len(s), self.window_size)
                for s in series_list)
        return self._call("predict_series_many", (series_list, integrate), n,
                          requests=len(series_list))

    def worker_stats(self, timeout_s: float = 5.0) -> dict | None:
        """The worker's graph ledger, kernel launches and device memory
        (:func:`_worker_stats`), or None when it does not answer within
        ``timeout_s``; counts as no served request."""
        try:
            return self._request("stats", (), timeout_s)
        except (ReplicaDeadError, RuntimeError):
            return None

    # -- lifecycle -------------------------------------------------------

    def drain(self) -> None:
        with self._lock:
            self._draining = True

    def resume(self) -> None:
        with self._lock:
            self._draining = False

    def wait_idle(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._outstanding > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    def reload_backend(self, fresh) -> None:
        """Process replicas reload by restart: the worker rebuilds its
        stack from the spec (``fresh`` is only the trigger: the child
        loads the newest checkpoint step itself and captures its graphs
        before it answers).  The caller (router) has drained this
        replica, so no request is in flight."""
        self.restart()

    def restart(self) -> None:
        """Reboot the worker: new process/pipe/reader generation from the
        same spec.  Works on a HEALTHY drained worker (rolling reload)
        and on a dead or wedged one (the router's probe after an
        ejection: a SIGKILLed worker reboots here).  Requests still
        pending against the old generation fail with a retriable
        ReplicaDeadError first, so no caller is left holding a future the
        new worker will never answer."""
        with self._lock:
            if self._closed:
                raise RuntimeError(f"replica {self.name} is closed")
            old_conn, old_proc = self._conn, self._proc
            orphans = list(self._futures.values())
            self._futures.clear()
        for f in orphans:
            f.set_exception(ReplicaDeadError(
                f"replica {self.name}: worker restarted mid-request",
                replica=self.name, retriable=True))
        try:
            self._boot()               # new pipe/process/reader generation
        finally:
            # reap the old generation even when the fresh boot fails (the
            # router's probe retries the restart)
            if old_conn is not None:
                try:
                    old_conn.send(None)
                except (OSError, BrokenPipeError):
                    pass
                old_conn.close()       # old reader exits on EOF
            if old_proc is not None:
                old_proc.join(timeout=10)
                if old_proc.is_alive():
                    old_proc.terminate()
                    old_proc.join(timeout=5)
                _release_proc(old_proc)

    def set_batching(self, config) -> None:
        """Batching lives inside the worker's own stack: record the knob
        in the spec; it applies at the next boot, where ``_worker_main``
        attaches the MicroBatcher."""
        with self._lock:
            if config is None:
                self.spec.pop("batching", None)
            else:
                self.spec["batching"] = {
                    "max_batch": config.max_batch,
                    "max_linger_s": config.max_linger_s,
                    "max_queue": config.max_queue,
                }

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._draining = True
            conn, proc = self._conn, self._proc
        if conn is not None:
            try:
                conn.send(None)
            except (OSError, BrokenPipeError):
                pass
            conn.close()
        if proc is not None:
            proc.join(timeout=10)
            if proc.is_alive():
                # a handler may still be mid-predict (the sentinel only
                # stops the recv loop); reap the SIGTERM so close()
                # returns with the worker gone
                proc.terminate()
                proc.join(timeout=5)
            _release_proc(proc)

    def stats(self) -> dict:
        out = {
            "name": self.name,
            "kind": self.kind,
            "pid": self.pid(),
        }
        with self._lock:
            out.update({
                "outstanding_windows": self._outstanding,
                "served_requests": self.served_requests(),
                "served_windows": self.served_windows(),
                "state": ("closed" if self._closed
                          else "draining" if self._draining else "live"),
            })
            closed = self._closed
        # port addition: the worker's own ledger (graphs, kernel launches,
        # device memory), None when it does not answer
        out["worker"] = None if closed else self.worker_stats()
        return out
