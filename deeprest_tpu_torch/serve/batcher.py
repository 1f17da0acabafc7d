"""Cross-request micro-batching: many tiny requests → few device batches
(``deeprest_tpu/serve/batcher.py``, dense plane).

Two pieces, usable separately:

``ShapeLadder``
    Pads every batch up the fixed rung ladder (default {8, 16, 32, 64}
    windows, plus ``coalesce_groups`` super-rungs top·{2..G}) before it
    reaches the model, so the device sees a handful of fixed shapes: on
    CUDA, one captured graph per rung (serve/graphs.py), the counterpart
    of the JAX plane's one executable per rung.  Oversized batches split
    into max-rung chunks.  Padding rows are zeros and their outputs are
    dropped; the model maps rows independently.  ``materialize`` reads the
    chunks back through a pinned buffer, as the fused engine reads its
    pages.

``MicroBatcher``
    A worker thread drains a bounded queue of submitted window batches,
    concatenates them into one ladder dispatch, and demultiplexes the
    results back to per-request futures.  A batch goes out when
    ``max_batch`` windows are pending or ``max_linger_s`` has passed since
    the first arrived.  Double buffer: while the device runs batch k, the
    worker assembles and dispatches batch k+1 before reading k back.  The
    JAX package probes ``jax.Array.is_ready`` for "the device is done";
    the port records one ``torch.cuda.Event`` per dispatch and probes
    ``event.query()`` (on the CPU every dispatch has finished already).

With the sparse feed the ladder also takes RAW padded-COO window batches
(``dispatch_sparse``): zero COO rows pad them up the same rungs, and the
backend's sparse apply densifies and normalizes on the device.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans
from deeprest_tpu_torch.serve.graphs import PinnedReadback

DEFAULT_LADDER = (8, 16, 32, 64)


class BatcherClosed(RuntimeError):
    """Raised by submit() after close(); callers fall back to the direct
    shape-laddered path (a hot-reload swaps batchers between requests, and
    a request that lost that race must not fail)."""


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Flush-policy and queue knobs for :class:`MicroBatcher`.

    ``max_batch`` is in WINDOWS (the device-batch row unit), not requests:
    one request's chunk may carry many windows.  It should normally equal
    the top ladder rung so a full flush fits one rung.
    """

    max_batch: int = 64
    max_linger_s: float = 0.002
    max_queue: int = 1024        # pending-window bound (submit backpressure)

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch {self.max_batch} must be >= 1")
        if self.max_linger_s < 0:
            raise ValueError(f"max_linger_s {self.max_linger_s} must be >= 0")
        if self.max_queue < self.max_batch:
            raise ValueError(f"max_queue {self.max_queue} must be >= "
                             f"max_batch {self.max_batch}")


class ShapeLadder:
    """Pad-and-mask batches onto a fixed shape ladder in front of a
    batched apply function ``[n, W, F] -> [n, W, E, Q]``.

    ``dispatch``/``materialize`` are split so a caller (the MicroBatcher's
    double buffer) can overlap the host-side staging + async device
    dispatch of one batch with the result readback of another;
    ``__call__`` is the synchronous composition.
    """

    def __init__(self, apply_fn, ladder=DEFAULT_LADDER,
                 coalesce_groups: int = 1, device="cpu",
                 apply_sparse_fn=None):
        base = tuple(sorted({int(r) for r in ladder}))
        if not base or base[0] < 1:
            raise ValueError(f"bad shape ladder {ladder!r}")
        if coalesce_groups < 1:
            raise ValueError(
                f"coalesce_groups {coalesce_groups} must be >= 1")
        self._apply = apply_fn
        # the sparse feed's apply: RAW (cols [n, W, K], vals [n, W, K])
        # window batches, densified and normalized on the device
        self._apply_sparse = apply_sparse_fn
        self.base_ladder = base
        self.coalesce_groups = int(coalesce_groups)
        # Coalesced super-rungs: top·{2..G} join the ladder so a deep
        # cross-request backlog dispatches ONE fat batch (top·G recurrence
        # rows) instead of G sequential top-rung dispatches.  Each
        # super-rung is one more captured graph, as any rung.
        rungs = set(base)
        rungs.update(base[-1] * g for g in range(2, self.coalesce_groups + 1))
        self.ladder = tuple(sorted(rungs))
        self._readback = PinnedReadback(device)
        self._lock = threading.Lock()
        self._compiled: set[int] = set()     # rungs dispatched at least once
        self._calls = 0
        self._windows = 0
        self._padded_windows = 0
        self._rung_hits = 0

    @property
    def max_rung(self) -> int:
        return self.ladder[-1]

    def rung_for(self, n: int) -> int:
        """Smallest rung >= n (callers chunk to max_rung first)."""
        for r in self.ladder:
            if n <= r:
                return r
        raise ValueError(f"batch of {n} windows exceeds top rung "
                         f"{self.max_rung}; chunk before dispatching")

    def dispatch(self, x: np.ndarray) -> list[tuple[object, int]]:
        """Stage + asynchronously dispatch ``x`` as ladder-padded chunks;
        returns ``[(device_result, valid_rows), ...]`` for materialize().
        Each result is the caller's own tensor (a copy of the rung graph's
        output on CUDA)."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        parts: list[tuple[object, int]] = []
        for lo in range(0, len(x), self.max_rung):
            chunk = x[lo:lo + self.max_rung]
            rung = self.rung_for(len(chunk))
            padded = chunk
            if rung > len(chunk):
                padded = np.zeros((rung, *chunk.shape[1:]), np.float32)
                padded[:len(chunk)] = chunk
            self._count(len(chunk), rung)
            parts.append((self._apply(padded), len(chunk)))
        return parts

    def _count(self, n: int, rung: int) -> None:
        """One dispatch of ``n`` windows padded to ``rung``."""
        with self._lock:
            self._calls += 1
            self._windows += n
            self._padded_windows += rung - n
            if rung in self._compiled:
                self._rung_hits += 1
            else:
                self._compiled.add(rung)

    def dispatch_sparse(self, cols: np.ndarray,
                        vals: np.ndarray) -> list[tuple[object, int]]:
        """COO twin of :meth:`dispatch`: RAW ``(cols [n, W, K], vals [n, W,
        K])`` window batches as ladder-padded chunks (padding rows are zero
        COO rows, whose densified windows are zero; materialize drops
        them).  Host→device bytes per window are ``W·K·8`` instead of
        ``W·F·4``."""
        if self._apply_sparse is None:
            raise ValueError("this ladder has no sparse apply; construct "
                             "it with apply_sparse_fn (sparse_feed)")
        cols = np.ascontiguousarray(cols, dtype=np.int32)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        if cols.shape != vals.shape:
            raise ValueError(f"padded-COO halves disagree: cols "
                             f"{cols.shape} vs vals {vals.shape}")
        parts: list[tuple[object, int]] = []
        for lo in range(0, len(cols), self.max_rung):
            c = cols[lo:lo + self.max_rung]
            v = vals[lo:lo + self.max_rung]
            n = len(c)
            rung = self.rung_for(n)
            if rung > n:
                pc = np.zeros((rung, *c.shape[1:]), np.int32)
                pv = np.zeros((rung, *v.shape[1:]), np.float32)
                pc[:n] = c
                pv[:n] = v
                c, v = pc, pv
            self._count(n, rung)
            parts.append((self._apply_sparse(c, v), n))
        return parts

    def materialize(self, parts: list[tuple[torch.Tensor, int]]
                    ) -> np.ndarray:
        """Read the device results back (through the pinned buffer on
        CUDA) and strip the padding rows."""
        return self._readback.rows(parts)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.materialize(self.dispatch(x))

    def stats(self) -> dict:
        with self._lock:
            return {
                "ladder": list(self.ladder),
                "coalesce_groups": self.coalesce_groups,
                "calls": self._calls,
                "windows": self._windows,
                "padded_windows": self._padded_windows,
                "rung_hits": self._rung_hits,
                "rung_compiles": len(self._compiled),
                "compiled_rungs": sorted(self._compiled),
            }


class _Pending:
    __slots__ = ("x", "future", "ctx")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.future: Future = Future()
        # The submitting request's trace context: the worker thread's
        # coalesced-dispatch span parents onto the first submitter so a
        # request's trace reaches across the thread boundary.
        self.ctx = obs_spans.current_context()


def _inflight_ready(inflight) -> bool:
    """True once the device has finished an in-flight dispatch: its CUDA
    event has passed (dispatches without one, on the CPU, are done)."""
    if inflight is None:
        return True
    event = inflight[3]
    return event is None or event.query()


class MicroBatcher:
    """Coalesces concurrent window-batch submissions into shared ladder
    dispatches on a single worker thread (see module docstring)."""

    def __init__(self, ladder: ShapeLadder,
                 config: BatcherConfig | None = None):
        self.config = config or BatcherConfig()
        self._ladder = ladder
        self._cv = threading.Condition()
        self._pending: collections.deque[_Pending] = collections.deque()
        self._pending_windows = 0
        self._running = True
        # Batch accounting lives in obs metrics (per-instance objects —
        # the /healthz JSON view and the /metrics exposition read the
        # SAME counters; the newest plane's batcher owns the exposition
        # binding via the serving collector).
        self._m = obs_metrics.Counter(
            "deeprest_batcher_events_total",
            "micro-batcher accounting by event kind",
            labelnames=("event",))
        self._m_max_batch = obs_metrics.Gauge(
            "deeprest_batcher_max_batch_windows",
            "widest coalesced batch dispatched (high-water mark)")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    # -- client side ----------------------------------------------------

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue a ``[n, W, F]`` normalized window batch; the future
        resolves to the ``[n, W, E, Q]`` result.  Blocks (backpressure)
        while ``max_queue`` windows are already pending."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 3 or len(x) == 0:
            raise ValueError(f"expected non-empty [n, W, F] windows, "
                             f"got shape {x.shape}")
        p = _Pending(x)
        with self._cv:
            while (self._running
                   and self._pending_windows + len(x) > self.config.max_queue
                   and self._pending_windows > 0):
                self._cv.wait()
            if not self._running:
                raise BatcherClosed("micro-batcher is closed")
            self._pending.append(p)
            self._pending_windows += len(x)
            self._m.inc(event="submitted")
            self._cv.notify_all()
        return p.future

    def apply(self, x: np.ndarray) -> np.ndarray:
        """Synchronous submit — the rolled_prediction-compatible entry."""
        return self.submit(x).result()

    def stats(self) -> dict:
        # Same JSON shape as the historical dict — now a VIEW over the
        # obs counters (one source of truth with /metrics).
        events = self._m.series()

        def ev(name: str) -> int:
            return int(events.get((name,), 0.0))

        out = {"submitted": ev("submitted"), "batches": ev("batches"),
               "windows": ev("windows"),
               "max_batch_windows": int(self._m_max_batch.value()),
               "coalesced_batches": ev("coalesced_batches"),
               "flush_full": ev("flush_full"),
               "flush_linger": ev("flush_linger"),
               "flush_pipeline": ev("flush_pipeline"),
               "errors": ev("errors")}
        with self._cv:
            out["queue_depth_windows"] = self._pending_windows
            out["queue_depth_requests"] = len(self._pending)
        out["max_batch"] = self.config.max_batch
        out["max_linger_ms"] = self.config.max_linger_s * 1e3
        out["shape_ladder"] = self._ladder.stats()
        return out

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop accepting work, drain what is queued, join the worker."""
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=timeout_s)

    # -- worker side ----------------------------------------------------

    def _collect(self, block: bool, inflight_ready=None) -> list[_Pending]:
        """Take up to ``max_batch`` windows of pending submissions.

        ``block=True`` (nothing in flight): wait indefinitely for the
        first submission, then linger up to ``max_linger_s`` for
        co-arrivals, flushing early once ``max_batch`` windows are
        pending.  ``block=False`` (a batch is executing on the device):
        the device busy time IS the coalescing window, so waiting up to
        ``max_linger_s`` here is free overlap — but the wait breaks the
        moment ``inflight_ready()`` reports the device done, so a
        finished batch is never held hostage to the linger clock.
        """
        cfg = self.config
        with self._cv:
            if block:
                while self._running and not self._pending:
                    self._cv.wait()
            if self._running and cfg.max_linger_s > 0:
                deadline = time.monotonic() + cfg.max_linger_s
                while (self._running
                       and self._pending_windows < cfg.max_batch
                       and (self._pending or not block)):
                    if (not block and inflight_ready is not None
                            and inflight_ready()):
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(left if block else min(left, 5e-4))
            group: list[_Pending] = []
            take = 0
            while self._pending and take < cfg.max_batch:
                n = len(self._pending[0].x)
                if group and take + n > cfg.max_batch:
                    break
                group.append(self._pending.popleft())
                take += n
            if group:
                self._pending_windows -= take
                reason = ("flush_pipeline" if not block
                          else "flush_full" if take >= cfg.max_batch
                          else "flush_linger")
                self._m.inc(event=reason)
                self._m.inc(event="batches")
                self._m.inc(take, event="windows")
                if len(group) > 1:
                    self._m.inc(event="coalesced_batches")
                self._m_max_batch.set_max(take)
                self._cv.notify_all()      # wake back-pressured submitters
            return group

    def _dispatch(self, group: list[_Pending]):
        """Concatenate + stage + async-dispatch one coalesced batch.

        The dispatch span parents onto the FIRST submitter's captured
        trace context (request-scoped ids cross the worker-thread
        boundary) and tags how many requests coalesced.
        """
        sizes = [len(p.x) for p in group]
        try:
            with obs_spans.RECORDER.span(
                    "batch.dispatch", component="deeprest-batcher",
                    parent=group[0].ctx) as sp:
                sp.tag(requests=len(group), windows=sum(sizes))
                x = (group[0].x if len(group) == 1
                     else np.concatenate([p.x for p in group], axis=0))
                parts = self._ladder.dispatch(x)
                event = None
                if parts and parts[0][0].is_cuda:
                    event = torch.cuda.Event()
                    event.record()
        except Exception as exc:
            self._m.inc(event="errors")
            for p in group:
                p.future.set_exception(exc)
            return None
        return parts, group, sizes, event

    def _resolve(self, inflight) -> None:
        parts, group, sizes, _ = inflight
        try:
            y = self._ladder.materialize(parts)
        except Exception as exc:
            self._m.inc(event="errors")
            for p in group:
                p.future.set_exception(exc)
            return
        lo = 0
        for p, n in zip(group, sizes):
            p.future.set_result(y[lo:lo + n])
            lo += n

    def _run(self) -> None:
        inflight = None
        while True:
            # Double buffer: dispatch batch k+1 BEFORE blocking on batch
            # k's readback, so host concat/pad/staging overlaps device
            # execution of the previous batch.
            group = self._collect(
                block=inflight is None,
                inflight_ready=lambda: _inflight_ready(inflight))
            dispatched = self._dispatch(group) if group else None
            if inflight is not None:
                self._resolve(inflight)
            inflight = dispatched
            if inflight is None:
                with self._cv:
                    if not self._running and not self._pending:
                        return


class BatchedBackendMixin:
    """The shape-laddered batch entry point of a serving backend, plus an
    optional attached MicroBatcher that all ``predict_series`` traffic
    short enough for one ladder dispatch routes through."""

    def _init_batching(self, apply_fn, ladder=None,
                       coalesce_groups: int = 1,
                       apply_sparse_fn=None) -> None:
        self.ladder = ShapeLadder(apply_fn, ladder or DEFAULT_LADDER,
                                  coalesce_groups=coalesce_groups,
                                  device=self.device,
                                  apply_sparse_fn=apply_sparse_fn)
        self._batcher: MicroBatcher | None = None

    @property
    def batcher(self) -> MicroBatcher | None:
        return self._batcher

    def attach_batcher(self, batcher: MicroBatcher | None) -> None:
        """Route this backend's window batches through ``batcher`` (None
        detaches).  The batcher must wrap this backend's ``ladder``."""
        self._batcher = batcher

    def apply_windows(self, x: np.ndarray) -> np.ndarray:
        """``[n, W, F]`` normalized windows → ``[n, W, E, Q]`` de-padded
        numpy results: through the attached MicroBatcher when one is
        present (cross-request coalescing), else a direct shape-laddered
        dispatch."""
        b = self._batcher
        if b is not None:
            try:
                return b.apply(x)
            except BatcherClosed:
                pass      # hot-reload race: fall through to the direct path
        return self.ladder(x)

    def apply_windows_sparse(self, cols: np.ndarray,
                             vals: np.ndarray) -> np.ndarray:
        """Padded-COO batch entry: RAW ``(cols [n, W, K], vals [n, W, K])``
        windows → ``[n, W, E, Q]`` de-padded results, densified and
        normalized on the device (the dense entry takes normalized
        windows; the sparse one ships raw counts).  Straight through the
        ladder's sparse staging: cross-request coalescing stays a
        dense-plane feature.  A backend without a sparse apply densifies
        on the host, bit-exact by construction."""
        if self.ladder._apply_sparse is None:
            from deeprest_tpu_torch.ops.densify import densify_rows

            dense = densify_rows(cols, vals, self.feature_dim)
            return self.apply_windows(
                self.x_stats.apply(dense).astype(np.float32))
        return self.ladder.materialize(
            self.ladder.dispatch_sparse(cols, vals))
