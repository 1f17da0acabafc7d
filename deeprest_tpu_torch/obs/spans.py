"""Request-scoped spans over a lock-disciplined ring buffer
(``deeprest_tpu/obs/spans.py``, whole: the port's own copy).

DeepRest's raw material is distributed traces (PAPERS.md [1] deploys
Jaeger just to feed the model), yet until now the plane that *serves*
those estimates produced none of its own.  This module is the span half
of the obs package: a bounded in-process recorder with a context-manager
API, request-scoped trace ids propagated through the serving layers
(server → router → replica, across a worker process's pipe → batcher →
fused dispatch) via a ``contextvars`` context, and a wire-friendly record shape that
``obs/export.py`` turns into Jaeger-style JSON the standard ingest
pipeline (data/ingest.py) consumes — the self-ingestion loop.

Cost discipline:

- **Disabled** (the default outside ``deeprest serve --obs``): ``span()``
  returns a module-level singleton no-op context manager — no object
  allocation, no lock, no clock read.  tests/test_obs.py probes this
  with an allocated-blocks delta.
- **Enabled**: one clock pair + one ring append per span, under the
  recorder lock only at commit (the ring is the ONLY shared mutable
  state; the enabled flag is deliberately never read or written under a
  lock — a torn read costs at most one dropped/extra span).

Cross-boundary propagation:

- Same thread: the contextvar carries ``(trace_id, span_id)``; nested
  spans parent automatically.
- Cross thread (the MicroBatcher worker): callers capture
  :func:`current_context` at submit time and pass it as ``parent=`` when
  the worker opens its span.
- Cross process (ProcessReplica workers): the parent ships the context
  in the request tuple; the child adopts it with :func:`set_context`,
  records into its own recorder, and forwards the committed spans back
  over the existing duplex pipe (a ``"__spans__"``-tagged message) for
  :meth:`SpanRecorder.ingest`.
"""

from __future__ import annotations

import contextvars
import dataclasses
import itertools
import os
import threading
import time
from collections import deque

_CTX: contextvars.ContextVar[tuple[str, str] | None] = contextvars.ContextVar(
    "deeprest_obs_trace", default=None)


def current_context() -> tuple[str, str] | None:
    """The active ``(trace_id, span_id)`` pair, or None outside any span.
    The handle callers capture to parent work that continues on another
    thread (batcher worker) or process (replica worker)."""
    return _CTX.get()


def set_context(ctx: tuple[str, str] | None):
    """Adopt a propagated context on a fresh thread/process; returns the
    token for ``contextvars.ContextVar.reset``."""
    return _CTX.set(tuple(ctx) if ctx is not None else None)


# Span/trace ids: a per-process random base + a monotone counter — an
# order of magnitude cheaper than uuid4 on the enabled hot path, unique
# across processes (replica workers mint their own base), and still
# 16-hex like Jaeger's span ids.  ``itertools.count`` is C-implemented,
# so ``next`` is atomic under the GIL (no lock on the id path).
_ID_BASE = f"{int.from_bytes(os.urandom(5), 'big'):010x}"
_ID_COUNTER = itertools.count(1)


def _new_id() -> str:
    return _ID_BASE + f"{next(_ID_COUNTER) & 0xFFFFFF:06x}"


@dataclasses.dataclass
class SpanRecord:
    """One finished span (the ring buffer's element).

    ``start_s`` is WALL-CLOCK epoch seconds (what Jaeger carries and what
    ``data/ingest.bucketize`` grids on); ``duration_s`` is measured on the
    monotonic clock so a wall-clock step cannot corrupt it.
    """

    name: str                   # operation (Jaeger operationName)
    component: str              # service identity (Jaeger process)
    trace_id: str
    span_id: str
    parent_id: str | None
    start_s: float
    duration_s: float
    tags: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SpanRecord":
        return cls(name=str(d["name"]), component=str(d["component"]),
                   trace_id=str(d["trace_id"]), span_id=str(d["span_id"]),
                   parent_id=d.get("parent_id"),
                   start_s=float(d["start_s"]),
                   duration_s=float(d["duration_s"]),
                   tags=dict(d.get("tags") or {}))


class _NullSpan:
    """The disabled-mode singleton: every method is a no-op and
    ``__enter__`` returns the singleton itself, so a disabled
    ``with recorder.span(...):`` allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kv):
        return self


NULL_SPAN = _NullSpan()


class ActiveSpan:
    """A live span: context manager that installs itself as the current
    context, measures duration on the monotonic clock, and commits to the
    recorder ring on exit."""

    __slots__ = ("_recorder", "name", "component", "tags", "trace_id",
                 "span_id", "parent_id", "start_s", "duration_s",
                 "_t0", "_token")

    def __init__(self, recorder: "SpanRecorder", name: str, component: str,
                 tags: dict | None, parent: tuple[str, str] | None):
        self._recorder = recorder
        self.name = name
        self.component = component
        self.tags = dict(tags) if tags else {}
        ctx = parent if parent is not None else _CTX.get()
        if ctx is None:
            self.trace_id = _new_id()
            self.parent_id = None
        else:
            self.trace_id, self.parent_id = ctx[0], ctx[1]
        self.span_id = _new_id()
        self.start_s = 0.0
        self.duration_s = 0.0
        self._t0 = 0.0
        self._token = None

    def tag(self, **kv) -> "ActiveSpan":
        self.tags.update(kv)
        return self

    @property
    def context(self) -> tuple[str, str]:
        return (self.trace_id, self.span_id)

    def __enter__(self) -> "ActiveSpan":
        self.start_s = time.time()
        self._t0 = time.perf_counter()
        self._token = _CTX.set((self.trace_id, self.span_id))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.duration_s = time.perf_counter() - self._t0
        if self._token is not None:
            _CTX.reset(self._token)
            self._token = None
        if exc_type is not None:
            self.tags.setdefault("error", exc_type.__name__)
        self._recorder._commit(SpanRecord(
            name=self.name, component=self.component,
            trace_id=self.trace_id, span_id=self.span_id,
            parent_id=self.parent_id, start_s=self.start_s,
            duration_s=self.duration_s, tags=self.tags))
        return False


class SpanRecorder:
    """Bounded span sink: newest ``capacity`` spans win (a long-lived
    serving process must never grow without bound).

    Lock discipline (the TH004 contract this module itself must satisfy):
    the ring and its drop counter are accessed ONLY under ``_lock``;
    ``enabled`` is a bare attribute that is *consistently* unlocked — the
    hot-path check must not take a lock, and the worst a torn flag read
    can cost is one span recorded or skipped across an enable() edge.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"span capacity {capacity} must be >= 1")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._ring: deque[SpanRecord] = deque(maxlen=self.capacity)
        self._recorded = 0        # total committed (incl. later-evicted)

    # -- producer side ---------------------------------------------------

    def span(self, name: str, component: str = "deeprest",
             tags: dict | None = None,
             parent: tuple[str, str] | None = None):
        """Context manager for one unit of work.  Disabled: returns the
        shared no-op singleton (zero allocation — the probe in
        tests/test_obs.py pins this)."""
        if not self.enabled:
            return NULL_SPAN
        return ActiveSpan(self, name, component, tags, parent)

    def _commit(self, record: SpanRecord) -> None:
        with self._lock:
            self._ring.append(record)
            self._recorded += 1

    def ingest(self, records) -> None:
        """Adopt spans recorded elsewhere (a process replica's worker
        forwards its batch over the duplex pipe as dicts)."""
        for r in records:
            self._commit(r if isinstance(r, SpanRecord)
                         else SpanRecord.from_dict(r))

    # -- consumer side ---------------------------------------------------

    def snapshot(self) -> list[SpanRecord]:
        """Copy of the retained spans, oldest first (the ring stays)."""
        with self._lock:
            return list(self._ring)

    def drain(self) -> list[SpanRecord]:
        """Pop every retained span (the worker-side pipe forwarding and
        bounded exports use this)."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def set_capacity(self, capacity: int) -> None:
        """Rebound the ring in place (newest spans retained).  In place so
        every module holding a reference to the process-default recorder
        keeps recording into the same object."""
        if capacity < 1:
            raise ValueError(f"span capacity {capacity} must be >= 1")
        with self._lock:
            self.capacity = int(capacity)
            self._ring = deque(self._ring, maxlen=self.capacity)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def stats(self) -> dict:
        with self._lock:
            retained = len(self._ring)
            recorded = self._recorded
            capacity = self.capacity
        return {"enabled": self.enabled, "capacity": capacity,
                "retained": retained, "recorded": recorded,
                "evicted": max(0, recorded - retained)}


# The process-default recorder every instrumentation site records into.
# Disabled until obs.configure(enabled=True) (the serve CLI's --obs flag,
# on by default there); library users pay a single attribute check.
RECORDER = SpanRecorder(capacity=4096, enabled=False)


def span(name: str, component: str = "deeprest", tags: dict | None = None,
         parent: tuple[str, str] | None = None):
    """Module-level shortcut onto the default recorder."""
    return RECORDER.span(name, component, tags, parent)


__all__ = ["SpanRecord", "SpanRecorder", "ActiveSpan", "NULL_SPAN",
           "RECORDER", "span", "current_context", "set_context"]
