"""Counters / gauges / histograms with Prometheus text exposition
(``deeprest_tpu/obs/metrics.py``, whole: the port keeps its own copy, so
the metric names, the text format and the semantics are the JAX
package's).

The reference feeds DeepRest from a Prometheus it deploys next to the
cluster (PAPERS.md [1]); this registry makes the estimation plane itself
a first-class scrape target: ``GET /metrics`` on the prediction server
renders everything registered here in the Prometheus text format
(version 0.0.4), so the same scrape-and-ingest loop that feeds the model
can observe the model's own serving/training plane.

Design points:

- **Metric objects are standalone** — a component creates its Counter /
  Gauge / Histogram, keeps the reference, and *that object* is the single
  source of truth its JSON stats (``/healthz``), the autoscaler's demand
  reads, and the ``/metrics`` exposition all share.  The registry only
  binds names to objects for rendering.
- **``expose`` replaces by name** — per-plane metrics (admission
  counters, HTTP latency) are re-created when a plane is rebuilt (tests
  build many); the newest binding wins in the exposition while every
  instance keeps counting correctly for its own stats.
- **Collectors** are callables invoked at render time with a
  :class:`SampleSink`; they publish point-in-time views of state that is
  already counted elsewhere (replica outstanding work, jit cache sizes,
  queue depths) without adding any steady-state cost to the hot path.
- **TH004 discipline**: every mutable field of every metric is accessed
  under that metric's own lock; the lock never wraps a call out of this
  module, so no lock-ordering edge can cycle (TH002).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0)

_LABEL_NONE: tuple = ()


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers render bare (exposition
    golden tests pin this), floats via repr for round-trip fidelity."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labelnames: tuple, labelvalues: tuple) -> str:
    if not labelnames:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(labelnames, labelvalues))
    return "{" + inner + "}"


class _Metric:
    """Shared base: a name, optional label dimensions, and one value slot
    per observed label combination (created on first touch)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        self.name = str(name)
        self.help = str(help)
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)

    def samples(self) -> list[tuple[str, str, float]]:
        """``(name, labelstr, value)`` rows for the exposition."""
        with self._lock:
            items = sorted(self._series.items())
        if not items and not self.labelnames:
            items = [(_LABEL_NONE, 0.0)]
        return [(self.name, _label_str(self.labelnames, k), v)
                for k, v in items]


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc {amount})")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def set_max(self, value: float, **labels) -> None:
        """High-water-mark update (batcher max_batch_windows style)."""
        key = self._key(labels)
        with self._lock:
            self._series[key] = max(self._series.get(key, 0.0), float(value))


class Histogram(_Metric):
    """Cumulative-bucket histogram (the Prometheus shape: ``le`` buckets
    + ``_sum`` + ``_count``)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Iterable[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"{self.name}: need at least one bucket")
        # per label key: ([bucket counts...], sum, count)
        self._h: dict[tuple, tuple[list[int], float, int]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            counts, total, n = self._h.get(
                key, ([0] * len(self.buckets), 0.0, 0))
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
            self._h[key] = (counts, total + v, n + 1)

    def snapshot(self, **labels) -> dict:
        key = self._key(labels)
        with self._lock:
            counts, total, n = self._h.get(
                key, ([0] * len(self.buckets), 0.0, 0))
            return {"buckets": dict(zip(self.buckets, counts)),
                    "sum": total, "count": n}

    def samples(self) -> list[tuple[str, str, float]]:
        with self._lock:
            items = sorted((k, ([*c], t, n))
                           for k, (c, t, n) in self._h.items())
        out: list[tuple[str, str, float]] = []
        for key, (counts, total, n) in items:
            for b, c in zip(self.buckets, counts):
                ls = _label_str(self.labelnames + ("le",),
                                key + (_fmt(b),))
                out.append((self.name + "_bucket", ls, c))
            ls_inf = _label_str(self.labelnames + ("le",), key + ("+Inf",))
            out.append((self.name + "_bucket", ls_inf, n))
            base = _label_str(self.labelnames, key)
            out.append((self.name + "_sum", base, total))
            out.append((self.name + "_count", base, n))
        return out


class Stopwatch:
    """The sanctioned elapsed-time primitive for hot modules: OB001 flags
    ad-hoc ``perf_counter()/time.time()`` deltas in serve/ and train/ —
    latency belongs in a span or a metric, and this is the clock those
    sites migrate onto (obs owns the raw timer so the rule has exactly
    one home to exempt)."""

    __slots__ = ("_t0",)

    def __init__(self):
        self._t0 = time.perf_counter()

    def restart(self) -> None:
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def observe_into(self, histogram: Histogram, **labels) -> float:
        e = self.elapsed()
        histogram.observe(e, **labels)
        return e


class SampleSink:
    """What render-time collectors write into (point-in-time samples)."""

    def __init__(self):
        self.rows: list[tuple[str, str, str, str, float]] = []
        self._help_seen: set[str] = set()

    def _emit(self, kind: str, name: str, help: str, labels: dict | None,
              value: float) -> None:
        names = tuple(sorted(labels)) if labels else ()
        values = tuple(str(labels[n]) for n in names) if labels else ()
        self.rows.append((name, kind, help,
                          _label_str(names, values), float(value)))

    def gauge(self, name: str, value: float, help: str = "",
              labels: dict | None = None) -> None:
        self._emit("gauge", name, help, labels, value)

    def counter(self, name: str, value: float, help: str = "",
                labels: dict | None = None) -> None:
        self._emit("counter", name, help, labels, value)


class MetricsRegistry:
    """Name → metric bindings plus render-time collectors.

    ``counter/gauge/histogram`` are get-or-create for process-wide
    singletons (the trainer/ETL series); ``expose`` binds an existing
    per-component object, replacing any previous binding of the same name
    (a rebuilt serving plane re-exposes its fresh counters).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: dict[str, Callable[[SampleSink], None]] = {}

    # -- binding ---------------------------------------------------------

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.labelnames}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, tuple(labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, tuple(labelnames))

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, tuple(labelnames),
                                   buckets=buckets)

    def expose(self, metric: _Metric) -> _Metric:
        """Bind ``metric`` under its name (newest binding wins — the
        rebuilt-plane contract in the module docstring)."""
        with self._lock:
            self._metrics[metric.name] = metric
        return metric

    def register_collector(self, name: str,
                           fn: Callable[[SampleSink], None]) -> None:
        """A render-time view over state counted elsewhere; re-registering
        a name replaces the previous collector (rebuilt planes again)."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str,
                             fn: Callable[[SampleSink], None] | None = None
                             ) -> None:
        """Drop a render-time collector.  Pass the registering ``fn`` to
        make the removal conditional: a closing plane must drop ITS OWN
        collector (the registry is process-wide — a registered bound
        method pins the closed plane, and every device buffer behind it,
        forever: the round-20 device-buffer census caught exactly this)
        without clobbering a rebuilt plane's newer registration."""
        with self._lock:
            if fn is None or self._collectors.get(name) == fn:
                self._collectors.pop(name, None)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every binding and collector (test isolation)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    # -- exposition ------------------------------------------------------

    def render(self) -> str:
        """Prometheus text format (0.0.4) over bound metrics + collector
        samples, deterministically ordered by metric name."""
        with self._lock:
            metrics = dict(self._metrics)
            collectors = dict(self._collectors)
        sink = SampleSink()
        for name in sorted(collectors):
            try:
                collectors[name](sink)
            except Exception:  # a broken view must not kill the scrape
                sink.counter("deeprest_collector_errors_total", 1.0,
                             help="collectors that raised during render",
                             labels={"collector": name})
        lines: list[str] = []
        emitted: set[str] = set()
        for name in sorted(metrics):
            m = metrics[name]
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            emitted.add(m.name)
            for sample_name, labelstr, value in m.samples():
                lines.append(f"{sample_name}{labelstr} {_fmt(value)}")
        by_name: dict[str, list] = {}
        for row in sink.rows:
            by_name.setdefault(row[0], []).append(row)
        for name in sorted(by_name):
            if name in emitted:
                continue
            rows = by_name[name]
            lines.append(f"# HELP {name} {rows[0][2]}")
            lines.append(f"# TYPE {name} {rows[0][1]}")
            for _, _, _, labelstr, value in rows:
                lines.append(f"{name}{labelstr} {_fmt(value)}")
        return "\n".join(lines) + "\n"


# The process-default registry the /metrics route renders.
REGISTRY = MetricsRegistry()

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

__all__ = ["Counter", "Gauge", "Histogram", "Stopwatch", "MetricsRegistry",
           "SampleSink", "REGISTRY", "PROMETHEUS_CONTENT_TYPE"]
