"""Model-quality observability: online drift and calibration monitors and
the streaming verdict surface (``deeprest_tpu/obs/quality.py``, whole).

The second DeepRest use case, spotting utilization not justified by
traffic, only holds while the model itself is still trustworthy.  These
monitors watch the live bucket stream and feed the signal back into
retraining (``train/stream.DriftController`` is the act half of the loop):

- :class:`FeatureDriftMonitor`: per-call-path-column distribution shift
  (PSI and KS) between a REFERENCE window (the distribution the current
  params were trained on) and the LIVE trailing window.  Histograms
  accumulate straight off padded-COO ``(cols, vals)`` rows in
  per-active-column dict slots, so no ``[..., F]``-wide dense tensor
  exists on the streaming path; the one dense window each SWEEP builds for
  the model's input goes through ``ops/densify.py``.
- :class:`CalibrationMonitor`: rolling empirical q05–q95 band coverage
  and pinball loss per component×resource against trailing ground truth,
  aggregated over a bounded window of sweeps and reproducible from the
  per-sweep records.
- the continuous **not-justified-by-traffic** check: the anomaly logic of
  ``serve/anomaly.AnomalyDetector`` (monotone-rearranged bands,
  increment-space delta metrics, re-anchored levels) run on the trailing
  window every sweep, its mean normalized excess feeding a per-metric
  hysteresis machine.

Every per-stream verdict goes through :class:`HysteresisVerdict`
(separate enter/exit thresholds plus sustained-window counts), so a single
noisy window never flaps the surface.  Scores and states publish as
Prometheus gauges and counters under the JAX package's names, each sweep
runs under a span, and ``GET /v1/verdict`` (serve/server.py) renders
:meth:`QualityMonitor.verdicts`.

The sweep's model work arrives through the caller's backend object (a
Predictor, whose rung graphs run K1 on a GPU, or the stream-side
:class:`WindowBackend`, whose apply is the trainer's own ``QuantileGRU``
forward on the live parameter tensors).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Iterable, Sequence

import numpy as np

from deeprest_tpu_torch.config import QualityConfig
from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans

VERDICT_OK = "ok"
VERDICT_DRIFT = "drift"
VERDICT_ANOMALY = "anomaly"
_STATE_CODE = {VERDICT_OK: 0, VERDICT_DRIFT: 1, VERDICT_ANOMALY: 2}


class HysteresisVerdict:
    """Two-threshold sustained-count state machine.

    Enter when the score holds at/above ``enter`` for ``sustain_enter``
    CONSECUTIVE updates; exit when it holds at/below ``exit`` for
    ``sustain_exit`` consecutive updates.  The gap between the thresholds
    plus the sustain counts is the flap suppression: a single noisy
    window (or a score oscillating across one threshold) can never
    toggle the state.
    """

    __slots__ = ("enter", "exit", "sustain_enter", "sustain_exit",
                 "active", "score", "transitions", "_streak")

    def __init__(self, enter: float, exit: float,
                 sustain_enter: int = 2, sustain_exit: int = 2):
        if exit > enter:
            raise ValueError(
                f"hysteresis exit threshold {exit} must be <= enter "
                f"threshold {enter}")
        if sustain_enter < 1 or sustain_exit < 1:
            raise ValueError("sustain counts must be >= 1")
        self.enter = float(enter)
        self.exit = float(exit)
        self.sustain_enter = int(sustain_enter)
        self.sustain_exit = int(sustain_exit)
        self.active = False
        self.score = 0.0
        self.transitions = 0            # activations + deactivations
        self._streak = 0

    def update(self, score: float) -> bool:
        self.score = float(score)
        if not self.active:
            self._streak = self._streak + 1 if self.score >= self.enter else 0
            if self._streak >= self.sustain_enter:
                self.active, self._streak = True, 0
                self.transitions += 1
        else:
            self._streak = self._streak + 1 if self.score <= self.exit else 0
            if self._streak >= self.sustain_exit:
                self.active, self._streak = False, 0
                self.transitions += 1
        return self.active

    def reset(self) -> None:
        self.active = False
        self._streak = 0
        self.score = 0.0


# Count-valued bin edges for call-path columns (traffic counts are small
# integers; the zero cell is derived from row counts, never stored).  The
# same global edges serve every column, so per-column state is one small
# int vector — F never enters the storage shape.
_COUNT_EDGES = (1.5, 2.5, 4.5, 8.5, 16.5, 32.5, 64.5, 128.5, 512.5)


def _row_pairs(rows: Iterable) -> Iterable[tuple[np.ndarray, np.ndarray]]:
    """Normalize monitor input rows to ``(cols, vals)`` pairs: dense
    ``[F]`` rows sparsify via ``flatnonzero`` (a read of the existing
    row, not an F-wide allocation); sparse rows pass through."""
    for row in rows:
        if isinstance(row, tuple):
            yield row
        else:
            row = np.asarray(row)
            nz = np.flatnonzero(row)
            yield nz.astype(np.int32), row[nz].astype(np.float32)


@dataclasses.dataclass
class DriftScore:
    """One drift comparison: live trailing window vs the reference."""

    psi: float                 # traffic-mass-weighted mean PSI
    psi_max: float             # worst single column
    ks_max: float              # worst single-column KS distance
    columns_over: int          # columns whose own PSI crosses the threshold
    columns: int               # active columns in reference ∪ live


class FeatureDriftMonitor:
    """Streaming per-call-path-column PSI/KS, COO rows in, no dense F.

    ``set_reference(rows)`` freezes the distribution the current params
    were trained on (the retained rings after a refresh, or the first
    live window on the serving plane); ``compare(rows)`` scores the live
    trailing window against it.  Histograms live in per-ACTIVE-column
    dict slots keyed by column id — storage is O(observed columns), and
    a column absent from a window contributes its zero cell implicitly
    (derived from the window's row count), so added and removed services
    score symmetrically.
    """

    def __init__(self, edges: Sequence[float] = _COUNT_EDGES,
                 column_threshold: float = 0.25):
        self.edges = np.asarray(edges, np.float64)
        self.column_threshold = float(column_threshold)
        self._ref: dict[int, np.ndarray] | None = None
        self._ref_n = 0
        self._ref_mass: dict[int, float] = {}

    @property
    def ready(self) -> bool:
        return self._ref is not None and self._ref_n > 0

    @property
    def reference_rows(self) -> int:
        return self._ref_n

    def _hists(self, rows) -> tuple[dict[int, np.ndarray],
                                    dict[int, float], int]:
        """Per-column nonzero-value histograms + traffic-mass totals."""
        hists: dict[int, np.ndarray] = {}
        mass: dict[int, float] = {}
        n = 0
        nbins = len(self.edges) + 1
        for cols, vals in _row_pairs(rows):
            n += 1
            if len(cols) == 0:
                continue
            bins = np.searchsorted(self.edges, np.asarray(vals, np.float64))
            for c, b, v in zip(np.asarray(cols).tolist(), bins.tolist(),
                               np.asarray(vals, np.float64).tolist()):
                h = hists.get(c)
                if h is None:
                    h = hists[c] = np.zeros((nbins,), np.int64)
                h[b] += 1
                mass[c] = mass.get(c, 0.0) + v
        return hists, mass, n

    def set_reference(self, rows: Iterable) -> int:
        """Freeze the reference distribution; returns its row count."""
        self._ref, self._ref_mass, self._ref_n = self._hists(rows)
        return self._ref_n

    @staticmethod
    def _dist(hist: np.ndarray | None, n: int, nbins: int) -> np.ndarray:
        """Column histogram → smoothed distribution over [zero cell,
        value bins...]; a column with no histogram is all-zero-cell."""
        full = np.zeros((nbins + 1,), np.float64)
        occ = 0
        if hist is not None:
            full[1:] = hist
            occ = int(hist.sum())
        full[0] = max(n - occ, 0)
        eps = 0.5
        return (full + eps) / (n + eps * len(full))

    def compare(self, rows: Iterable) -> DriftScore:
        if not self.ready:
            raise RuntimeError("drift reference not set")
        live, live_mass, n = self._hists(rows)
        if n == 0:
            return DriftScore(0.0, 0.0, 0.0, 0, 0)
        nbins = len(self.edges) + 1
        ref_total = sum(self._ref_mass.values()) or 1.0
        live_total = sum(live_mass.values()) or 1.0
        psi_sum = w_sum = 0.0
        psi_max = ks_max = 0.0
        over = 0
        columns = set(self._ref) | set(live)
        for c in columns:
            p = self._dist(self._ref.get(c), self._ref_n, nbins)
            q = self._dist(live.get(c), n, nbins)
            psi = float(np.sum((q - p) * np.log(q / p)))
            ks = float(np.max(np.abs(np.cumsum(p - q))))
            # weight by the column's share of total traffic mass, averaged
            # across both windows, so hot call paths dominate the verdict
            # and a one-count path cannot flag the plane
            w = 0.5 * (self._ref_mass.get(c, 0.0) / ref_total
                       + live_mass.get(c, 0.0) / live_total)
            psi_sum += w * psi
            w_sum += w
            psi_max = max(psi_max, psi)
            ks_max = max(ks_max, ks)
            if psi >= self.column_threshold:
                over += 1
        return DriftScore(
            psi=psi_sum / w_sum if w_sum > 0 else 0.0,
            psi_max=psi_max, ks_max=ks_max, columns_over=over,
            columns=len(columns))


class CalibrationMonitor:
    """Rolling q-band coverage + pinball loss per metric.

    One record per sweep — ``(covered[E], total, pinball_sum[E], n)`` —
    retained over a bounded deque so the aggregates are an exact
    finite-window sum: recomputing coverage/pinball from the same raw
    (prediction, observation) windows reproduces the monitor's numbers.
    """

    def __init__(self, num_metrics: int, window_sweeps: int):
        self.num_metrics = int(num_metrics)
        self._records: deque = deque(maxlen=int(window_sweeps))

    def update(self, covered: np.ndarray, total: int,
               pinball_sum: np.ndarray, n: int) -> None:
        self._records.append((
            np.asarray(covered, np.int64).copy(), int(total),
            np.asarray(pinball_sum, np.float64).copy(), int(n)))

    def reset(self) -> None:
        self._records.clear()

    @property
    def sweeps(self) -> int:
        return len(self._records)

    def coverage(self) -> np.ndarray | None:
        """[E] rolling empirical band coverage (None before any sweep)."""
        if not self._records:
            return None
        covered = sum(r[0] for r in self._records)
        total = sum(r[1] for r in self._records)
        return covered / max(total, 1)

    def pinball(self) -> np.ndarray | None:
        """[E] rolling mean pinball loss (None before any sweep)."""
        if not self._records:
            return None
        s = sum(r[2] for r in self._records)
        n = sum(r[3] for r in self._records)
        return s / max(n, 1)


class WindowBackend:
    """The stream-side serving surface for quality sweeps: exactly the
    slice of the Predictor protocol AnomalyDetector consumes, over an
    ``apply_fn(params, x)`` whose params enter as ARGUMENTS, so the
    DriftController re-uses one apply across every refresh's fresh params.
    ``x`` is a numpy ``[1, W, F]`` f32 window; the apply returns
    ``[1, W, E, Q]`` (a torch tensor on any device, or numpy).  In the port
    the apply is :func:`model_apply`: the trainer's own ``QuantileGRU``
    forward, no grad, on the live parameter tensors (K1 on a GPU).

    Only single-window series (``len(traffic) == window_size``) are
    supported: the sweep window is sized to the model window, which keeps
    this backend one apply call with no rolling-carry machinery; the
    de-normalization mirrors ``rolled_prediction_reference`` for a single
    window (clamp at 1e-6, invert with metrics last).
    """

    def __init__(self, apply_fn, params, x_stats, y_stats,
                 metric_names: list[str], quantiles: tuple[float, ...],
                 window_size: int, delta_mask: np.ndarray | None = None,
                 feature_dim: int | None = None):
        self._apply = apply_fn
        self.params = params
        self.x_stats = x_stats
        self.y_stats = y_stats
        self.metric_names = list(metric_names)
        self.quantiles = tuple(quantiles)
        self.window_size = int(window_size)
        self.delta_mask = (np.asarray(delta_mask, bool)
                           if delta_mask is not None else None)
        self.feature_dim = (int(feature_dim) if feature_dim is not None
                            else int(np.asarray(
                                x_stats.min).reshape(-1).shape[-1]))

    def median_index(self) -> int:
        return int(np.argmin(np.abs(np.asarray(self.quantiles) - 0.5)))

    def predict_series(self, traffic: np.ndarray,
                       integrate: bool = True) -> np.ndarray:
        traffic = np.asarray(traffic, np.float32)
        if len(traffic) != self.window_size:
            raise ValueError(
                f"WindowBackend serves exactly one window "
                f"(len {len(traffic)} != window_size {self.window_size})")
        x = self.x_stats.apply(traffic[None]).astype(np.float32)
        out = self._apply(self.params, x)
        if hasattr(out, "detach"):
            out = out.detach().float().cpu().numpy()
        preds = np.asarray(out)[0]                              # [W, E, Q]
        preds = np.maximum(preds, 1e-6)
        preds = self.y_stats.invert(
            preds.transpose(0, 2, 1)).transpose(0, 2, 1)
        if integrate and self.delta_mask is not None \
                and self.delta_mask.any():
            preds = np.array(preds, copy=True)
            preds[:, self.delta_mask, :] = np.cumsum(
                preds[:, self.delta_mask, :], axis=0)
        return preds.astype(np.float32)


def model_apply(model, recurrence=None):
    """The ``apply_fn(params, x)`` of a :class:`WindowBackend` over a
    ``QuantileGRU``: the deterministic forward with no autograd, reading
    ``params`` (the live tensors of a train state; nothing is copied) on
    the module's device.  ``recurrence`` replaces the device dispatch of
    the GRU recurrence, as in ``Trainer``."""
    import torch

    def apply(params, x):
        device = next(iter(params.values())).device
        with torch.no_grad():
            return model(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                         params=params, recurrence=recurrence)

    return apply


class QualityMonitor:
    """The composed online monitor + verdict surface.

    ``observe`` is the per-bucket hot path — O(nnz) deque appends under
    the lock, nothing else — safe to call from the ingest thread while
    HTTP handler threads read :meth:`verdicts`.  ``sweep`` runs the
    monitors (one or two model dispatches on the trailing window) and
    advances every hysteresis machine; callers own the cadence
    (DriftController on the train plane, VerdictIngestor on the serving
    plane).  All mutable state is lock-guarded; device work and
    metric publication happen OUTSIDE the lock.
    """

    def __init__(self, metric_names: list[str],
                 config: QualityConfig | None = None,
                 registry: obs_metrics.MetricsRegistry | None = None):
        self.config = cfg = config or QualityConfig(enabled=True)
        self.metric_names = list(metric_names)
        self._lock = threading.Lock()
        # trailing (sparse traffic row, observed [E] row) pairs; sized so
        # the drift live window AND the model sweep window both fit
        self._rows: deque = deque(maxlen=max(cfg.live_window, 512))
        self._name_pos = {n: i for i, n in enumerate(self.metric_names)}
        self.drift = FeatureDriftMonitor(
            column_threshold=cfg.drift_enter)
        self.calibration = CalibrationMonitor(
            len(self.metric_names), cfg.calibration_sweeps)
        self._drift_machine = HysteresisVerdict(
            cfg.drift_enter, cfg.drift_exit,
            cfg.sustain_enter, cfg.sustain_exit)
        self._calib_machines = [
            HysteresisVerdict(cfg.calibration_enter, cfg.calibration_exit,
                              cfg.sustain_enter, cfg.sustain_exit)
            for _ in self.metric_names]
        self._anomaly_machines = [
            HysteresisVerdict(cfg.anomaly_enter, cfg.anomaly_exit,
                              cfg.sustain_enter, cfg.sustain_exit)
            for _ in self.metric_names]
        self._sweeps = 0
        self._observed_buckets = 0
        self._last_drift: DriftScore | None = None
        # Model-conditioned verdicts (calibration + anomaly) armed:
        # True by default (the serving plane's checkpoint is trusted by
        # definition of serving it); the DriftController disarms during
        # the stream's cold-start warmup — an undertrained band's
        # one-sided excess is indistinguishable from a real anomaly,
        # so those machines read 0 until
        # the model has matured through model_warmup_refreshes.
        self._model_armed = True
        # verdict-transition event log (bucket index, stream, state):
        # detection latency is read off it
        self.events: list[tuple[int, str, str]] = []
        reg = registry or obs_metrics.REGISTRY
        self._m_sweeps = reg.expose(obs_metrics.Counter(
            "deeprest_quality_sweeps_total",
            "quality-monitor sweeps performed"))
        self._m_drift = reg.expose(obs_metrics.Gauge(
            "deeprest_feature_drift_psi",
            "traffic-mass-weighted PSI, live window vs training reference"))
        self._m_drift_max = reg.expose(obs_metrics.Gauge(
            "deeprest_feature_drift_psi_max",
            "worst single call-path column PSI"))
        self._m_ks = reg.expose(obs_metrics.Gauge(
            "deeprest_feature_drift_ks_max",
            "worst single call-path column KS distance"))
        self._m_cols_over = reg.expose(obs_metrics.Gauge(
            "deeprest_feature_drift_columns_over",
            "call-path columns whose own PSI crosses the enter threshold"))
        self._m_coverage = reg.expose(obs_metrics.Gauge(
            "deeprest_quality_band_coverage",
            "rolling empirical q-band coverage per metric",
            labelnames=("metric",)))
        self._m_pinball = reg.expose(obs_metrics.Gauge(
            "deeprest_quality_pinball_loss",
            "rolling mean pinball loss per metric",
            labelnames=("metric",)))
        self._m_anomaly = reg.expose(obs_metrics.Gauge(
            "deeprest_quality_anomaly_score",
            "mean normalized excess above the traffic-justified band",
            labelnames=("metric",)))
        self._m_verdict = reg.expose(obs_metrics.Gauge(
            "deeprest_quality_verdict",
            "verdict state per metric (0 ok, 1 drift, 2 anomaly)",
            labelnames=("metric",)))

    # -- ingest (per bucket, O(nnz)) ------------------------------------

    def observe(self, cols: np.ndarray, vals: np.ndarray,
                metrics_row: dict[str, float] | np.ndarray) -> None:
        """One bucket: sparse traffic row + its observed metric values."""
        if isinstance(metrics_row, dict):
            y = np.zeros((len(self.metric_names),), np.float32)
            for k, v in metrics_row.items():
                i = self._name_pos.get(k)
                if i is not None:
                    y[i] = v
        else:
            y = np.asarray(metrics_row, np.float32).copy()
        row = (np.asarray(cols, np.int32).copy(),
               np.asarray(vals, np.float32).copy())
        with self._lock:
            self._rows.append((row, y))
            self._observed_buckets += 1

    def observe_dense(self, traffic_row: np.ndarray,
                      metrics_row: dict[str, float] | np.ndarray) -> None:
        """Dense-row twin of :meth:`observe` (sparsifies by reading the
        caller's existing row — no F-wide allocation)."""
        (cols, vals), = _row_pairs([traffic_row])
        self.observe(cols, vals, metrics_row)

    @property
    def observed_buckets(self) -> int:
        with self._lock:
            return self._observed_buckets

    # -- reference management -------------------------------------------

    def set_reference(self, rows: Iterable) -> int:
        """Anchor the drift reference (the distribution the served params
        were trained on: retained rings after a refresh, or the trailing
        live window after a serving-plane reload)."""
        with self._lock:
            n = self.drift.set_reference(rows)
        return n

    def rebase_reference(self) -> int:
        """Re-anchor the reference to the trailing ``live_window`` rows
        (the serving plane's post-reload move: the fresh params were
        trained on recent data, so recent data IS the new no-drift
        baseline)."""
        with self._lock:
            rows = [r for r, _ in
                    list(self._rows)[-self.config.live_window:]]
            n = self.drift.set_reference(rows)
        return n

    def reset_calibration(self) -> None:
        """Fresh model ⇒ fresh calibration record (post-retrain)."""
        with self._lock:
            self.calibration.reset()
            for m in self._calib_machines:
                m.reset()

    def set_model_armed(self, armed: bool) -> None:
        """Gate the model-conditioned verdict machines (see the
        ``_model_armed`` comment in ``__init__``).  Scores keep
        publishing to /metrics either way — only the verdict machines
        read zero while disarmed."""
        with self._lock:
            self._model_armed = bool(armed)

    @property
    def model_armed(self) -> bool:
        with self._lock:
            return self._model_armed

    def on_model_refresh(self) -> None:
        """The params just changed (retrain or rolling reload): restart
        every model-CONDITIONED verdict stream — calibration windows and
        the anomaly machines — so recovery is measured against the fresh
        band, not averaged into the stale model's tail.  A real
        traffic-decoupled consumer (ransomware) re-enters within
        ``sustain_enter`` sweeps because its excess survives the fresh
        model; drift-era false excess does not.  The feature-drift
        machine is NOT reset — its reference re-anchor drives the exit
        through the ordinary hysteresis path."""
        with self._lock:
            self.calibration.reset()
            for m in self._calib_machines:
                m.reset()
            for m in self._anomaly_machines:
                m.reset()

    @property
    def armed(self) -> bool:
        with self._lock:
            return (self.drift.ready
                    and len(self._rows) >= self.config.min_sweep_buckets)

    # -- the sweep -------------------------------------------------------

    def sweep(self, backend) -> dict:
        """One monitor pass over the trailing window: drift score, band
        calibration, and the continuous not-justified-by-traffic check,
        each feeding its hysteresis machine.  ``backend`` is any object
        exposing the AnomalyDetector slice of the serving protocol
        (Predictor, ReplicaRouter, WindowBackend)."""
        cfg = self.config
        with self._lock:
            if not self.drift.ready:
                return {"armed": False, "reason": "no drift reference"}
            rows = list(self._rows)
        w = int(backend.window_size)
        if len(rows) < max(w, cfg.min_sweep_buckets):
            return {"armed": False, "reason":
                    f"{len(rows)} buckets < sweep window"}
        with obs_spans.RECORDER.span("quality.sweep",
                                     component="deeprest-quality") as sp:
            out = self._sweep_inner(backend, rows, w, cfg)
            sp.tag(psi=round(out["feature_drift"]["psi"], 4),
                   states=out["states"])
        return out

    def _sweep_inner(self, backend, rows, w: int,
                     cfg: QualityConfig) -> dict:
        from deeprest_tpu_torch.ops.densify import densify_rows
        from deeprest_tpu_torch.serve.anomaly import AnomalyDetector

        # drift: live trailing window vs the frozen reference (pure
        # histogram work — COO in, no dense F anywhere).  The machine
        # only advances once BOTH windows are full-width: scenario mixes
        # legitimately churn within a traffic cycle, so comparing a
        # partial window against a partial reference reads cycle phase
        # as drift.
        live = [r for r, _ in rows[-cfg.live_window:]]
        drift = self.drift.compare(live)
        drift_ready = (self.drift.reference_rows >= cfg.live_window
                       and len(live) >= cfg.live_window)

        # model-facing window: the trailing W buckets, densified ONCE
        # through ops/densify (this module never allocates [.., F] itself)
        tail = rows[-w:]
        kmax = max(max((len(c) for (c, _), _ in tail), default=1), 1)
        cols = np.zeros((w, kmax), np.int32)
        vals = np.zeros((w, kmax), np.float32)
        for i, ((c, v), _) in enumerate(tail):
            cols[i, :len(c)] = c
            vals[i, :len(c)] = v
        capacity = getattr(backend, "feature_dim", None)
        if capacity is None:
            capacity = int(np.asarray(
                backend.x_stats.min).reshape(-1).shape[-1])
        traffic = densify_rows(cols, vals, int(capacity))
        observed = np.stack([y for _, y in tail])

        detector = AnomalyDetector(backend, tolerance=cfg.anomaly_tolerance,
                                   min_run=cfg.anomaly_min_run)
        bands = detector.aligned(traffic, observed)
        reports = detector.reports(bands)

        # calibration: empirical coverage of the [min-q, max-q] band +
        # pinball loss, in the detector's aligned comparison space
        # (increments for delta metrics, re-anchored levels) against the
        # monotone-rearranged band — valid quantiles by construction.
        # Coverage admits the same tolerance margin the anomaly check
        # uses, over the detector's scale additionally floored at the
        # per-metric train range: a zero-inflated store metric whose
        # observations are exact zeros against a slightly-positive band
        # must not read as 100% undercoverage forever (it is within
        # noise of the band at the metric's own train scale).
        qs = np.asarray(sorted(backend.quantiles), np.float64)
        preds = bands.preds                                   # [T, E, Q]
        obs_adj = bands.observed                              # [T, E]
        scale = bands.scale
        y_stats = getattr(backend, "y_stats", None)
        if y_stats is not None:
            scale = np.maximum(
                scale,
                np.asarray(y_stats.range, np.float32).reshape(-1))
        margin = cfg.anomaly_tolerance * scale
        covered = ((obs_adj >= preds[..., 0] - margin)
                   & (obs_adj <= preds[..., -1] + margin)).sum(axis=0)
        err = obs_adj[..., None] - preds                      # [T, E, Q]
        pin = np.maximum((qs - 1.0) * err, qs * err).sum(axis=-1)
        pinball_sum = pin.sum(axis=0, dtype=np.float64)
        nominal = float(qs[-1] - qs[0])

        with self._lock:
            self.calibration.update(covered, len(tail), pinball_sum,
                                    len(tail))
            coverage = self.calibration.coverage()
            pinball = self.calibration.pinball()
            under = np.maximum(nominal - coverage, 0.0)
            self._drift_machine.update(drift.psi if drift_ready else 0.0)
            bucket = self._observed_buckets
            armed = self._model_armed
            for e, rep in enumerate(reports):
                self._anomaly_machines[e].update(
                    rep.score if armed else 0.0)
                self._calib_machines[e].update(
                    float(under[e]) if armed else 0.0)
            self._sweeps += 1
            self._last_drift = drift
            out = self._verdicts_locked()
            out["coverage_nominal"] = nominal
            self._log_transitions_locked(bucket)
        self._publish(drift, coverage, pinball, reports, out)
        return out

    def _log_transitions_locked(self, bucket: int) -> list:
        """Append newly-entered/exited states to the event log — one
        ``(bucket_index, stream, state)`` row per transition, the record
        detection latency is read off (caller holds the lock)."""
        fresh = []
        streams = [("feature_drift",
                    VERDICT_DRIFT if self._drift_machine.active
                    else VERDICT_OK)]
        streams += [(name, self._metric_state_locked(e))
                    for e, name in enumerate(self.metric_names)]
        for stream, now in streams:
            last = next((st for _, s, st in reversed(self.events)
                         if s == stream), VERDICT_OK)
            if now != last:
                ev = (bucket, stream, now)
                self.events.append(ev)
                fresh.append(ev)
        return fresh

    def _metric_state_locked(self, e: int) -> str:
        # Feature drift takes PRECEDENCE over anomaly: "utilization not
        # justified by traffic" is only a trustworthy verdict while the
        # traffic itself is in-reference — a stale model serving a
        # drifted distribution produces excess that is the MODEL's
        # fault, not the application's.  The loop disambiguates
        # temporally: drift triggers a retrain, the reference re-anchors,
        # and whatever excess SURVIVES the fresh model is real anomaly
        # (the ransomware-mid-drift scenario exercises exactly this
        # sequence).
        if self._drift_machine.active:
            return VERDICT_DRIFT
        if self._anomaly_machines[e].active:
            return VERDICT_ANOMALY
        if self._calib_machines[e].active:
            return VERDICT_DRIFT
        return VERDICT_OK

    def _verdicts_locked(self) -> dict:
        coverage = self.calibration.coverage()
        pinball = self.calibration.pinball()
        metrics = {}
        counts = {VERDICT_OK: 0, VERDICT_DRIFT: 0, VERDICT_ANOMALY: 0}
        for e, name in enumerate(self.metric_names):
            state = self._metric_state_locked(e)
            counts[state] += 1
            metrics[name] = {
                "state": state,
                "anomaly_score": round(self._anomaly_machines[e].score, 6),
                "undercoverage": round(self._calib_machines[e].score, 6),
                "coverage": (round(float(coverage[e]), 4)
                             if coverage is not None else None),
                "pinball": (round(float(pinball[e]), 6)
                            if pinball is not None else None),
            }
        d = self._last_drift
        return {
            "armed": True,
            "model_armed": self._model_armed,
            "sweeps": self._sweeps,
            "observed_buckets": self._observed_buckets,
            "feature_drift": {
                "state": (VERDICT_DRIFT if self._drift_machine.active
                          else VERDICT_OK),
                "psi": round(self._drift_machine.score, 6),
                "psi_max": round(d.psi_max, 6) if d else None,
                "ks_max": round(d.ks_max, 6) if d else None,
                "columns_over": d.columns_over if d else None,
                "columns": d.columns if d else None,
            },
            "metrics": metrics,
            "states": counts,
        }

    def _publish(self, drift: DriftScore, coverage, pinball,
                 reports, verdicts: dict) -> None:
        """Prometheus publication (outside the lock; metric objects carry
        their own locks)."""
        self._m_sweeps.inc()
        self._m_drift.set(drift.psi)
        self._m_drift_max.set(drift.psi_max)
        self._m_ks.set(drift.ks_max)
        self._m_cols_over.set(drift.columns_over)
        for e, name in enumerate(self.metric_names):
            if coverage is not None:
                self._m_coverage.set(float(coverage[e]), metric=name)
            if pinball is not None:
                self._m_pinball.set(float(pinball[e]), metric=name)
            self._m_anomaly.set(float(reports[e].score), metric=name)
            self._m_verdict.set(
                _STATE_CODE[verdicts["metrics"][name]["state"]],
                metric=name)

    # -- the surface -----------------------------------------------------

    def verdicts(self) -> dict:
        """The ``GET /v1/verdict`` payload (thread-safe snapshot)."""
        with self._lock:
            if self._sweeps == 0:
                return {
                    "armed": self.drift.ready,
                    "sweeps": 0,
                    "observed_buckets": self._observed_buckets,
                    "feature_drift": {"state": VERDICT_OK, "psi": 0.0},
                    "metrics": {n: {"state": VERDICT_OK}
                                for n in self.metric_names},
                    "states": {VERDICT_OK: len(self.metric_names),
                               VERDICT_DRIFT: 0, VERDICT_ANOMALY: 0},
                }
            return self._verdicts_locked()

    def any_active(self, kind: str | None = None) -> bool:
        """True when any stream is in ``drift``/``anomaly`` (or only the
        given kind) — the DriftController's decision read.  Mirrors the
        verdict precedence: anomaly machines only count while the
        feature-drift machine is quiet (see ``_metric_state_locked``)."""
        with self._lock:
            drift = (self._drift_machine.active
                     or any(m.active for m in self._calib_machines))
            anomaly = (not self._drift_machine.active
                       and any(m.active for m in self._anomaly_machines))
        if kind == VERDICT_ANOMALY:
            return anomaly
        if kind == VERDICT_DRIFT:
            return drift
        return anomaly or drift


__all__ = [
    "CalibrationMonitor", "DriftScore", "FeatureDriftMonitor",
    "HysteresisVerdict", "QualityMonitor", "WindowBackend", "model_apply",
    "VERDICT_OK", "VERDICT_DRIFT", "VERDICT_ANOMALY",
]
