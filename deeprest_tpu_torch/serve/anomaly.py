"""Application sanity checking: utilization not justified by traffic
(``deeprest_tpu/serve/anomaly.py``, whole).

The second DeepRest use case (reference: README.md:5): compare *observed*
per-component utilization against the model's traffic-conditioned
prediction interval; sustained usage above the upper quantile means some
consumer other than the API traffic is at work (cryptojacking CPU burners,
ransomware-style IO).  The reference demonstrates this experimentally
(crypto locust scenario + pow.py) but ships no detector; this module is
that missing piece."""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprest_tpu_torch.serve.predictor import Predictor


@dataclasses.dataclass
class AlignedBands:
    """The detector's aligned comparison space — everything downstream of
    the model call and upstream of the excess/flag logic.  The streaming
    quality monitor (obs/quality.py) reads band coverage and pinball loss
    off the same arrays, so its verdicts and the batch CLI's agree by
    construction."""

    preds: np.ndarray          # [T, E, Q] monotone-rearranged, re-anchored
    observed: np.ndarray       # [T, E] adjusted (delta metrics differenced)
    upper: np.ndarray          # [T, E] the band's upper envelope
    scale: np.ndarray          # [T, E] the floored normalization scale


@dataclasses.dataclass
class AnomalyReport:
    metric: str
    score: float               # mean normalized excess above the upper band
    flagged: bool
    first_flag_index: int | None   # start of the first sustained excess run
    excess: np.ndarray         # [T] per-step normalized excess

    def __repr__(self) -> str:  # compact, log-friendly
        state = "ANOMALOUS" if self.flagged else "ok"
        return (f"AnomalyReport({self.metric}: {state}, score={self.score:.4f}, "
                f"first_flag={self.first_flag_index})")


class AnomalyDetector:
    """Flags sustained utilization above the traffic-justified upper band."""

    def __init__(self, predictor: Predictor, tolerance: float = 0.10,
                 min_run: int = 5,
                 reanchor_resources: tuple[str, ...] = ("usage", "memory")):
        """tolerance: fractional headroom over the upper quantile before a
        step counts as excess; min_run: consecutive excess steps required to
        flag (rules out single-scrape spikes); reanchor_resources: level-type
        resources whose absolute value depends on history the traffic can't
        see (cumulative disk usage, resident memory) — their prediction bands
        are shifted to start at the first observed value, the reference
        demo's re-anchoring trick (web-demo/dataloader.py:143-156).

        Tolerance direction is explicit: the threshold is always
        ``upper + tolerance * scale`` with ``scale > 0``, i.e. headroom
        strictly ABOVE the band.  For re-anchored metrics the band can go
        negative (a small first observation anchors predictions below
        zero); there ``scale`` is floored at the per-metric train-split
        level range, so "tolerance" keeps meaning a fraction of a
        NORMAL-sized level — matching the increment-space floor delta
        metrics already get — instead of shrinking toward zero (and
        tightening the threshold) as the band crosses zero.  Behavior
        change vs the earlier ``|upper|``-only scale: near-zero or
        negative re-anchored bands now get a wider, stable margin."""
        self.predictor = predictor
        self.tolerance = tolerance
        self.min_run = min_run
        self.reanchor_resources = reanchor_resources

    def check(self, traffic: np.ndarray,
              observed: np.ndarray) -> list[AnomalyReport]:
        """``aligned`` + ``reports`` in one call (the batch CLI path;
        the streaming monitor calls the halves separately so calibration
        can read the same aligned bands without a second model pass)."""
        return self.reports(self.aligned(traffic, observed))

    def aligned(self, traffic: np.ndarray,
                observed: np.ndarray) -> AlignedBands:
        """traffic: [T, F] feature series; observed: [T, E] de-normalized
        utilization aligned with ``predictor.metric_names``.

        Delta-trained metrics (``predictor.delta_mask``) are checked in
        INCREMENT space: the observed series is differenced and compared
        against the model's raw per-bucket increment band — abnormal
        write RATE is the ransomware signal, and a level comparison would
        dilute it with rollout drift accumulated over the whole series.

        ``integrate=False`` rides the fused engine (serve/fused.py): the
        same paged model calls serve both the integrated and
        increment-space requests, and its raw-increment output equals the
        host reference loop's (tests/test_torch_predictor.py).
        """
        dm = getattr(self.predictor, "delta_mask", None)
        preds = self.predictor.predict_series(
            traffic, integrate=False)                       # [T, E, Q]
        # Monotone quantile rearrangement (Chernozhukov/Fernández-Val/
        # Galichon): sort the quantile axis so the band edge is the upper
        # ENVELOPE of the predicted quantiles.  The heads are trained
        # independently under pinball loss and can cross — an undertrained
        # upper head can sit at the normalized clamp floor, BELOW the
        # median — and ``preds[..., -1]`` then reads the band's floor as
        # its ceiling: every ordinary observation becomes "excess" and the
        # detector false-flags from the first buckets (the flag_at=7
        # incident; tests/test_serve.py pins flag_at inside the injected
        # anomaly window).  Rearrangement restores valid, non-crossing
        # quantiles without touching the wire predictions.
        preds = np.sort(np.asarray(preds, np.float32), axis=-1)
        # after value-sorting, quantile level i lives at its RANK among
        # the configured levels (identity for the ascending default)
        qs = list(self.predictor.quantiles)
        med = sorted(range(len(qs)), key=lambda i: qs[i]).index(
            self.predictor.median_index())
        observed = np.array(observed, np.float32, copy=True)
        reanchored: list[int] = []
        for e, metric in enumerate(self.predictor.metric_names):
            if dm is not None and dm[e]:
                # increment space: diff the observation; first bucket has
                # no predecessor → zero increment (never flags).
                observed[1:, e] = np.diff(observed[:, e])
                observed[0, e] = 0.0
                continue
            resource = metric.rsplit("_", 1)[-1]
            if resource in self.reanchor_resources:
                preds[:, e, :] += observed[0, e] - preds[0, e, med]
                reanchored.append(e)
        upper = preds[..., -1]                               # highest quantile
        scale = np.maximum(np.abs(upper), 1e-6)
        if reanchored:
            # Re-anchored bands can dip to/below zero, where an |upper|
            # scale degenerates (any noise reads as huge normalized excess
            # and the tolerance margin tightens toward nothing).  Floor at
            # the per-metric train-split level range — model-anchored, so
            # an attacker cannot inflate it — with the same degenerate-
            # range fallback the delta branch uses.
            rng_all = np.asarray(self.predictor.y_stats.range,
                                 np.float32).reshape(-1)
            floor = rng_all[reanchored]
            fallback = float(np.max(floor)) if np.max(floor) > 0 else 1.0
            floor = np.where(floor > 0, floor, fallback)
            scale[:, reanchored] = np.maximum(scale[:, reanchored], floor)
        if dm is not None and dm.any():
            # A quiet store's predicted increment band sits near zero,
            # making a MULTIPLICATIVE tolerance meaningless (any scrape
            # noise reads as huge normalized excess).  Floor the scale of
            # increment-space metrics at the train split's increment
            # range — model-anchored (an attacker cannot inflate it), and
            # "tolerance" then means a fraction of a NORMAL-sized
            # increment, matching its meaning for level metrics.
            rng_e = np.asarray(self.predictor.y_stats.range,
                               np.float32).reshape(-1)
            # A train-split-idle store has a degenerate (zero) increment
            # range — fall back to the largest increment range across
            # delta metrics so a few benign bytes of first-ever activity
            # don't read as ransomware (the 1e-6 scale would make any
            # noise an enormous normalized excess).
            floor = rng_e[dm]
            fallback = float(np.max(floor)) if np.max(floor) > 0 else 1.0
            floor = np.where(floor > 0, floor, fallback)
            scale[:, dm] = np.maximum(scale[:, dm], floor)
        return AlignedBands(preds=preds, observed=observed, upper=upper,
                            scale=scale)

    def reports(self, bands: AlignedBands) -> list[AnomalyReport]:
        """The excess/flag half over an aligned comparison space."""
        observed, upper, scale = bands.observed, bands.upper, bands.scale
        excess = np.maximum(observed - upper - self.tolerance * scale,
                            0.0) / scale

        reports = []
        for e, metric in enumerate(self.predictor.metric_names):
            ex = excess[:, e]
            run, first, longest = 0, None, 0
            for t, v in enumerate(ex):
                run = run + 1 if v > 0 else 0
                longest = max(longest, run)
                if run >= self.min_run and first is None:
                    first = t - self.min_run + 1
            reports.append(AnomalyReport(
                metric=metric,
                # graftlint: disable=JX003 -- host data: `excess` was materialized to numpy before this loop; no device sync here
                score=float(ex.mean()),
                flagged=longest >= self.min_run,
                first_flag_index=first,
                excess=ex,
            ))
        return reports
