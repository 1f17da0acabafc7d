"""What-if capacity estimation: hypothetical API traffic → utilization
(``deeprest_tpu/serve/whatif.py``, whole).

The headline DeepRest use case (reference: README.md:5, web-demo/): "how
much resource would each component need if traffic looked like X?" for X
with shapes/scales/compositions never observed.  Pipeline: per-endpoint
trace synthesis (data/synthesize.py) → feature series → quantile
predictions per component×resource.

Multi-scenario estimation (:meth:`WhatIfEstimator.estimate_many`, the
capacity sweep :meth:`WhatIfEstimator.sweep`, and
:meth:`WhatIfEstimator.scaling_factor`) batches S hypothetical traffic
programs through the predictor's fused device pipeline
(``predict_series_many``, serve/fused.py): all scenarios fold into the
scenario×window batch axis and page through the same fused rungs — S
scenarios cost ~⌈ΣS windows / page⌉ model calls (each launching the
recurrence kernel K1 on a GPU) instead of S sequential host-loop
prediction trains.
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict

import numpy as np

from deeprest_tpu_torch.data.synthesize import TraceSynthesizer
from deeprest_tpu_torch.serve.predictor import Predictor

# Per-estimator raw-prediction memo size.  Sized for the repeat pattern
# that actually occurs (the BASELINE program re-estimated by every
# scaling_factor/sweep call against the same snapshot), not as a general
# result cache: that is serve/surface.py's capacity surface.
_RAW_CACHE_MAX = 32


def _program_key(program: list[dict], seed: int) -> str:
    """Canonical memo key for one (traffic program, synthesis seed)."""
    return json.dumps(program, sort_keys=True,
                      separators=(",", ":")) + f"|{seed}"


class WhatIfEstimator:
    """Synthesizer + predictor, composed.

    Estimation is memoized per (traffic program, seed) in a small LRU:
    ``scaling_factor`` and ``sweep`` re-estimate the same BASELINE
    program on every call.  The memo lives on the estimator instance, so
    an estimator built over a freshly loaded predictor starts empty, and a
    memo entry can never outlive the params snapshot that produced it.
    """

    def __init__(self, predictor: Predictor, synthesizer: TraceSynthesizer):
        if synthesizer.space.capacity != predictor.feature_dim:
            raise ValueError(
                f"synthesizer capacity {synthesizer.space.capacity} != model "
                f"feature_dim {predictor.feature_dim}"
            )
        self.predictor = predictor
        self.synthesizer = synthesizer
        # raw [T, E, Q] results keyed by _program_key; entries are
        # write-locked numpy arrays shared across callers.  The lock
        # guards the OrderedDict + hit/miss counters only — synthesis and
        # prediction always run OUTSIDE it.
        self._raw_cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._raw_lock = threading.Lock()
        self.raw_cache_hits = 0
        self.raw_cache_misses = 0

    @property
    def endpoints(self) -> list[str]:
        return self.synthesizer.endpoints

    def _is_relative(self, e: int) -> bool:
        dm = self.predictor.delta_mask
        return dm is not None and bool(dm[e])

    def _bands(self, preds: np.ndarray) -> dict[str, dict[str, np.ndarray]]:
        """[T, E, Q] predictions → {metric: {"qNN": [T] series}}."""
        quantiles = self.predictor.quantiles
        return {
            metric: {
                f"q{int(q * 100):02d}": preds[:, e, qi]
                for qi, q in enumerate(quantiles)
            }
            for e, metric in enumerate(self.predictor.metric_names)
        }

    def estimate(
        self,
        expected_traffic: list[dict[str, int]],
        seed: int = 0,
    ) -> dict[str, dict[str, np.ndarray]]:
        """``expected_traffic[t] = {endpoint: count}`` → per-metric series.

        Returns ``{metric: {"q05"|"q50"|"q95": [T] utilization}}`` (keys
        follow the configured quantiles).  Delta-trained metrics
        (``predictor.delta_mask``, e.g. disk usage) come back as RELATIVE
        growth from the start of the hypothetical program — there is no
        observed level to anchor a what-if to; the reference demo
        re-anchors exactly these series before display
        (web-demo/dataloader.py:143-156).
        """
        return self.estimate_many([expected_traffic], seeds=[seed])[0]

    def estimate_many(
        self,
        traffic_programs: list[list[dict[str, int]]],
        seed: int = 0,
        seeds: list[int] | None = None,
    ) -> list[dict[str, dict[str, np.ndarray]]]:
        """Batched multi-scenario estimation: S traffic programs (of
        possibly different lengths) → S per-metric band dicts, one
        prediction train.

        All scenarios synthesize on host, then fold into the predictor's
        fused scenario×window batch axis (``predict_series_many``): the
        delta-integration carry resets per scenario, pages are shared
        across scenarios, and no new executables compile for any S.
        ``seeds`` pins each scenario's synthesis seed (defaults to
        ``seed + i`` — scenario i of a sweep is reproducible regardless
        of batch composition).
        """
        raws = self.estimate_many_raw(traffic_programs, seed=seed,
                                      seeds=seeds)
        return [self._bands(p) for p in raws]

    def estimate_many_raw(
        self,
        traffic_programs: list[list[dict[str, int]]],
        seed: int = 0,
        seeds: list[int] | None = None,
        cache: bool = True,
    ) -> list[np.ndarray]:
        """Like :meth:`estimate_many` but returns the raw ``[T, E, Q]``
        prediction arrays (read-only) instead of band dicts — the shape
        the capacity-surface plane stacks into interpolation grids.

        With ``cache=True`` (default), each (program, seed) result is
        memoized in a per-estimator LRU: repeated baselines across
        ``scaling_factor``/``sweep`` calls cost one prediction train
        total.  Only the MISSES synthesize and fold into the device
        batch; a fully-cached call does no dispatch at all.  Surface
        builds pass ``cache=False`` — their thousands of vertices are
        stored once in the surface itself and would only churn this LRU.
        """
        if seeds is None:
            seeds = [seed + i for i in range(len(traffic_programs))]
        if len(seeds) != len(traffic_programs):
            raise ValueError(
                f"{len(seeds)} seeds for {len(traffic_programs)} programs")
        n = len(traffic_programs)
        out: list[np.ndarray | None] = [None] * n
        miss_idx = list(range(n))
        keys: list[str] | None = None
        if cache:
            keys = [_program_key(p, s)
                    for p, s in zip(traffic_programs, seeds)]
            miss_idx = []
            with self._raw_lock:
                for i, k in enumerate(keys):
                    hit = self._raw_cache.get(k)
                    if hit is not None:
                        self._raw_cache.move_to_end(k)
                        self.raw_cache_hits += 1
                        out[i] = hit
                    else:
                        self.raw_cache_misses += 1
                        miss_idx.append(i)
        if miss_idx:
            series = [
                self.synthesizer.synthesize_series(
                    traffic_programs[i], seed=seeds[i])
                for i in miss_idx
            ]
            many = getattr(self.predictor, "predict_series_many", None)
            if many is not None:
                preds = many(series)
            else:
                preds = [self.predictor.predict_series(x) for x in series]
            for i, p in zip(miss_idx, preds):
                # graftlint: disable=JX003 -- designed sink: the memo stores host numpy; this is the one materialization point
                arr = np.asarray(p, dtype=np.float32)
                # shared across future cache hits: freeze so no caller
                # can corrupt another's result
                arr.setflags(write=False)
                out[i] = arr
            if cache:
                with self._raw_lock:
                    for i in miss_idx:
                        # concurrent misses of the same key both insert;
                        # values are deterministic, so last-wins is fine
                        self._raw_cache[keys[i]] = out[i]
                        self._raw_cache.move_to_end(keys[i])
                    while len(self._raw_cache) > _RAW_CACHE_MAX:
                        self._raw_cache.popitem(last=False)
        return out

    def sweep(
        self,
        base_traffic: list[dict[str, int]],
        factors: list[float],
        seed: int = 0,
    ) -> list[dict]:
        """Capacity-sweep grid: scale ``base_traffic`` by each factor and
        estimate all scaled programs in ONE batched prediction train.

        Returns one record per factor:
        ``{"factor": f, "peaks": {metric: {"qNN": peak}}}``
        where delta-trained (relative) metrics report peak GROWTH over the
        program (peak minus start — the demo's post-re-anchor semantics)
        and absolute metrics report the plain peak.
        """
        if not factors:
            raise ValueError("sweep requires at least one factor")
        programs = [
            [{ep: int(round(n * f)) for ep, n in step.items()}
             for step in base_traffic]
            for f in factors
        ]
        results = self.estimate_many(programs, seed=seed)
        out = []
        for f, bands in zip(factors, results):
            peaks: dict[str, dict[str, float]] = {}
            for e, metric in enumerate(self.predictor.metric_names):
                per_q = {}
                for q, series in bands[metric].items():
                    if self._is_relative(e):
                        # graftlint: disable=JX003 -- host data: estimate_many already materialized the bands to numpy
                        per_q[q] = max(float(np.max(series) - series[0]), 0.0)
                    else:
                        # graftlint: disable=JX003 -- host data: same materialized numpy bands
                        per_q[q] = float(np.max(series))
                peaks[metric] = per_q
            # graftlint: disable=JX003 -- host data: f is a python float from the factors argument
            out.append({"factor": float(f), "peaks": peaks})
        return out

    def scaling_factor(
        self,
        baseline_traffic: list[dict[str, int]],
        hypothetical_traffic: list[dict[str, int]],
        seed: int = 0,
    ) -> dict[str, float]:
        """Per-metric peak scaling factor between two traffic programs
        (the number the reference demo renders as bar charts,
        web-demo/dataloader.py:143-156).  For delta-trained level metrics
        the factor compares GROWTH over the program (peak minus start) —
        the reference demo's own post-re-anchor semantics; a peak ratio on
        a relative-from-zero rollout would be meaningless.

        Both programs fold into one batched prediction train through
        ``estimate_many`` (shared fused pages — this replaced the earlier
        two-thread MicroBatcher workaround), and the per-estimator memo
        means a repeated baseline (every demo interaction re-compares
        against "today's traffic") is estimated once per snapshot, not
        once per call.  Degenerate peaks follow one
        convention for BOTH metric kinds: zero baseline and zero
        hypothetical means "no change" (1.0); zero baseline with real
        hypothetical load is unbounded (inf) — previously absolute metrics
        leaked inf into bar charts even when both peaks were zero.
        """
        base, hypo = self.estimate_many(
            [baseline_traffic, hypothetical_traffic],
            seeds=[seed, seed + 1])
        factors = {}
        for e, metric in enumerate(self.predictor.metric_names):
            bs, hs = base[metric]["q50"], hypo[metric]["q50"]
            if self._is_relative(e):
                # Growth can legitimately be ~0 (a program driving no
                # writes): clamp at 0 and define 0-growth/0-growth as 1.0
                # (no change) instead of letting inf leak into bar charts.
                # graftlint: disable=JX003 -- host data: estimate_many already materialized q50 to numpy
                b = max(float(np.max(bs) - bs[0]), 0.0)
                # graftlint: disable=JX003 -- host data: same materialized numpy series
                h = max(float(np.max(hs) - hs[0]), 0.0)
                factors[metric] = (h / b if b > 0
                                   else (1.0 if h == 0 else float("inf")))
            else:
                # graftlint: disable=JX003 -- host data: estimate_many already materialized q50 to numpy
                b = float(np.max(bs))
                # graftlint: disable=JX003 -- host data: same materialized numpy series
                h = float(np.max(hs))
                factors[metric] = (h / b if b > 0
                                   else (1.0 if h <= 0 else float("inf")))
        return factors
