"""Evaluation metrics and throughput accounting
(``deeprest_tpu/train/metrics.py``).

The MAE percentile report of the reference's console evaluation: absolute
errors of the de-normalized median-quantile prediction, pooled over all
evaluated windows, at median/95th/99th/max per metric and method.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping

import numpy as np
import torch


def mae_report(
    errors_by_method: Mapping[str, np.ndarray],
    metric_names: list[str],
) -> dict[str, dict[str, dict[str, float]]]:
    """method name → ``[num_windows, W, E]`` absolute errors ⇒
    ``{metric: {method: {median, p95, p99, max}}}``."""
    report: dict[str, dict[str, dict[str, float]]] = {}
    for idx, name in enumerate(metric_names):
        report[name] = {}
        for method, errs in errors_by_method.items():
            pooled = np.asarray(errs)[:, :, idx].ravel()
            report[name][method] = {
                "median": float(np.median(pooled)),
                "p95": float(np.percentile(pooled, 95)),
                "p99": float(np.percentile(pooled, 99)),
                "max": float(np.max(pooled)),
            }
    return report


def format_report(report: Mapping[str, Mapping[str, Mapping[str, float]]]) -> str:
    """Render the reference-style eval block."""
    lines = []
    for metric, methods in report.items():
        lines.append(f"===== {metric} =====")
        for method, stats in methods.items():
            lines.append(
                f"   {method.upper():6s}=> Median: {stats['median']:.4f} | "
                f"95-th: {stats['p95']:.4f} | 99-th: {stats['p99']:.4f} | "
                f"Max: {stats['max']:.4f}"
            )
    return "\n".join(lines)


@dataclasses.dataclass
class Throughput:
    """Steps/sec meter.  ``stop()`` waits for ``device`` (a
    ``torch.cuda.synchronize()`` on a CUDA device) before it reads the
    clock, so the window covers the device work the steps queued."""

    device: torch.device | None = None
    steps: int = 0
    _t0: float | None = None
    elapsed: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, steps: int) -> None:
        if self._t0 is None:
            raise RuntimeError("Throughput.stop() without start()")
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # graftlint: disable=OB001 -- this meter is the trainer's step-time source, read by its JSON report; it publishes no obs counters yet
        self.elapsed += time.perf_counter() - self._t0
        self.steps += steps
        self._t0 = None

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed > 0 else 0.0
