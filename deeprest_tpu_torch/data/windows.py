"""Sliding windows and min-max normalization state
(``deeprest_tpu/data/windows.py``).

Host-side numpy, as in the JAX package: training windows and normalizes,
and serving inverts predictions, with exactly these operations, so the
port's host paths match the JAX package's bit for bit on the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def sliding_windows(ts: np.ndarray, window_size: int) -> np.ndarray:
    """``[T, ...]`` → ``[T - window_size, window_size, ...]`` overlapping
    windows, a zero-copy strided view (read-only for callers).  The last
    start offset ``T - window_size`` is excluded, as in the reference."""
    n = len(ts) - window_size
    if n <= 0:
        raise ValueError(
            f"series of length {len(ts)} too short for window_size={window_size}"
        )
    view = np.lib.stride_tricks.sliding_window_view(ts, window_size, axis=0)
    # the window axis comes last; move it after the time axis
    return np.moveaxis(view, -1, 1)[:n]


@dataclasses.dataclass
class MinMaxStats:
    """``x_norm = (x - min) / (max - min)``; a degenerate range (max ==
    min) passes values through unchanged."""

    min: np.ndarray
    max: np.ndarray

    @property
    def range(self) -> np.ndarray:
        return self.max - self.min

    @property
    def _safe_range(self) -> np.ndarray:
        r = self.range
        return np.where(r == 0.0, 1.0, r)

    def apply(self, x: np.ndarray) -> np.ndarray:
        return np.where(self.range == 0.0, x, (x - self.min) / self._safe_range)

    def invert(self, x: np.ndarray) -> np.ndarray:
        return np.where(self.range == 0.0, x, x * self.range + self.min)

    def to_dict(self) -> dict:
        return {"min": np.asarray(self.min).tolist(),
                "max": np.asarray(self.max).tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "MinMaxStats":
        return cls(min=np.asarray(d["min"], dtype=np.float32),
                   max=np.asarray(d["max"], dtype=np.float32))


def minmax_fit(x: np.ndarray, split: int,
               axis: Sequence[int] | None = None) -> MinMaxStats:
    """Fit stats on ``x[:split]``: over everything with ``axis=None`` (the
    traffic), else over ``axis``, which must include the leading axis, with
    that axis dropped from the stats (per-metric target scales)."""
    train = x[:split]
    if axis is None:
        mn = np.asarray(np.min(train), dtype=np.float32)
        mx = np.asarray(np.max(train), dtype=np.float32)
    else:
        axis = tuple(axis)
        if 0 not in axis:
            raise ValueError(
                f"axis={axis} must include the leading (time/window) axis 0; "
                "stats are fit over the train split"
            )
        mn = np.min(train, axis=axis, keepdims=True).astype(np.float32)
        mx = np.max(train, axis=axis, keepdims=True).astype(np.float32)
        mn, mx = mn[0], mx[0]
    return MinMaxStats(min=mn, max=mx)


def minmax_apply(x: np.ndarray, stats: MinMaxStats) -> np.ndarray:
    return stats.apply(x)


def minmax_invert(x: np.ndarray, stats: MinMaxStats) -> np.ndarray:
    return stats.invert(x)
