"""Dataset preparation: featurized corpus → normalized train/test windows
(``deeprest_tpu/train/data.py``, dense path).

Host numpy, bit-identical to the JAX package: sliding windows over the
traffic and the stacked resource series, a leading-fraction train split,
global min-max on the traffic and per-metric min-max on the targets, with
the scales kept as :class:`MinMaxStats`.  Level-type resources are trained
as per-bucket increments and integrated back for evaluation.  The sparse
(padded-COO) fields of the JAX bundle are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from deeprest_tpu_torch.config import TrainConfig
from deeprest_tpu_torch.data.featurize import FeaturizedData
from deeprest_tpu_torch.data.windows import (
    MinMaxStats, minmax_fit, sliding_windows,
)


def delta_mask(metric_names: Sequence[str],
               resources: Sequence[str]) -> np.ndarray:
    """Boolean [E] mask of metrics (named ``component_resource``) whose
    resource is trained in increment space."""
    res = set(resources)
    return np.asarray(
        [name.rsplit("_", 1)[-1] in res for name in metric_names], bool)


def to_increments(targets: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """[T, E] levels → per-bucket increments for the masked columns:
    ``d[t] = y[t] − y[t−1]`` with ``d[0] = 0``; other columns unchanged."""
    if not mask.any():
        return targets
    out = np.array(targets, np.float32, copy=True)
    out[1:, mask] = targets[1:, mask] - targets[:-1, mask]
    out[0, mask] = 0.0
    return out


def integrate_level_columns(preds: np.ndarray, mask: np.ndarray,
                            anchors: np.ndarray | None = None) -> np.ndarray:
    """Integrate the masked increment columns of ``[..., W, E]``
    de-normalized predictions back to levels along the window axis; with
    ``anchors`` (``[..., 1, E]`` levels) each window starts at its
    anchor."""
    if not mask.any():
        return preds
    out = np.array(preds, copy=True)
    c = np.cumsum(out[..., mask], axis=-2)
    if anchors is not None:
        c += anchors[..., mask] - c[..., :1, :]
    out[..., mask] = c
    return out


@dataclasses.dataclass
class DatasetBundle:
    """Normalized windows plus everything needed to de-normalize and
    compare (the dense fields of the JAX bundle)."""

    x_train: np.ndarray        # [N_train, W, F] normalized traffic windows
    y_train: np.ndarray        # [N_train, W, E] normalized targets
    x_test: np.ndarray         # [N_test, W, F]
    y_test: np.ndarray         # [N_test, W, E]
    x_stats: MinMaxStats
    y_stats: MinMaxStats       # per-metric (broadcast shape [1, E])
    metric_names: list[str]
    split: int                 # number of train windows
    window_size: int
    # the corpus's call-path vocabulary, for the checkpoint sidecar
    space_dict: dict | None = None
    # [E] bool: metrics whose normalized targets are per-bucket increments
    delta_mask: np.ndarray | None = None
    # raw LEVEL series [T, E], for level-space evaluation of delta columns
    raw_targets: np.ndarray | None = None
    # normalized BASE series [T, F] / [T, E]; the windows are views of them
    # and the trainer stages them on its device
    x_base: np.ndarray | None = None
    y_base: np.ndarray | None = None

    @property
    def num_metrics(self) -> int:
        return len(self.metric_names)

    @property
    def num_train_windows(self) -> int:
        return len(self.x_train)

    @property
    def num_test_windows(self) -> int:
        return len(self.x_test)

    @property
    def feature_dim(self) -> int:
        return self.x_train.shape[-1]

    def denorm_targets(self, y: np.ndarray) -> np.ndarray:
        return self.y_stats.invert(y)

    def _has_delta(self) -> bool:
        return (self.delta_mask is not None and self.delta_mask.any()
                and self.raw_targets is not None)

    def _level_windows(self, idx: np.ndarray) -> np.ndarray:
        """Raw level windows aligned with ``x_test[idx]``."""
        return sliding_windows(
            self.raw_targets, self.window_size)[self.split + np.asarray(idx)]

    def level_labels(self, idx: np.ndarray) -> np.ndarray:
        """De-normalized test labels with delta columns swapped for the
        raw LEVEL windows."""
        labels = self.denorm_targets(np.asarray(self.y_test[idx]))
        if self._has_delta():
            lvl = self._level_windows(idx)
            labels[..., self.delta_mask] = lvl[..., self.delta_mask]
        return labels

    def integrate_test_preds(self, preds_denorm: np.ndarray,
                             idx: np.ndarray) -> np.ndarray:
        """Integrate delta columns of de-normalized test predictions from
        each window's first observed level."""
        if not self._has_delta():
            return preds_denorm
        return integrate_level_columns(
            preds_denorm, self.delta_mask,
            anchors=self._level_windows(idx)[:, :1])


def prepare_dataset(data: FeaturizedData, config: TrainConfig) -> DatasetBundle:
    """Window, split, and normalize a featurized corpus.

    Normalization runs on the base ``[T, F]`` / ``[T, E]`` series and the
    windows are strided views of the normalized series; min/max over the
    train windows equals min/max over their union ``base[:split + w - 1]``.
    Level-type resources (``config.delta_resources``) become per-bucket
    increments before normalization.
    """
    w = config.window_size
    traffic = data.traffic                        # [T, F]
    raw_targets = data.targets()                  # [T, E] level space
    mask = delta_mask(data.metric_names, config.delta_resources)
    targets = to_increments(raw_targets, mask)
    n_windows = len(traffic) - w
    if n_windows <= 0:
        raise ValueError(
            f"series of length {len(traffic)} too short for window_size={w}")
    split = int(n_windows * config.train_split)
    if split < 1 or split >= n_windows:
        raise ValueError(
            f"train_split={config.train_split} gives {split} train windows "
            f"of {n_windows} total; corpus too short for window_size={w}"
        )

    base_span = split + w - 1   # union of the train windows' rows
    x_stats = minmax_fit(traffic, base_span)                   # global
    # [T, 1, E] view so the stats keep the [1, E] broadcast shape
    y_stats = minmax_fit(targets[:, None, :], base_span, axis=(0, 1))
    x_n = x_stats.apply(traffic).astype(np.float32)            # [T, F] copy
    y_n = y_stats.apply(targets).astype(np.float32)
    x = sliding_windows(x_n, w)                   # [N, W, F] view
    y = sliding_windows(y_n, w)                   # [N, W, E] view
    return DatasetBundle(
        x_train=x[:split],
        y_train=y[:split],
        x_test=x[split:],
        y_test=y[split:],
        x_stats=x_stats,
        y_stats=y_stats,
        metric_names=list(data.metric_names),
        split=split,
        window_size=w,
        space_dict=data.space_dict,
        delta_mask=mask,
        raw_targets=raw_targets,
        x_base=x_n,
        y_base=y_n,
    )


def eval_window_indices(num_test: int, stride: int, max_cycles: int) -> np.ndarray:
    """Non-overlapping test windows: every ``stride``-th, capped at
    ``max_cycles``."""
    idx = np.arange(0, num_test, stride)
    return idx[:max_cycles]
