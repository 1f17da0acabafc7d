"""Dataset preparation: featurized corpus → normalized train/test windows
(``deeprest_tpu/train/data.py``, dense path).

Host numpy, bit-identical to the JAX package: sliding windows over the
traffic and the stacked resource series, a leading-fraction train split,
global min-max on the traffic and per-metric min-max on the targets, with
the scales kept as :class:`MinMaxStats`.  Level-type resources are trained
as per-bucket increments and integrated back for evaluation.  With
``TrainConfig.sparse_feed`` the bundle also carries the RAW traffic as
padded-COO rows (``x_cols``/``x_vals``/``x_nnz``), which the trainer
stages in place of the dense base.  The streaming trainer's retained
corpus lives in the host rings :class:`SeriesRing` and
:class:`SparseSeriesRing` (numpy, zero-copy views).
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


class SeriesRing:
    """Bounded row history as one preallocated, always-contiguous block.

    The streaming trainer's retained corpus was a ``deque[np.ndarray]``:
    every refresh re-stacked the whole history (O(history) Python-level
    copies) before it could window.  This ring keeps the newest ``maxlen``
    rows physically contiguous inside a ``[2·maxlen, width]`` buffer —
    ``view()`` is a zero-copy slice that ``sliding_windows`` strides over
    directly, so refresh-time assembly is O(1) and the per-append cost is
    amortized O(width) (one block memmove per ``maxlen`` appends when the
    write cursor hits the end).

    ``append_slot()`` exposes the next row for in-place writes
    (``extract(out=...)``) so the ingest path allocates nothing.  Rows
    handed out by ``view()``/iteration are views into the buffer: valid
    until ~maxlen further appends (the compaction memmove), so consumers
    that outlive the refresh they were built in must copy.
    """

    def __init__(self, maxlen: int, width: int, dtype=np.float32):
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self._buf = np.zeros((2 * maxlen, width), dtype)
        self._start = 0
        self._len = 0

    def __len__(self) -> int:
        return self._len

    @property
    def width(self) -> int:
        return self._buf.shape[1]

    def append_slot(self) -> np.ndarray:
        """Advance the ring by one row and return it for in-place writing.

        The returned row holds stale bytes — callers must fully overwrite
        it (``extract(out=...)`` does)."""
        if self._start + self._len == len(self._buf):
            # Cursor at the physical end: memmove the retained rows to the
            # front.  Here len == maxlen (eviction keeps len <= maxlen and
            # the buffer is 2*maxlen), so source and destination are the
            # disjoint halves.
            self._buf[:self._len] = self._buf[self._start:self._start + self._len]
            self._start = 0
        if self._len == self.maxlen:
            self._start += 1          # evict the oldest row
            self._len -= 1
        row = self._buf[self._start + self._len]
        self._len += 1
        return row

    def append(self, row: np.ndarray) -> None:
        self.append_slot()[:] = row

    def view(self) -> np.ndarray:
        """Zero-copy contiguous ``[len, width]`` of the retained history,
        oldest first.  Invalidated by later appends (see class docstring)."""
        return self._buf[self._start:self._start + self._len]

    def __iter__(self):
        return iter(self.view())

    def clear(self) -> None:
        self._start = 0
        self._len = 0


class SparseSeriesRing:
    """Bounded padded-COO row history: the sparse-first twin of
    :class:`SeriesRing` for the traffic half of the streaming corpus.

    Each retained row is ``(cols[K], vals[K], nnz)`` — the
    ``CallPathSpace.extract_sparse`` output padded to the fixed
    ``nnz_cap`` with ``(0, 0.0)`` entries — instead of a dense
    ``[capacity]`` float32 vector.  At F=10240, K=64 the resident bytes
    drop ~F/(2K) (int32 cols + float32 vals vs dense float32): a
    month-scale retained corpus goes from ~3.5 GB of ring to ~44 MB.

    Storage is three lock-stepped :class:`SeriesRing` buffers so the
    wrap/eviction/zero-copy-view semantics (and their tests) are shared,
    not re-implemented; ``view()`` returns the same oldest-first
    contiguous views, valid until ~maxlen further appends.

    A row with more than ``nnz_cap`` nonzero columns RAISES — the
    documented K-cap policy (silently dropping call paths would corrupt
    the count vector; size ``--sparse-nnz-cap`` to the corpus instead).
    """

    def __init__(self, maxlen: int, capacity: int, nnz_cap: int):
        if nnz_cap < 1:
            raise ValueError(f"nnz_cap must be >= 1, got {nnz_cap}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.nnz_cap = int(nnz_cap)
        self._cols = SeriesRing(maxlen, nnz_cap, np.int32)
        self._vals = SeriesRing(maxlen, nnz_cap, np.float32)
        self._nnz = SeriesRing(maxlen, 1, np.int32)

    def __len__(self) -> int:
        return len(self._cols)

    @property
    def maxlen(self) -> int:
        return self._cols.maxlen

    @property
    def nbytes(self) -> int:
        """Resident buffer bytes."""
        return (self._cols._buf.nbytes + self._vals._buf.nbytes
                + self._nnz._buf.nbytes)

    def append_sparse(self, cols: np.ndarray, vals: np.ndarray) -> None:
        """Append one ``(cols, vals)`` sparse row (unpadded, as
        ``extract_sparse`` returns it)."""
        n = len(cols)
        if n != len(vals):
            raise ValueError(f"cols/vals length mismatch: {n} vs {len(vals)}")
        if n > self.nnz_cap:
            raise ValueError(
                f"sparse traffic row has {n} nonzero columns, over the "
                f"nnz cap {self.nnz_cap}; raise --sparse-nnz-cap (or "
                f"disable --sparse-feed) — silently dropping call paths "
                f"would corrupt the count vector")
        cslot = self._cols.append_slot()
        cslot[:n] = cols
        cslot[n:] = 0
        vslot = self._vals.append_slot()
        vslot[:n] = vals
        vslot[n:] = 0.0
        self._nnz.append_slot()[0] = n

    def view(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Zero-copy ``(cols[T, K], vals[T, K], nnz[T])`` of the retained
        history, oldest first (SeriesRing.view validity contract)."""
        return self._cols.view(), self._vals.view(), self._nnz.view()[:, 0]

    def densify(self) -> np.ndarray:
        """Dense ``[T, capacity]`` reconstruction — the parity reference
        (bit-identical to a SeriesRing fed from ``extract``) and the
        escape hatch for dense-only consumers.  Materializes the full
        matrix: never call this on the 10k-wide hot path."""
        from deeprest_tpu_torch.ops.densify import densify_rows

        cols, vals, _ = self.view()
        return densify_rows(cols, vals, self.capacity)

    def clear(self) -> None:
        self._cols.clear()
        self._vals.clear()
        self._nnz.clear()


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
    compare.  Dense traffic windows may be None for a sparse-only bundle;
    ``n_train``/``n_test`` then carry the window counts."""

    x_train: np.ndarray | None  # [N_train, W, F] normalized traffic windows
    y_train: np.ndarray        # [N_train, W, E] normalized targets
    x_test: np.ndarray | None  # [N_test, W, F]
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
    # sparse feed: RAW traffic as padded-COO rows, the trainer's staged
    # alternative to x_base (densified and normalized on the device)
    x_cols: np.ndarray | None = None       # [T, K] int32
    x_vals: np.ndarray | None = None       # [T, K] float32 raw counts
    x_nnz: np.ndarray | None = None        # [T] int32 row lengths
    sparse_capacity: int | None = None     # dense width F of the COO rows
    n_train: int | None = None             # window counts, sparse bundles
    n_test: int | None = None

    @property
    def num_metrics(self) -> int:
        return len(self.metric_names)

    @property
    def is_sparse(self) -> bool:
        return self.x_cols is not None

    @property
    def num_train_windows(self) -> int:
        return self.n_train if self.n_train is not None else len(self.x_train)

    @property
    def num_test_windows(self) -> int:
        return self.n_test if self.n_test is not None else len(self.x_test)

    @property
    def feature_dim(self) -> int:
        if self.x_train is not None:
            return self.x_train.shape[-1]
        return int(self.sparse_capacity)

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

    # Sparse feed: the RAW traffic as padded-COO rows beside the dense
    # views; the trainer stages cols/vals instead of x_base.  A row over
    # the cap raises (ops/densify.sparsify_rows).
    x_cols = x_vals = x_nnz = None
    if getattr(config, "sparse_feed", False):
        from deeprest_tpu_torch.ops.densify import sparsify_rows

        x_cols, x_vals, x_nnz = sparsify_rows(traffic,
                                              config.sparse_nnz_cap)
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
        x_cols=x_cols,
        x_vals=x_vals,
        x_nnz=x_nnz,
        sparse_capacity=(traffic.shape[-1] if x_cols is not None else None),
    )


def eval_window_indices(num_test: int, stride: int, max_cycles: int) -> np.ndarray:
    """Non-overlapping test windows: every ``stride``-th, capped at
    ``max_cycles``."""
    idx = np.arange(0, num_test, stride)
    return idx[:max_cycles]
