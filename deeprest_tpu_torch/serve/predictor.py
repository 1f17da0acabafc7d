"""The inference engine: checkpointed model → utilization predictions
(``deeprest_tpu/serve/predictor.py``; ``quant="off"``, no mesh).

Everything a consumer needs — params, model config, normalization
statistics, metric names — is restored from one checkpoint directory, so
serving cannot drift from training state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.models.qrnn import QuantileGRU
from deeprest_tpu_torch.ops.gru import Recurrence
from deeprest_tpu_torch.serve.batcher import BatchedBackendMixin
from deeprest_tpu_torch.serve.fused import FusedInferenceMixin


def rolled_prediction_reference(
        apply_fn, x_stats: MinMaxStats, y_stats: MinMaxStats,
        window_size: int, traffic: np.ndarray,
        max_batch: int = 64,
        delta_mask: np.ndarray | None = None,
        median_index: int | None = None) -> np.ndarray:
    """``[T, F]`` raw traffic → de-normalized ``[T, E, Q]`` predictions: the
    host-loop specification the fused engine is held to.

    The series is tiled into non-overlapping windows, the last one
    right-aligned so every step is covered exactly once.  Windows are
    stacked and normalized in numpy and go through ``apply_fn`` (normalized
    ``[n, W, F]`` → ``[n, W, E, Q]``) in batches of at most ``max_batch``;
    results are clamped at 1e-6 and de-normalized on the host.  Columns of
    ``delta_mask`` are per-bucket increments: each window's cumulative sum,
    chained across windows on the median quantile from a base of 0.
    """
    w = window_size
    t = len(traffic)
    if t < w:
        raise ValueError(f"series length {t} < window_size {w}")
    if delta_mask is not None and delta_mask.any() and median_index is None:
        raise ValueError("delta_mask requires median_index for the "
                         "cross-window carry")
    starts = list(range(0, t - w + 1, w))
    if starts[-1] != t - w:
        starts.append(t - w)

    out = None
    for lo in range(0, len(starts), max_batch):
        chunk = starts[lo:lo + max_batch]
        x = np.stack([traffic[s:s + w] for s in chunk]).astype(np.float32)
        x = x_stats.apply(x).astype(np.float32)
        # graftlint: disable=JX003 -- designed sink: the host-loop reference reads every batch back by definition; the fused engine is the production path
        preds = np.asarray(apply_fn(x))                           # [n,W,E,Q]
        preds = y_stats.invert(
            np.maximum(preds, 1e-6).transpose(0, 1, 3, 2)
        ).transpose(0, 1, 3, 2)
        if out is None:
            out = np.empty((t, preds.shape[2], preds.shape[3]), np.float32)
        for s, window in zip(chunk, preds):
            if delta_mask is not None and delta_mask.any():
                # graftlint: disable=JX003 -- host data: `window` is a numpy slice of the batch already read back
                window = np.array(window, copy=True)
                c = np.cumsum(window[:, delta_mask, :], axis=0)
                # carry: the median level already written one step before
                # this window (0 at the very first step of the series)
                base = (out[s - 1, delta_mask, median_index][None, :, None]
                        if s > 0 else 0.0)
                window[:, delta_mask, :] = base + c
            out[s:s + w] = window      # later (right-aligned) window wins
    return out


class Predictor(BatchedBackendMixin, FusedInferenceMixin):
    """Quantile predictions for traffic feature series, on ``device``
    (None means ``"cuda"``, which raises without a GPU).

    ``recurrence`` replaces the device dispatch of the GRU recurrence, as
    the Trainer's does (pass ``ops.cuda_gru.gru_recurrence_reference`` to
    serve through the plain version on a CUDA device).
    """

    def __init__(self, params, model_config: ModelConfig,
                 x_stats: MinMaxStats, y_stats: MinMaxStats,
                 metric_names: list[str], window_size: int,
                 space_dict: dict | None = None,
                 delta_mask: np.ndarray | None = None,
                 ladder: tuple[int, ...] | None = None,
                 fused: bool = True,
                 page_windows: int | None = None,
                 coalesce_pages: int | None = None,
                 device=None,
                 recurrence: Recurrence | None = None):
        self.device = resolve_device(device)
        self.recurrence = recurrence
        self.model = QuantileGRU(model_config, device=self.device)
        self.model.load_params(params)
        self.x_stats = x_stats
        self.y_stats = y_stats
        self.metric_names = list(metric_names)
        self.window_size = int(window_size)
        # serialized CallPathSpace of the training corpus, for the CLI's
        # vocabulary-identity guard
        self.space_dict = space_dict
        # [E] bool: metrics predicted as per-bucket increments
        self.delta_mask = (np.asarray(delta_mask, bool)
                           if delta_mask is not None else None)
        self._init_batching(self._apply_numpy, ladder=ladder)
        self._init_fused(self._apply, enabled=fused,
                         page_windows=page_windows,
                         coalesce_pages=coalesce_pages)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(x, recurrence=self.recurrence)

    def _apply_numpy(self, x: np.ndarray) -> torch.Tensor:
        return self._apply(torch.from_numpy(x).to(self.device))

    @property
    def model_config(self) -> ModelConfig:
        return self.model.config

    @property
    def quantiles(self) -> tuple[float, ...]:
        return self.model.config.quantiles

    @property
    def feature_dim(self) -> int:
        return self.model.config.feature_dim

    def median_index(self) -> int:
        return self.model.median_index()

    def space(self):
        """The training corpus's CallPathSpace (column-exact featurization
        for raw serve-time traces); None for checkpoints without one."""
        if self.space_dict is None:
            return None
        from deeprest_tpu_torch.data.featurize import CallPathSpace

        return CallPathSpace.from_dict(self.space_dict)

    @classmethod
    def from_checkpoint(cls, directory: str, step: int | None = None,
                        ladder: tuple[int, ...] | None = None,
                        fused: bool = True,
                        page_windows: int | None = None,
                        coalesce_pages: int | None = None,
                        device=None,
                        recurrence: Recurrence | None = None
                        ) -> "Predictor":
        """Restore params and host state from a ``deeprest-sharded-v1``
        checkpoint; the architecture comes from the sidecar's
        ``model_config`` with ``feature_dim`` and ``num_metrics`` taken from
        the sidecar's data fields, as the JAX trainer sets them."""
        from deeprest_tpu_torch.train.checkpoint import (
            latest_step, load_params, load_sidecar,
        )

        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {directory!r}")
        extra = load_sidecar(directory, step)
        if "model_config" not in extra:
            raise ValueError(f"checkpoint {directory!r} predates sidecar "
                             "model configs; the port cannot serve it")
        mc = dict(extra["model_config"])
        mc["quantiles"] = tuple(mc.get("quantiles", ()))
        metric_names = extra["metric_names"]
        model_config = dataclasses.replace(
            ModelConfig(**mc), feature_dim=extra["feature_dim"],
            num_metrics=len(metric_names))
        return cls(
            params=load_params(directory, step),
            model_config=model_config,
            x_stats=MinMaxStats.from_dict(extra["x_stats"]),
            y_stats=MinMaxStats.from_dict(extra["y_stats"]),
            metric_names=metric_names,
            window_size=extra["window_size"],
            space_dict=extra.get("space"),
            delta_mask=extra.get("delta_mask"),
            ladder=ladder, fused=fused, page_windows=page_windows,
            coalesce_pages=coalesce_pages, device=device,
            recurrence=recurrence)
