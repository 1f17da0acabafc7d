"""The inference engine: checkpointed model → utilization predictions
(``deeprest_tpu/serve/predictor.py``; ``quant="off"``, no mesh).

Everything a consumer needs — params, model config, normalization
statistics, metric names — is restored from one checkpoint directory, so
serving cannot drift from training state.  On CUDA both serving programs,
the shape ladder's model apply and the fused engine's page program, run
as captured CUDA graphs, one per rung (serve/graphs.py); :meth:`warm`
captures them all up front.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.models.qrnn import QuantileGRU
from deeprest_tpu_torch.ops.gru import Recurrence
from deeprest_tpu_torch.serve.batcher import BatchedBackendMixin
from deeprest_tpu_torch.serve.fused import FusedInferenceMixin
from deeprest_tpu_torch.serve.graphs import PinnedStaging, RungGraphs


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
    serve through the plain version on a CUDA device).  ``cuda_graphs``
    False runs both serving programs eagerly on CUDA, the engine the
    captured graphs are held against.  ``coalesce_groups`` adds the
    ladder's super-rungs (serve/batcher.py).
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
                 coalesce_groups: int = 1,
                 device=None,
                 recurrence: Recurrence | None = None,
                 cuda_graphs: bool = True):
        self.device = resolve_device(device)
        self.recurrence = recurrence
        self.model = QuantileGRU(model_config, device=self.device)
        self.model.load_params(params)
        self._params_digest: str | None = None
        self.graphs = RungGraphs(self.device, enabled=cuda_graphs)
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
        self._init_batching(self._apply_numpy, ladder=ladder,
                            coalesce_groups=coalesce_groups)
        self._apply_staging = PinnedStaging(self.device, {"x": (
            (self.ladder.max_rung, self.window_size, self.feature_dim),
            torch.float32)})
        self._init_fused(self._apply, enabled=fused,
                         page_windows=page_windows,
                         coalesce_pages=coalesce_pages)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(x, recurrence=self.recurrence)

    def _apply_numpy(self, x: np.ndarray) -> torch.Tensor:
        """One ladder rung, ``[r, W, F]`` normalized windows, through the
        rung's program: staged in a pinned slot, returned as the caller's
        own device tensor (a clone of the graph's static output on
        CUDA)."""
        r = len(x)
        with self.graphs.lock, torch.inference_mode():
            slot = self._apply_staging.take()
            slot["x"][:r].numpy()[...] = x
            (y,) = self.graphs.run(("apply", r), self._apply,
                                   (slot["x"][:r],), staged=slot)
            return y.clone() if self.graphs.captured else y

    def warm(self) -> dict:
        """Run every rung of both serving programs once (each ladder rung's
        apply; each fused rung per ``integrate`` program in use): on CUDA
        every graph is captured here, and a capture after this counts in
        ``captures_after_warmup``.  Returns the graphs' stats."""
        w, f = self.window_size, self.feature_dim
        for rung in self.ladder.ladder:
            self._apply_numpy(np.zeros((rung, w, f), np.float32))
        if self._fused is not None:
            self._fused.warm(f)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.graphs.mark_warm()
        return self.graphs.stats()

    def params_digest(self) -> str:
        """Stable fingerprint of the served params — the ``params_hash``
        half of the capacity-surface cache key (serve/surface.py): sha1
        over the stored leaves in the JAX package's flatten order (sorted
        names) and stored dtypes, so it equals the JAX ``Predictor``'s on
        the same checkpoint.  Computed once per predictor (one readback of
        every leaf) and cached."""
        if self._params_digest is None:
            h = hashlib.sha1()
            params = self.model.params()
            for name in sorted(params):
                raw = params[name].detach().reshape(-1).view(torch.uint8)
                h.update(raw.cpu().numpy().tobytes())
            self._params_digest = h.hexdigest()[:16]
        return self._params_digest

    def jit_cache_size(self) -> int | None:
        """Captured CUDA graphs across both serving programs (the ladder's
        apply and the fused pipeline): the port's count behind the JAX
        name, the compiled-executable count of its jit caches.  On the CPU,
        where nothing is captured, the (program, rung) keys dispatched."""
        return self.graphs.size()

    def jit_cache_stats(self) -> dict:
        """Per-program graph counts (keys dispatched on the CPU), the rung
        sets bounding them, and the capture ledger."""
        g = self.graphs.stats()
        return {
            "apply": self.graphs.size("apply"),
            "apply_sparse": None,
            "fused": (self.graphs.size("fused")
                      if self._fused is not None else None),
            "ladder_rungs": len(self.ladder.ladder),
            "fused_rungs": (len(self._fused.rungs)
                            if self._fused is not None else 0),
            "quant": "off",
            "captures": g["captures"], "replays": g["replays"],
            "captures_after_warmup": g["captures_after_warmup"],
        }

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
                        coalesce_groups: int = 1,
                        device=None,
                        recurrence: Recurrence | None = None,
                        cuda_graphs: bool = True) -> "Predictor":
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
            coalesce_pages=coalesce_pages, coalesce_groups=coalesce_groups,
            device=device, recurrence=recurrence, cuda_graphs=cuda_graphs)
