"""The inference engine: checkpointed model → utilization predictions
(``deeprest_tpu/serve/predictor.py``; no mesh).

Everything a consumer needs — params, model config, normalization
statistics, metric names — is restored from one checkpoint directory, so
serving cannot drift from training state.  On CUDA every serving program,
the shape ladder's model apply and the fused engine's page program (and
their padded-COO twins under ``sparse_feed``), runs as captured CUDA
graphs, one per rung (serve/graphs.py); :meth:`RungServing.warm` captures
them all up front.

Quantized serving (``quant="int8"|"bf16"``, ``ops/quantize.py``): the
weight leaves are stored narrow and dequantized at use inside each rung's
program (``models.qrnn.resolve_params``), so no f32 copy sits beside them.
The per-(metric, quantile) parity envelope against the f32 reference is
measured on the seeded probe batch at load and stored next to the
checkpoint as ``quant_parity_<mode>.json``; every later load re-measures
it and raises ``QuantParityError`` on a violated budget, whichever package
wrote the file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.models.qrnn import QuantileGRU, resolve_params
from deeprest_tpu_torch.ops import quantize as quant_ops
from deeprest_tpu_torch.ops.densify import densify_coo, normalize_minmax
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


class RungServing(BatchedBackendMixin, FusedInferenceMixin):
    """The serving machinery :class:`Predictor` and
    ``serve.export.ExportedPredictor`` share: the shape ladder (and its
    sparse twin), the fused engine, the rung graphs with their pinned
    staging, :meth:`warm` and the graph counts.  A subclass sets
    ``device``, ``quant``, the host state (``x_stats``, ``y_stats``,
    ``metric_names``, ``window_size``, ``space_dict``, ``delta_mask``),
    ``quantiles`` and ``feature_dim``, defines :meth:`_apply` (normalized
    ``[n, W, F]`` on the device → ``[n, W, E, Q]`` f32) and calls
    :meth:`_init_serving`."""

    def _init_serving(self, ladder, coalesce_groups: int, fused: bool,
                      page_windows: int | None, coalesce_pages: int | None,
                      sparse_feed: bool, sparse_nnz_cap: int,
                      cuda_graphs: bool) -> None:
        self.graphs = RungGraphs(self.device, enabled=cuda_graphs)
        self.sparse_feed = bool(sparse_feed)
        self.sparse_nnz_cap = int(sparse_nnz_cap)
        w, f, k = self.window_size, self.feature_dim, self.sparse_nnz_cap
        self._init_batching(
            self._apply_numpy, ladder=ladder, coalesce_groups=coalesce_groups,
            apply_sparse_fn=(self._apply_sparse_numpy if self.sparse_feed
                             else None))
        r = self.ladder.max_rung
        self._apply_staging = PinnedStaging(self.device, {
            "x": ((r, w, f), torch.float32)})
        self._sparse_staging = None
        if self.sparse_feed:
            self._sparse_staging = PinnedStaging(self.device, {
                "cols": ((r, w, k), torch.int32),
                "vals": ((r, w, k), torch.float32)})

            def staged(a):
                return torch.from_numpy(
                    np.asarray(a, np.float32).reshape(-1)).to(self.device)

            self._x_mn = staged(self.x_stats.min)
            self._x_rg = staged(self.x_stats.range)
        self._init_fused(self._apply, enabled=fused,
                         page_windows=page_windows,
                         coalesce_pages=coalesce_pages,
                         sparse_nnz_cap=k if self.sparse_feed else None)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _apply_sparse(self, cols: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
        """RAW padded-COO windows on the device → densified, normalized
        with the staged stats, through :meth:`_apply`."""
        x = densify_coo(cols, vals, self.feature_dim)
        return self._apply(normalize_minmax(x, self._x_mn, self._x_rg))

    def _run_rung(self, program: str, fn, staging: PinnedStaging,
                  arrays: dict) -> torch.Tensor:
        """One ladder rung through its program's graph: ``arrays`` staged
        in a pinned slot, the output returned as the caller's own device
        tensor (a clone of the graph's static output on CUDA)."""
        r = len(next(iter(arrays.values())))
        with self.graphs.lock, torch.inference_mode():
            slot = staging.take()
            for name, a in arrays.items():
                slot[name][:r].numpy()[...] = a
            (y,) = self.graphs.run((program, r), fn,
                                   tuple(slot[n][:r] for n in arrays),
                                   staged=slot)
            return y.clone() if self.graphs.captured else y

    def _apply_numpy(self, x: np.ndarray) -> torch.Tensor:
        """One ladder rung, ``[r, W, F]`` normalized windows."""
        return self._run_rung("apply", self._apply, self._apply_staging,
                              {"x": x})

    def _apply_sparse_numpy(self, cols: np.ndarray,
                            vals: np.ndarray) -> torch.Tensor:
        """One ladder rung of RAW padded-COO windows ``[r, W, K]``."""
        return self._run_rung("sparse_apply", self._apply_sparse,
                              self._sparse_staging,
                              {"cols": cols, "vals": vals})

    def warm(self) -> dict:
        """Run every rung of every serving program once (each ladder
        rung's apply, and its sparse apply under ``sparse_feed``; each
        fused rung per ``integrate`` program in use, sparse for a sparse
        backend): on CUDA every graph is captured here, and a capture after
        this counts in ``captures_after_warmup``.  Returns the graphs'
        stats."""
        w, f, k = self.window_size, self.feature_dim, self.sparse_nnz_cap
        for rung in self.ladder.ladder:
            self._apply_numpy(np.zeros((rung, w, f), np.float32))
            if self.sparse_feed:
                self._apply_sparse_numpy(np.zeros((rung, w, k), np.int32),
                                         np.zeros((rung, w, k), np.float32))
        if self._fused is not None:
            self._fused.warm(f)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
            # the eager first run of each capture left its working memory
            # cached outside the graphs' pool: hand it back to the card
            torch.cuda.empty_cache()
        self.graphs.mark_warm()
        return self.graphs.stats()

    def jit_cache_size(self) -> int | None:
        """Captured CUDA graphs across the serving programs: the port's
        count behind the JAX name, the compiled-executable count of its jit
        caches.  On the CPU, where nothing is captured, the (program, rung)
        keys dispatched."""
        return self.graphs.size()

    def jit_cache_stats(self) -> dict:
        """Per-program graph counts (keys dispatched on the CPU), the rung
        sets bounding them, the quant mode and the capture ledger."""
        g = self.graphs.stats()
        return {
            "apply": self.graphs.size("apply"),
            "apply_sparse": (self.graphs.size("sparse_apply")
                             if self.sparse_feed else None),
            "fused": (self.graphs.size("fused")
                      + self.graphs.size("sparse_fused")
                      if self._fused is not None else None),
            "ladder_rungs": len(self.ladder.ladder),
            "fused_rungs": (len(self._fused.rungs)
                            if self._fused is not None else 0),
            "quant": self.quant,
            "captures": g["captures"], "replays": g["replays"],
            "captures_after_warmup": g["captures_after_warmup"],
        }

    def median_index(self) -> int:
        """Index of the quantile nearest .50 in the output's last axis."""
        diffs = [abs(q - 0.5) for q in self.quantiles]
        return diffs.index(min(diffs))

    def space(self):
        """The training corpus's CallPathSpace (column-exact featurization
        for raw serve-time traces); None when there is none."""
        if self.space_dict is None:
            return None
        from deeprest_tpu_torch.data.featurize import CallPathSpace

        return CallPathSpace.from_dict(self.space_dict)


class Predictor(RungServing):
    """Quantile predictions for traffic feature series, on ``device``
    (None means ``"cuda"``, which raises without a GPU).

    ``recurrence`` replaces the device dispatch of the GRU recurrence, as
    the Trainer's does (pass ``ops.cuda_gru.gru_recurrence_reference`` to
    serve through the plain version on a CUDA device).  ``cuda_graphs``
    False runs the serving programs eagerly on CUDA, the engine the
    captured graphs are held against.  ``coalesce_groups`` adds the
    ladder's super-rungs (serve/batcher.py).  ``sparse_feed`` ships series
    as padded-COO pages of ``sparse_nnz_cap`` columns a row.  ``quant``
    ("off", "int8", "bf16") stores the weights narrow; ``quant_budget``
    (a stored envelope, ``{"budget": {...}}``) gates the measured parity.
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
                 sparse_feed: bool = False,
                 sparse_nnz_cap: int = 64,
                 quant: str = "off",
                 quant_budget: dict | None = None,
                 device=None,
                 recurrence: Recurrence | None = None,
                 cuda_graphs: bool = True):
        if quant not in quant_ops.QUANT_MODES:
            raise ValueError(
                f"quant mode {quant!r} not in {quant_ops.QUANT_MODES}")
        self.device = resolve_device(device)
        self.quant = quant
        self.recurrence = recurrence
        self._params_digest: str | None = None
        self._qparams = None
        ref_params = None
        if quant == "off":
            self.model = QuantileGRU(model_config, device=self.device)
            self.model.load_params(params)
        else:
            # The module on the meta device checks the names and shapes and
            # holds no weights; the narrow tree is what is served.
            self.model = QuantileGRU(model_config, device="meta")
            self.model.load_params(params)
            ref_params = {name: torch.as_tensor(v).to(self.device)
                          for name, v in params.items()}
            self._qparams = quant_ops.quantize_params(ref_params, quant)
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
        self._init_serving(ladder, coalesce_groups, fused, page_windows,
                           coalesce_pages, sparse_feed, sparse_nnz_cap,
                           cuda_graphs)
        self.parity_envelope = None
        if quant != "off":
            self.parity_envelope = self._measure_parity(ref_params,
                                                        quant_budget)

    @property
    def params(self) -> dict:
        """The served params: the module's f32 leaves, or the quantized
        tree (``QuantTensor`` or bf16 weight leaves)."""
        return self.model.params() if self._qparams is None \
            else self._qparams

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            params = (None if self._qparams is None
                      else resolve_params(self._qparams))
            return self.model(x, recurrence=self.recurrence, params=params)

    def _measure_parity(self, ref_params, budget: dict | None) -> dict:
        """The quantized apply against the f32 reference on the seeded
        probe batch (``ops/quantize.probe_batch``), reduced to the
        per-(metric, quantile) envelope; run eagerly, outside the rung
        graphs.  With a stored ``budget`` any violated cell raises."""
        probe = torch.from_numpy(quant_ops.probe_batch(
            self.window_size, self.feature_dim)).to(self.device)
        with torch.inference_mode():
            want = self.model(probe, recurrence=self.recurrence,
                              params=ref_params)
            got = self.model(probe, recurrence=self.recurrence,
                             params=resolve_params(self._qparams))
        measured = quant_ops.parity_envelope(
            want.cpu().numpy(), got.cpu().numpy(), self.metric_names,
            self.quantiles)
        envelope = {
            "mode": self.quant,
            "measured": measured,
            "budget": (dict(budget["budget"]) if budget is not None
                       else quant_ops.budget_from_measured(measured)),
        }
        if budget is not None:
            violations = quant_ops.check_envelope(measured,
                                                  envelope["budget"])
            if violations:
                raise quant_ops.QuantParityError(
                    f"quantized ({self.quant}) predictions exceed the "
                    "stored parity envelope: "
                    + "; ".join(violations[:8])
                    + (f" (+{len(violations) - 8} more)"
                       if len(violations) > 8 else ""))
        return envelope

    def params_digest(self) -> str:
        """Stable fingerprint of the served params — the ``params_hash``
        half of the capacity-surface cache key (serve/surface.py): sha1
        over the stored leaves in the JAX package's flatten order (sorted
        names; a ``QuantTensor``'s data, then its scale) and stored dtypes,
        after the quant mode when it is not "off", so it equals the JAX
        ``Predictor``'s on the same checkpoint and mode.  Computed once per
        predictor (one readback of every leaf) and cached."""
        if self._params_digest is None:
            h = hashlib.sha1()
            if self.quant != "off":
                h.update(self.quant.encode())
            params = self.params
            for name in sorted(params):
                leaf = params[name]
                for t in (leaf if isinstance(leaf, quant_ops.QuantTensor)
                          else (leaf,)):
                    raw = t.detach().reshape(-1).view(torch.uint8)
                    h.update(raw.cpu().numpy().tobytes())
            self._params_digest = h.hexdigest()[:16]
        return self._params_digest

    @property
    def model_config(self) -> ModelConfig:
        return self.model.config

    @property
    def quantiles(self) -> tuple[float, ...]:
        return self.model.config.quantiles

    @property
    def feature_dim(self) -> int:
        return self.model.config.feature_dim

    @staticmethod
    def _quant_envelope_path(directory: str, quant: str) -> str:
        return os.path.join(directory, f"quant_parity_{quant}.json")

    @classmethod
    def from_checkpoint(cls, directory: str, step: int | None = None,
                        ladder: tuple[int, ...] | None = None,
                        fused: bool = True,
                        page_windows: int | None = None,
                        coalesce_pages: int | None = None,
                        coalesce_groups: int = 1,
                        sparse_feed: bool = False,
                        sparse_nnz_cap: int = 64,
                        quant: str = "off",
                        device=None,
                        recurrence: Recurrence | None = None,
                        cuda_graphs: bool = True) -> "Predictor":
        """Restore params and host state from a ``deeprest-sharded-v1``
        checkpoint; the architecture comes from the sidecar's
        ``model_config`` with ``feature_dim`` and ``num_metrics`` taken from
        the sidecar's data fields, as the JAX trainer sets them.

        ``quant``: the first load at a mode measures the parity envelope
        and writes it next to the checkpoint (``quant_parity_<mode>.json``,
        the JAX package's file); every later load re-measures and is gated
        by the stored budget."""
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
        quant_budget = None
        env_path = cls._quant_envelope_path(directory, quant)
        if quant != "off" and os.path.exists(env_path):
            with open(env_path, encoding="utf-8") as fh:
                quant_budget = json.load(fh)
        predictor = cls(
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
            sparse_feed=sparse_feed, sparse_nnz_cap=sparse_nnz_cap,
            quant=quant, quant_budget=quant_budget,
            device=device, recurrence=recurrence, cuda_graphs=cuda_graphs)
        if quant != "off" and quant_budget is None:
            with open(env_path, "w", encoding="utf-8") as fh:
                json.dump({"step": step, **predictor.parity_envelope},
                          fh, indent=2, sort_keys=True)
        return predictor
