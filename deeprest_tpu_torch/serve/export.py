"""Portable inference artifact: checkpoint → a serialized ``torch.export``
program on disk (``deeprest_tpu/serve/export.py``; the JAX package writes
``jax.export`` StableHLO, the port a ``.pt2``).

The exported computation is the deterministic forward pass on normalized
windows ``[b, W, F] → [b, W, E, Q]`` with ``b`` a ``torch.export.Dim``,
the trained weights saved with it (a quantized predictor's weights
quantized, then dequantized, as the JAX package bakes them).  It is traced
on the CPU and placed on the serving device at load
(``torch.export.passes.move_to_device_pass``).  The recurrence is one node
per call, the registered operator ``deeprest_torch::gru_fwd``
(``ops/cuda_gru.py``), so the program launches K1 on a GPU: what a CPU
trace would otherwise bake in is the plain loop.  Everything else a
consumer needs rides in ``manifest.json``, with every key of the JAX
manifest plus ``bidir_fused`` and ``stash_gates``, the recurrence settings
the program was traced with.

Layout of an artifact directory::

    model.pt2       torch.export.save of the forward program (binary)
    manifest.json   stats + names + dims + model config  (JSON)

:class:`ExportedPredictor` serves an artifact through the same shape
ladder, fused engine and rung graphs as ``Predictor``.  An artifact of the
JAX package (``"format": "jax.export/stablehlo"``) is refused.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.data.windows import MinMaxStats
from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.models.qrnn import QuantileGRU, resolve_params
from deeprest_tpu_torch.serve.predictor import Predictor, RungServing

ARTIFACT_BLOB = "model.pt2"
ARTIFACT_MANIFEST = "manifest.json"
_FORMAT = "torch.export/pt2"
_PLATFORMS = ("cpu", "cuda")
GRU_OP = "deeprest_torch.gru_fwd.default"
MAX_BATCH = 1 << 16


def export_program(pred: Predictor) -> torch.export.ExportedProgram:
    """The forward of ``pred`` traced on the CPU with a dynamic batch
    dimension, its weights (resolved: dequantized for int8) saved with
    it."""
    params = {name: leaf.detach().cpu()
              for name, leaf in resolve_params(pred.params).items()}
    model = QuantileGRU(pred.model_config, device="cpu").load_params(params)
    example = torch.zeros((2, pred.window_size, pred.feature_dim),
                          dtype=torch.float32)
    batch = torch.export.Dim("b", min=1, max=MAX_BATCH)
    return torch.export.export(model, (example,),
                               dynamic_shapes=({"x": {0: batch}}),
                               strict=False)


def graph_ops(program: torch.export.ExportedProgram) -> list[str]:
    """The operator of every call in the program's graph, in order."""
    return [str(node.target) for node in program.graph.nodes
            if node.op == "call_function"]


def export_predictor(pred: Predictor, directory: str) -> str:
    """Serialize ``pred`` into ``directory`` (created if needed)."""
    import importlib

    from deeprest_tpu_torch.ops import cuda_gru

    gru = importlib.import_module("deeprest_tpu_torch.ops.gru")
    os.makedirs(directory, exist_ok=True)
    program = export_program(pred)
    torch.export.save(program, os.path.join(directory, ARTIFACT_BLOB))
    manifest = {
        "format": _FORMAT,
        "platforms": list(_PLATFORMS),
        "metric_names": pred.metric_names,
        "window_size": pred.window_size,
        "feature_dim": pred.feature_dim,
        "quantiles": list(pred.quantiles),
        "x_stats": pred.x_stats.to_dict(),
        "y_stats": pred.y_stats.to_dict(),
        "model_config": dataclasses.asdict(pred.model_config),
        "space": pred.space_dict,
        "delta_mask": (np.asarray(pred.delta_mask, bool).tolist()
                       if pred.delta_mask is not None else None),
        # the mode the saved weights were quantized at and its measured
        # envelope: a load at another mode raises
        "quant": getattr(pred, "quant", "off"),
        "quant_parity": getattr(pred, "parity_envelope", None),
        "bidir_fused": gru.BIDIR_FUSED,
        "stash_gates": cuda_gru.STASH_GATES,
    }
    with open(os.path.join(directory, ARTIFACT_MANIFEST), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return directory


class ExportedPredictor(RungServing):
    """A serving backend loaded from an artifact directory, with the
    serving protocol of ``Predictor`` (``predict_series[_many]``,
    ``metric_names``, ``window_size``, ``quantiles``, ``feature_dim``,
    ``median_index``, ``space``, ``apply_windows`` and MicroBatcher
    attachment, ``warm``): the program runs as each rung's model call, so
    on CUDA every rung is one captured graph, as in ``Predictor``."""

    def __init__(self, program: torch.export.ExportedProgram, manifest: dict,
                 ladder: tuple[int, ...] | None = None,
                 fused: bool = True,
                 page_windows: int | None = None,
                 coalesce_pages: int | None = None,
                 coalesce_groups: int = 1,
                 quant: str = "off",
                 device=None,
                 cuda_graphs: bool = True):
        _check_manifest(manifest, quant)
        from torch.export.passes import move_to_device_pass

        self.device = resolve_device(device)
        self.quant = str(manifest.get("quant", "off"))
        self.parity_envelope = manifest.get("quant_parity")
        self.manifest = manifest
        self.program = move_to_device_pass(program, self.device)
        self._module = self.program.module()
        self.metric_names: list[str] = list(manifest["metric_names"])
        self.window_size: int = int(manifest["window_size"])
        self.feature_dim: int = int(manifest["feature_dim"])
        self.quantiles: tuple[float, ...] = tuple(manifest["quantiles"])
        mc = dict(manifest["model_config"])
        mc["quantiles"] = tuple(mc.get("quantiles", ()))
        self.model_config = ModelConfig(**mc)
        self.x_stats = MinMaxStats.from_dict(manifest["x_stats"])
        self.y_stats = MinMaxStats.from_dict(manifest["y_stats"])
        self.space_dict = manifest.get("space")
        dm = manifest.get("delta_mask")
        self.delta_mask = np.asarray(dm, bool) if dm is not None else None
        self._init_serving(ladder, coalesce_groups, fused, page_windows,
                           coalesce_pages, False, 64, cuda_graphs)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._module(x)

    @classmethod
    def load(cls, directory: str,
             ladder: tuple[int, ...] | None = None,
             fused: bool = True,
             page_windows: int | None = None,
             coalesce_pages: int | None = None,
             coalesce_groups: int = 1,
             quant: str = "off",
             device=None,
             cuda_graphs: bool = True) -> "ExportedPredictor":
        with open(os.path.join(directory, ARTIFACT_MANIFEST),
                  encoding="utf-8") as f:
            manifest = json.load(f)
        _check_manifest(manifest, quant)
        program = torch.export.load(os.path.join(directory, ARTIFACT_BLOB))
        return cls(program, manifest, ladder=ladder, fused=fused,
                   page_windows=page_windows, coalesce_pages=coalesce_pages,
                   coalesce_groups=coalesce_groups, quant=quant,
                   device=device, cuda_graphs=cuda_graphs)


def _check_manifest(manifest: dict, quant: str) -> None:
    """Refuse an artifact of another format (the JAX package's StableHLO)
    and a quant mode other than the one the weights were saved at."""
    if manifest.get("format") != _FORMAT:
        raise ValueError(
            f"unknown artifact format {manifest.get('format')!r}: the port "
            f"serves {_FORMAT!r} artifacts (python -m deeprest_tpu_torch "
            "export)")
    baked = str(manifest.get("quant", "off"))
    if str(quant) != baked:
        raise ValueError(
            f"artifact was exported at quant={baked!r} but load was "
            f"asked for quant={quant!r}; pass --quant {baked} "
            f"(ExportedPredictor.load(..., quant={baked!r})) to serve "
            "it, or re-export at the mode you want")
