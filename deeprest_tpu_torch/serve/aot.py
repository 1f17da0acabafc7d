"""The fleet's AOT sidecar: a fingerprinted manifest next to the checkpoint
(``deeprest_tpu/serve/aot.py``).

The JAX plane moves the compile of its fused serving programs to export
time: ``export_aot`` serializes each compiled executable into
``<ckpt>/aot/`` and pool admission deserializes them.  The port has no
such thing to move.  What a template's cold start pays, measured on the
card (``benchmarks/fleet_bench.py --cold-start``, PERF.md), is the kernel
library's load (built from the repo's sources into ``build/kernels/``,
never into a checkpoint), the checkpoint load, the first eager call of
each rung program and each rung's CUDA-graph capture; a CUDA graph cannot
be serialized, and tenants after the first already capture nothing.  So
the sidecar holds the manifest alone:

- ``export_aot`` writes ``<ckpt>/aot/manifest.json``: the fingerprint of
  the engine that wrote it and the rung graphs a plane of it captures
  (``planned_graphs``), with no executable entries;
- ``load_aot`` checks it at the pool's first admission and never raises
  on an artifact problem: it returns ``{"loaded": 0, "fallback_rungs":
  [(program, rung), ...], "reason": str, "bytes": 0}``, where the
  fallbacks are the graphs the plane will capture (the pool's
  ``compile_fallbacks``) and the reason says why nothing loaded: no
  manifest, an unreadable one, a fingerprint mismatch naming every
  mismatched key (never partially trusted), or a verified manifest with
  nothing to load.

Params-agnostic, as in JAX: the fingerprint covers the params tree's leaf
names, global shapes and dtypes, never values, so one manifest serves
every tenant of the architecture and quant mode, and a sidecar written on
one device verifies on a mesh plane of the same checkpoint.  It replaces
JAX's ``jax`` and ``platform`` with the torch and CUDA versions, the
device's name and compute capability and the kernel libraries' digests.
"""

from __future__ import annotations

import hashlib
import json
import os

import torch

from deeprest_tpu_torch.models.qrnn import param_shapes
from deeprest_tpu_torch.ops import quantize as quant_ops

AOT_SUBDIR = "aot"
MANIFEST_NAME = "manifest.json"
NOTHING_TO_LOAD = ("nothing to load: a CUDA graph cannot be serialized, "
                   "so the plane captures its rung graphs at warm()")


def aot_dir(checkpoint_dir: str) -> str:
    """Where a checkpoint's AOT sidecar lives (next to the checkpoint)."""
    return os.path.join(checkpoint_dir, AOT_SUBDIR)


def _tree_signature(predictor) -> str:
    """Stable hash of the weight leaves' names, global shapes and dtypes:
    the graphs are params-agnostic but shape-exact.  The shapes are the
    whole leaves' (``models.qrnn.param_shapes``; a ``QuantTensor``'s scale
    by ``ops.quantize.scale_shape``) on any mesh, where a rank holds boxes
    of them, so a sidecar written on one device verifies on a mesh plane,
    as JAX's hash of the params' global avals does."""
    shapes = param_shapes(predictor.model_config)
    h = hashlib.sha1()
    for name, t in sorted(predictor.bound_state().items()):
        if name.startswith("w."):
            h.update(str((name, _global_shape(name[2:], shapes),
                          str(t.dtype))).encode())
    return h.hexdigest()[:16]


def _global_shape(leaf: str, shapes: dict) -> tuple[int, ...]:
    """The whole shape of a bound weight leaf (``mask_w2``,
    ``head_w.data``, ``head_w.scale``) from the params' shapes."""
    name, _, part = leaf.partition(".")
    if part == "scale":
        return quant_ops.scale_shape(shapes[name])
    return tuple(shapes[name])


def _kernel_digests() -> dict[str, str]:
    """Each kernel library's file name, which carries the digest of its
    source, the headers it includes and the nvcc flags."""
    from deeprest_tpu_torch.ops.cuda_gru import SOURCES

    return {src.name: os.path.basename(src.library_path())
            for src in SOURCES}


def planned_graphs(predictor) -> list[tuple[str, int]]:
    """The ``(program, rung)`` keys ``warm()`` runs, in its order: on CUDA
    the graphs a plane of this predictor captures."""
    keys = [("apply", int(r)) for r in predictor.ladder.ladder]
    if predictor.sparse_feed:
        keys += [("sparse_apply", int(r)) for r in predictor.ladder.ladder]
    eng = predictor.fused
    if eng is not None:
        programs = (("fused", "fused_increments") if eng._has_delta
                    else ("fused",))
        prefix = "sparse_" if eng.sparse_enabled else ""
        keys += [(prefix + p, int(r)) for r in eng.rungs for p in programs]
    return keys


def engine_fingerprint(predictor) -> dict:
    """Everything that must match between the exporting and the loading
    engine for the manifest to describe the plane."""
    device = torch.device(predictor.device)
    cuda = device.type == "cuda"
    eng = predictor.fused
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "capability": (list(torch.cuda.get_device_capability(device))
                       if cuda else None),
        "kernels": _kernel_digests(),
        "window_size": int(predictor.window_size),
        "feature_dim": int(predictor.feature_dim),
        "num_metrics": len(predictor.metric_names),
        "num_quantiles": len(predictor.quantiles),
        "quant": predictor.quant,
        "ladder": [int(r) for r in predictor.ladder.ladder],
        "rungs": ([int(r) for r in eng.rungs] if eng is not None else None),
        "delta": bool(eng is not None and eng._has_delta),
        "sparse_nnz_cap": (int(predictor.sparse_nnz_cap)
                           if predictor.sparse_feed else None),
        "params_tree": _tree_signature(predictor),
    }


def export_aot(predictor, checkpoint_dir: str) -> dict:
    """Write the sidecar's manifest next to the checkpoint
    (``<ckpt>/aot/manifest.json``) and return it."""
    keys = planned_graphs(predictor)
    manifest = {"fingerprint": engine_fingerprint(predictor),
                "entries": [],
                "graphs": [list(k) for k in keys],
                "holds": "the fingerprint alone; " + NOTHING_TO_LOAD}
    out_dir = aot_dir(checkpoint_dir)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, MANIFEST_NAME), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return manifest


def load_aot(predictor, checkpoint_dir: str) -> dict:
    """Check the sidecar at pool admission.  Never raises on an artifact
    problem: ``{"loaded": 0, "fallback_rungs": [(program, rung), ...],
    "reason": str, "bytes": 0}`` (module docstring)."""
    want = planned_graphs(predictor)
    result = {"loaded": 0, "fallback_rungs": want, "reason": None,
              "bytes": 0}
    man_path = os.path.join(aot_dir(checkpoint_dir), MANIFEST_NAME)
    if not os.path.exists(man_path):
        result["reason"] = "no artifacts"
        return result
    try:
        with open(man_path, encoding="utf-8") as f:
            manifest = json.load(f)
        stored = dict(manifest.get("fingerprint", {}))
    except (OSError, ValueError, TypeError, AttributeError) as e:
        result["reason"] = f"unreadable manifest: {e}"
        return result
    fp = engine_fingerprint(predictor)
    if stored != fp:
        diff = sorted(k for k in set(fp) | set(stored)
                      if fp.get(k) != stored.get(k))
        result["reason"] = f"fingerprint mismatch: {diff}"
        return result
    result["reason"] = f"manifest verified; {NOTHING_TO_LOAD}"
    return result
