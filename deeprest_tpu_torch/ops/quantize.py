"""Weight quantization for serving: int8 / bf16 storage with a measured,
stored parity envelope (``deeprest_tpu/ops/quantize.py``).

- :func:`quantize_params` — per-output-channel symmetric int8 (a
  :class:`QuantTensor` of int8 data and f32 scales) or bf16 storage for
  every matmul weight leaf (``w_ih``/``w_hh``/``head_w``/``mask_w2``);
  biases, the mask MLP's first layer and the rest stay f32.
- :func:`dequantize` — the one dequant site: int8 values reach float math
  only here.  ``models.qrnn.resolve_params`` and ``ops.gru.resolve_weights``
  route through it, and the serving predictor calls them inside each rung's
  program, so on CUDA the widen-and-scale is part of every captured graph
  and no dequantized copy is kept beside the int8 tree.
- the parity envelope — :func:`parity_envelope` measures the per-(metric,
  quantile) max deviation from the f32 reference on the seeded
  :func:`probe_batch` at quantize time; :func:`budget_from_measured` pins
  the stored budget; :func:`check_envelope` is the gate
  (``serve/predictor.py`` raises :class:`QuantParityError` on a violation
  at every (re)load).

Rounding matches the JAX package: ``torch.round`` rounds half to even as
``jnp.round`` does, and the scale is ``max(max|w|, 1e-12) / 127`` in f32.

On a mesh a rank quantizes its boxes of the weights (``parallel/
sharding.py``).  JAX quantizes the whole array, so where a leaf's
contraction axis is sharded (the layer-0 ``w_ih`` on the ``model`` axis)
the per-column max |w| is MAX-reduced over that axis's group before the
divide: every rank then holds, bit for bit, its slice of the one-process
quantization, and its scale the weight's box with the contraction
dimension whole.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from deeprest_tpu_torch.parallel.collectives import max_replicated

# The serving quant modes (InferConfig.quant / --quant).
QUANT_MODES = ("off", "int8", "bf16")

# Matmul weight leaves, by name fragment: the GRU input and recurrent
# kernels, the quantile head and the feature-mask MLP's second layer.
WEIGHT_FRAGMENTS = ("w_ih", "w_hh", "head_w", "mask_w2")

# Symmetric int8: 127, not 128, with no zero point.
_INT8_MAX = 127.0


class QuantParityError(ValueError):
    """A quantized prediction exceeded its stored parity budget; the
    checkpoint reloader reports it, never mistaking it for a benign
    mid-write checkpoint."""


class QuantTensor(NamedTuple):
    """One int8-quantized weight matrix: ``data`` int8 ``[..., K, C]`` with
    f32 per-output-channel ``scale`` ``[..., 1, C]`` (the reduction ran
    over the contraction axis K)."""

    data: torch.Tensor
    scale: torch.Tensor


def is_weight_leaf(name: str) -> bool:
    """Is this param leaf one of the matmul weight matrices the quantized
    path stores narrow?"""
    return any(frag in name for frag in WEIGHT_FRAGMENTS)


def quantize_leaf_int8(w: torch.Tensor, group=None) -> QuantTensor:
    """Per-output-channel symmetric int8 quantization of one weight matrix
    ``[..., K, C]`` (contraction axis second to last).  ``group``: the
    process group K is sharded over (each rank holds a block of K), whose
    MAX of the column maxima makes the scales the whole K's."""
    w = torch.as_tensor(w).float()
    if w.dim() < 2:
        raise ValueError(
            f"int8 quantization needs a [.., K, C] matrix, got "
            f"{tuple(w.shape)}")
    amax = max_replicated(w.abs().amax(dim=-2, keepdim=True), group)
    scale = torch.clamp_min(amax, 1e-12) / _INT8_MAX
    q = torch.clamp(torch.round(w / scale), -_INT8_MAX, _INT8_MAX)
    return QuantTensor(data=q.to(torch.int8), scale=scale.float())


def scale_shape(shape) -> tuple[int, ...]:
    """The shape of the int8 scale of a weight of ``shape`` ``[..., K, C]``
    (:func:`quantize_leaf_int8`): the contraction axis K kept as 1."""
    shape = tuple(int(d) for d in shape)
    return shape[:-2] + (1,) + shape[-1:]


def dequantize(leaf, dtype=None):
    """The one dequant site: a :class:`QuantTensor` re-enters float math
    as ``data * scale`` in f32 (cast to ``dtype`` when given).  Identity
    on anything else (f32 leaves, and the bf16 mode's plain bf16 tensors,
    which the model casts at use)."""
    if isinstance(leaf, QuantTensor):
        w = leaf.data.float() * leaf.scale
        return w if dtype is None else w.to(dtype)
    return leaf


def quantize_params(params: Mapping[str, torch.Tensor], mode: str,
                    contraction_group=None) -> dict:
    """Quantize every matmul weight leaf of a flat params dict:
    ``"off"`` identity, ``"int8"`` :class:`QuantTensor` leaves, ``"bf16"``
    bf16 tensors; every other leaf unchanged.  ``contraction_group(name)``
    (a rank's boxes on a mesh) gives the process group a leaf's
    contraction axis is sharded over, or None (:func:`quantize_leaf_int8`);
    every rank of the mesh must call this, in the same leaf order."""
    if mode == "off":
        return dict(params)
    if mode not in QUANT_MODES:
        raise ValueError(f"quant mode {mode!r} not in {QUANT_MODES}")
    out = {}
    for name, leaf in params.items():
        if not is_weight_leaf(name):
            out[name] = leaf
        elif mode == "int8":
            out[name] = quantize_leaf_int8(
                leaf, None if contraction_group is None
                else contraction_group(name))
        else:
            out[name] = torch.as_tensor(leaf).to(torch.bfloat16)
    return out


def dequantize_params(params: Mapping) -> dict:
    """Every :class:`QuantTensor` leaf through :func:`dequantize`, every
    other leaf untouched."""
    return {name: dequantize(leaf) for name, leaf in params.items()}


def weight_bytes(params: Mapping) -> int:
    """Bytes held by the matmul weight leaves, the scales of a
    :class:`QuantTensor` included."""
    total = 0
    for name, leaf in params.items():
        if isinstance(leaf, QuantTensor):
            total += leaf.data.numel() * leaf.data.element_size()
            total += leaf.scale.numel() * leaf.scale.element_size()
        elif is_weight_leaf(name):
            t = torch.as_tensor(leaf)
            total += t.numel() * t.element_size()
    return total


# -- the parity envelope (measured, stored, enforced) -----------------------

PROBE_BATCH = 4
PROBE_SEED = 0
ENVELOPE_MARGIN = 2.0
ENVELOPE_FLOOR = 1e-6


def probe_batch(window_size: int, feature_dim: int,
                batch: int = PROBE_BATCH) -> np.ndarray:
    """The seeded parity probe: uniform [0, 1) windows (the normalized
    feature range the model serves)."""
    rng = np.random.default_rng(PROBE_SEED)
    return rng.random((batch, window_size, feature_dim)).astype(np.float32)


def parity_envelope(ref_out, quant_out, metric_names,
                    quantiles) -> dict[str, float]:
    """Per-(metric, quantile) max |quantized - f32| over the probe, keyed
    ``"<metric>|q<quantile>"``; outputs are ``[B, T, E, Q]``."""
    ref = np.asarray(ref_out, np.float32)
    got = np.asarray(quant_out, np.float32)
    per = np.abs(got - ref).max(axis=(0, 1))              # [E, Q]
    # graftlint: disable=JX003 -- per is already a HOST np array (the one device→host readback happened at the np.asarray above); this loop indexes host memory once per (metric, quantile) cell at quantize time, not per serving request
    return {f"{m}|q{q:g}": float(per[i, j])
            for i, m in enumerate(metric_names)
            for j, q in enumerate(quantiles)}


def budget_from_measured(measured: dict[str, float],
                         margin: float = ENVELOPE_MARGIN,
                         floor: float = ENVELOPE_FLOOR) -> dict[str, float]:
    """The stored budget: measured × margin, floored (a cell measured at
    zero must not pin an unmeetable 0.0 budget)."""
    return {k: max(v * margin, floor) for k, v in measured.items()}


def check_envelope(measured: dict[str, float],
                   budget: dict[str, float]) -> list[str]:
    """Violations of the stored budget.  A cell missing from the budget is
    a violation too."""
    out = []
    for key, val in measured.items():
        cap = budget.get(key)
        if cap is None:
            out.append(f"{key}: no stored budget for this cell")
        elif val > cap:
            out.append(f"{key}: measured {val:.3e} > budget {cap:.3e}")
    return out
