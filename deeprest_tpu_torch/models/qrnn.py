"""The estimator: a multi-task, attention-masked, quantile GRU
(``deeprest_tpu/models/qrnn.py``).

Per metric one *expert*: (a) a learned soft feature mask over the shared
traffic features, (b) a bidirectional GRU over the window, (c) a quantile
head fed with ``concat(mean of the other experts' GRU outputs, own
output)``.  As in the JAX package:

- experts are a leading array axis ``E`` of every weight, so the model is
  a handful of batched products;
- the mask folds into the layer-0 input weights, ``(x ⊙ m) @ W ≡ x @
  (m ⊙ W)``, in f32 before any cast, so the masked input is never built
  per expert;
- mixing is O(E): ``mean_{j≠i} out_j = (Σ_j out_j − out_i) / (E − 1)``,
  summed in f32; with one metric the mix falls back to the expert's own
  output;
- the head keeps its ``[E, 2D, Q]`` weight but splits the product over the
  two halves, so ``[E, B, T, 2D]`` is never built; it accumulates in f32
  and adds ``head_b`` to the f32 sum.

Dropout (``deterministic=False``, training only) drops the recurrence
output in the compute dtype before mixing, where the flax module applies
it: each value is kept with probability ``1 - dropout_rate`` and scaled by
its inverse.  Its mask comes from an explicit ``torch.Generator``, so its
bits are not JAX's.  The trainer makes the stream a pure function of
``(seed, step, microbatch)``, the counterpart of ``fold_in(rng, step)``: on
the CPU one generator seeded per microbatch, on a GPU one Philox generator
per run whose offset it sets from the step, which a CUDA graph that
registers the generator replays as an eager step draws.  Serving is
deterministic.  The parameters are registered without gradients; the
trainer turns them on.  ``forward(params=...)`` runs the module on another
params dict of the same names (the exact-mode accumulation passes the
mask-folded one); ``forward(dropout_rows=...)`` draws the global batch's
dropout mask and keeps a data-parallel rank's rows of it.  Input ``[B, T, F]`` (or ``[G, B, T, F]``, groups folded
into the rows) → output ``[B, T, E, Q]`` (``[G, B, T, E, Q]``) in f32.

On a mesh (``QuantileGRU(config, mesh=...)``) the module holds this rank's
box of every leaf by the partition-rule table (``parallel/sharding.py``):
``E/e`` experts, and with a ``model`` axis ``F/M`` columns of ``mask_w2``,
``mask_b2`` and the layer-0 ``w_ih``.  The forward runs the collectives
GSPMD inserts for JAX (``parallel/collectives.py``): the softmax of the
mask over the sharded F (a MAX shift, a SUM of exponentials with a SUM
backward, the hidden layer through "f" so the ``mask_w1``/``mask_b1``
gradients are whole on every model rank), the layer-0 projection summed
over the model group (``ops/gru.py``), and the mixing total summed over
the expert group with the global ``E − 1`` divisor.  The input stays the
whole ``[B, T, F]``; the output is the rank's experts, ``[B, T, E/e, Q]``.
Dropout draws the global ``[E, G·B, T, D]`` mask and cuts the rank's
experts and rows, so the ranks drop what one process would.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from deeprest_tpu_torch.config import ModelConfig
from deeprest_tpu_torch.ops.gru import (
    GRUParams, Recurrence, bidirectional_gru, gru,
)
from deeprest_tpu_torch.parallel.collectives import (
    copy_replicated, max_replicated, sum_partials,
)
from deeprest_tpu_torch.parallel.mesh import hold_groups
from deeprest_tpu_torch.parallel.sharding import (
    box_slices, expert_feature_box, rank_box, spec_of,
)

MASK_PARAM_NAMES = ("mask_w1", "mask_b1", "mask_w2", "mask_b2")
# Layer-0 input weights the soft mask folds into; only the keys present
# apply (bwd exists iff bidirectional).
MASKED_PARAM_NAMES = ("gru_fwd_w_ih", "gru_bwd_w_ih")


def resolve_params(params: Mapping) -> dict:
    """Dequantize-at-use for a quantized serving params dict
    (``ops.quantize.quantize_params``), identity for f32 and bf16 dicts:
    every ``QuantTensor`` leaf through ``ops.quantize.dequantize``, the one
    dequant site shared with ``ops.gru.resolve_weights``.  The serving
    predictor calls it inside each rung's program, so on CUDA the dequant
    is captured in the rung's graph."""
    from deeprest_tpu_torch.ops.quantize import dequantize_params

    return dequantize_params(params)


def feature_mask(params: Mapping[str, torch.Tensor],
                 model_group=None) -> torch.Tensor:
    """The soft feature mask ``[E, F]``: Linear(1→H) on a constant 1.0
    (weight + bias), ReLU, Linear(H→F), softmax over F.  A bf16
    ``mask_w2`` (bf16 quantized serving) widens to f32 exactly, as the
    JAX einsum promotes it.  With ``model_group`` the params hold this
    rank's F shard and the softmax runs over the whole F: a MAX shift
    and a SUM of exponentials over the group; the result is the rank's
    shard of the mask."""
    hidden = torch.relu(params["mask_w1"] + params["mask_b1"])          # [E, H]
    hidden = copy_replicated(hidden, model_group)
    logits = (torch.einsum("eh,ehf->ef", hidden,
                           params["mask_w2"].to(hidden.dtype))
              + params["mask_b2"])
    if model_group is None:
        return torch.softmax(logits, dim=-1)
    shift = max_replicated(logits.amax(dim=-1, keepdim=True), model_group)
    ex = torch.exp(logits - shift)
    return ex / sum_partials(ex.sum(dim=-1, keepdim=True), model_group)


def fold_feature_mask(params: Mapping[str, torch.Tensor],
                      model_group=None) -> dict[str, torch.Tensor]:
    """A new params dict with the mask folded into every
    ``MASKED_PARAM_NAMES`` leaf; apply it with ``mask_folded=True``.
    ``model_group`` as for :func:`feature_mask` (the fold is local to the
    shard)."""
    mask = feature_mask(params, model_group)
    out = dict(params)
    for name in MASKED_PARAM_NAMES:
        if name in out:
            out[name] = mask[:, :, None] * out[name]
    return out


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator,
            rows: tuple[int, int, int] | None = None,
            experts: tuple[int, int, int] | None = None) -> torch.Tensor:
    """``flax.linen.Dropout`` with ``deterministic=False``: keep each value
    with probability ``1 - rate`` and scale it by ``1 / (1 - rate)``, in
    x's dtype; the mask is drawn from ``generator``.

    ``rows = (b, lo, hi)``: x's axis 1 holds rows ``lo:hi`` of each
    ``b``-row batch of the global tensor (a data-parallel rank's slice);
    ``experts = (e, lo, hi)``: x's axis 0 holds experts ``lo:hi`` of the
    global ``e`` (an expert rank's).  The global tensor's mask is drawn
    and the rank's part is cut from it, so the ranks together drop what
    one process would."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    if rows is None and experts is None:
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
    else:
        e, e_lo, e_hi = experts or (x.shape[0], 0, x.shape[0])
        b, lo, hi = rows or (x.shape[1], 0, x.shape[1])
        groups, rest = x.shape[1] // (hi - lo), x.shape[2:]
        full = torch.rand((e, groups * b, *rest), generator=generator,
                          device=x.device)
        mask = full.reshape(e, groups, b, *rest)[e_lo:e_hi, :, lo:hi] \
            .reshape(x.shape) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, as the JAX module creates them."""
    e, f, h, q = (cfg.num_metrics, cfg.feature_dim, cfg.hidden_size,
                  len(cfg.quantiles))
    shapes = {"mask_w1": (e, h), "mask_b1": (e, h), "mask_w2": (e, h, f),
              "mask_b2": (e, f)}
    directions = ("fwd", "bwd") if cfg.bidirectional else ("fwd",)
    for layer in range(cfg.num_layers):
        sfx = "" if layer == 0 else f"_l{layer}"
        in_dim = f if layer == 0 else cfg.rnn_out_dim
        for d in directions:
            shapes[f"gru_{d}{sfx}_w_ih"] = (e, in_dim, 3 * h)
            shapes[f"gru_{d}{sfx}_w_hh"] = (e, h, 3 * h)
            shapes[f"gru_{d}{sfx}_b_ih"] = (e, 3 * h)
            shapes[f"gru_{d}{sfx}_b_hh"] = (e, 3 * h)
    shapes["head_w"] = (e, 2 * cfg.rnn_out_dim, q)
    shapes["head_b"] = (e, q)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Random f32 params made with numpy from ``seed``: each leaf uniform
    in ±1/sqrt(fan_in) of its layer, the JAX module's init distribution
    (its random stream differs)."""
    rng = np.random.default_rng(seed)
    scale = {"mask_w1": 1.0, "mask_b1": 1.0,
             "mask_w2": 1.0 / math.sqrt(cfg.hidden_size),
             "mask_b2": 1.0 / math.sqrt(cfg.hidden_size),
             "head_w": 1.0 / math.sqrt(2 * cfg.rnn_out_dim),
             "head_b": 1.0 / math.sqrt(2 * cfg.rnn_out_dim)}
    out = {}
    for name, shape in param_shapes(cfg).items():
        k = scale.get(name, 1.0 / math.sqrt(cfg.hidden_size))
        out[name] = rng.uniform(-k, k, shape).astype(np.float32)
    return out


class QuantileGRU(nn.Module):
    """Multi-task quantile GRU with the JAX module's parameter names; on a
    ``mesh`` (``parallel.make_mesh``) it holds this rank's box of each
    leaf and runs the mesh's collectives (see the module docstring)."""

    config: ModelConfig

    def __init__(self, config: ModelConfig, device=None, mesh=None):
        super().__init__()
        self.config = config
        shapes = param_shapes(config)
        self._boxes = {}
        if mesh is not None and (mesh.config.expert > 1
                                 or mesh.config.model > 1):
            self._boxes = {name: rank_box(mesh, spec_of(name, shape), shape,
                                          name)
                           for name, shape in shapes.items()}
        self.expert_group = None if mesh is None else mesh.expert_group
        self.model_group = None if mesh is None else mesh.model_group
        if mesh is not None and mesh.group is not None:
            # a remesh's teardown severs these too (parallel/mesh.py)
            hold_groups(self)
        # a sharded module runs only with the groups its collectives need
        # (a hand-built Mesh without a job holds the boxes, nothing more)
        self._grouped = mesh is None or (
            (mesh.config.expert == 1 or self.expert_group is not None)
            and (mesh.config.model == 1 or self.model_group is not None))
        # this rank's experts and columns of F (the whole without a mesh)
        e_box, f_box = expert_feature_box(mesh, shapes["mask_w2"]) \
            if mesh is not None else ((0, config.num_metrics),
                                      (0, config.feature_dim))
        self.experts = slice(*e_box)
        self.features = slice(*f_box)
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(self.local_shape(name, shape), device=device),
                requires_grad=False))

    def local_shape(self, name: str, shape: tuple[int, ...]
                    ) -> tuple[int, ...]:
        """The shape of this rank's box of leaf ``name`` (global
        ``shape``)."""
        box = self._boxes.get(name)
        return shape if box is None else tuple(hi - lo for lo, hi in box)

    def own_box(self, name: str, value) -> torch.Tensor:
        """This rank's box of param ``name`` from ``value``, the whole
        (JAX's shape; the box is cut from it) or the box already; a shape
        that is neither raises."""
        shape = param_shapes(self.config)[name]
        value = torch.as_tensor(value)
        local = self.local_shape(name, shape)
        if local != shape and tuple(value.shape) == shape:
            value = value[box_slices(self._boxes[name])]
        if tuple(value.shape) != local:
            box = "" if local == shape else f" (its box here {local})"
            raise ValueError(f"param {name!r} has shape "
                             f"{tuple(value.shape)}, the architecture "
                             f"needs {shape}{box}")
        return value

    @property
    def sharded(self) -> bool:
        """Whether the rank holds less than the whole of some leaf."""
        return bool(self._boxes)

    def load_params(self, params: Mapping[str, torch.Tensor | np.ndarray]
                    ) -> "QuantileGRU":
        """Copy a params dict (JAX names) into the module, keeping each
        leaf's dtype and each parameter's ``requires_grad``.  Each leaf is
        the whole (JAX's shape; on a mesh the rank's box is cut from it,
        ``parallel.shard_params``) or, on a mesh, the rank's box
        already."""
        expected = param_shapes(self.config)
        missing = set(expected) - set(params)
        extra = set(params) - set(expected)
        if missing or extra:
            raise KeyError(f"params do not match the architecture: missing "
                           f"{sorted(missing)}, unexpected {sorted(extra)}")
        for name in expected:
            value = self.own_box(name, params[name])
            old = getattr(self, name)
            setattr(self, name, nn.Parameter(
                value.detach().to(old.device).clone(),
                requires_grad=old.requires_grad))
        return self

    def params(self) -> dict[str, torch.Tensor]:
        return {name: p for name, p in self.named_parameters()}

    @property
    def quantiles(self) -> tuple[float, ...]:
        return self.config.quantiles

    def median_index(self) -> int:
        """Index of the quantile nearest .50 in the output's last axis."""
        diffs = [abs(q - 0.5) for q in self.config.quantiles]
        return diffs.index(min(diffs))

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                generator: torch.Generator | None = None,
                mask_folded: bool = False,
                recurrence: Recurrence | None = None,
                params: Mapping[str, torch.Tensor] | None = None,
                dropout_rows: tuple[int, int, int] | None = None
                ) -> torch.Tensor:
        """``x [B, T, F]`` (or ``[G, B, T, F]``), the whole F on a mesh too
        → this rank's experts' predictions ``[B, T, E/e, Q]`` in f32."""
        cfg = self.config
        if not self._grouped:
            raise ValueError("this module holds its rank's boxes of a mesh "
                             "whose process groups it lacks; build the "
                             "mesh with parallel.make_mesh in the job")
        if not deterministic and cfg.dropout_rate > 0.0 and generator is None:
            raise ValueError("dropout (deterministic=False) needs an explicit "
                             "torch.Generator on the input's device")
        e, f = cfg.num_metrics, cfg.feature_dim
        if x.shape[-1] != f:
            raise ValueError(f"input feature dim {x.shape[-1]} != "
                             f"config.feature_dim {f}")
        compute = getattr(torch, cfg.compute_dtype)
        group_shape = None
        if x.dim() == 4:
            group_shape = tuple(x.shape[:2])
            x = x.reshape(group_shape[0] * group_shape[1], *x.shape[2:])

        p = self.params() if params is None else params
        tp = self.model_group
        mask = None if mask_folded else feature_mask(p, tp)            # [E, F]

        def direction(name: str, layer: int) -> GRUParams:
            w_ih = p[f"{name}_w_ih"]
            if layer == 0 and mask is not None:
                w_ih = mask[:, :, None] * w_ih          # fold in f32, then cast
            return GRUParams(w_ih.to(compute), p[f"{name}_w_hh"].to(compute),
                             p[f"{name}_b_ih"].to(compute),
                             p[f"{name}_b_hh"].to(compute))

        out = x.to(compute)                                             # [B,T,F]
        if tp is not None:
            out = out[..., self.features]                  # the rank's F slice
        for layer in range(cfg.num_layers):
            sfx = "" if layer == 0 else f"_l{layer}"
            fwd = direction(f"gru_fwd{sfx}", layer)
            layer_tp = tp if layer == 0 else None
            if cfg.bidirectional:
                bwd = direction(f"gru_bwd{sfx}", layer)
                out = bidirectional_gru(fwd, bwd, out, recurrence=recurrence,
                                        tp_group=layer_tp)
            else:
                out = gru(fwd, out, recurrence=recurrence, tp_group=layer_tp)
        rnn_out = out                                                   # [E,B,T,D]
        if not deterministic:
            experts = (None if self.expert_group is None else
                       (e, self.experts.start, self.experts.stop))
            rnn_out = dropout(rnn_out, cfg.dropout_rate, generator,
                              dropout_rows, experts)

        if e > 1:
            own = rnn_out.float()
            total = sum_partials(own.sum(dim=0, keepdim=True),
                                 self.expert_group)
            mix = ((total - own) / (e - 1)).to(compute)
        else:
            mix = rnn_out

        d = rnn_out.shape[-1]
        hw = p["head_w"].to(compute).float()
        preds = (torch.einsum("ebtd,edq->ebtq", mix.float(), hw[:, :d])
                 + torch.einsum("ebtd,edq->ebtq", rnn_out.float(), hw[:, d:]))
        preds = preds + p["head_b"].float()[:, None, None, :]
        preds = preds.permute(1, 2, 0, 3)                               # [B,T,E,Q]
        if group_shape is not None:
            preds = preds.reshape(*group_shape, *preds.shape[1:])
        return preds
