"""The inference engine: checkpointed model → utilization predictions
(``deeprest_tpu/serve/predictor.py``).

Everything a consumer needs — params, model config, normalization
statistics, metric names — is restored from one checkpoint directory, so
serving cannot drift from training state.  On CUDA every serving program,
the shape ladder's model apply and the fused engine's page program (and
their padded-COO twins under ``sparse_feed``), runs as captured CUDA
graphs, one per rung (serve/graphs.py); :meth:`RungServing.warm` captures
them all up front.

The fleet tier (serve/fleet.py): :meth:`Predictor.share_executables_from`
puts predictors of one architecture behind one plane's graphs.  A graph
reads the tensors its program closed over at capture, so the plane is a
predictor over COPIES of the first tenant's weights and stats whose
tensors are the graphs' bound slot (serve/graphs.py ``BoundSlot``); each
tenant keeps only its own weights, stats, host invert operands and names,
and every run binds it into the slot first.  The plane serves no tenant.

Quantized serving (``quant="int8"|"bf16"``, ``ops/quantize.py``): the
weight leaves are stored narrow and dequantized at use inside each rung's
program (``models.qrnn.resolve_params``), so no f32 copy sits beside them.
The per-(metric, quantile) parity envelope against the f32 reference is
measured on the seeded probe batch at load and stored next to the
checkpoint as ``quant_parity_<mode>.json``; every later load re-measures
it and raises ``QuantParityError`` on a violated budget, whichever package
wrote the file.

A mesh (``Predictor(mesh=...)``, ``from_checkpoint(mesh_config=...)``):
the params are placed by the partition-rule table (``parallel/sharding.py``),
each rank holding its experts and, on a ``model`` axis, its F columns,
and each answer is all-gathered on the expert axis, so every rank returns
``[..., E, Q]``.  JAX's serving data axis replicates the work (its
predictor hands the mesh only to the params' placement), and so does the
port's: every rank runs the same calls on the same inputs.  Rung graphs
capture the mesh's collectives under NCCL; gloo's cannot be captured, so
a gloo mesh on CUDA needs ``cuda_graphs=False`` and raises without it.

Quantized serving on a mesh: each rank quantizes its boxes with the scales
of the whole array (``ops/quantize.py``), so its int8 data and scales are
bit for bit its slice of the one-process quantization, and the digest,
gathered, is the one-process quantized predictor's.  The parity envelope
is measured on the gathered answer, every rank alike.  In a job of more
than one rank :meth:`Predictor.from_checkpoint` agrees before any
collective: rank 0 picks the step and reads the stored budget and
broadcasts both, every rank reads its boxes, and a read that failed on
any rank fails every rank; only rank 0 writes the envelope file.

The fleet tier on a mesh above one rank (``serve --mesh ... --fleet``):
the mesh predictor is the default tenant and the pool's template, and it
serves through a plane of its own mesh, made on every rank
(:meth:`Predictor.fleet_plane`).  Every other tenant is a one-device
predictor on rank 0's device; the one-device tenants share one
one-device plane, kept beside the template and made by the first of them
(:meth:`Predictor.share_executables_from`).  No one-device call is ever
announced to the other ranks.  The mesh tenant's spill and restore
(:meth:`Predictor.spill`, :meth:`Predictor.restore`) and the gather of
its whole params for a one-device clone (:meth:`Predictor.whole_params`)
are mirrored ops of rank 0's front: every rank moves or gathers its own
shards in step.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
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
from deeprest_tpu_torch.parallel.collectives import gather_along
from deeprest_tpu_torch.parallel.distributed import agree, broadcast_json
from deeprest_tpu_torch.parallel.mesh import GROUP_FIELDS, hold_groups
from deeprest_tpu_torch.serve.batcher import BatchedBackendMixin
from deeprest_tpu_torch.serve.fused import FusedInferenceMixin
from deeprest_tpu_torch.serve.graphs import (
    BoundSlot, PinnedStaging, RungGraphs,
)


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


# The JAX package's historical name for the host loop.
rolled_prediction = rolled_prediction_reference


def _spans_ranks(predictor) -> bool:
    """Whether ``predictor`` is on a mesh of more than one rank."""
    mesh = getattr(predictor, "mesh", None)
    return mesh is not None and mesh.size > 1


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
        self._serving_args = (ladder, coalesce_groups, fused, page_windows,
                              coalesce_pages, sparse_feed, sparse_nnz_cap,
                              cuda_graphs)
        self._plane = None           # the shared plane, once in a fleet
        # a mesh template's one-device plane: its one-device tenants'
        self._device_plane = None
        self._front = None           # rank 0's mesh front, once attached
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

    def attach_front(self, front) -> None:
        """Announce every device call to the other ranks of the mesh
        through ``front`` (rank 0 of ``serve --mesh``,
        serve/mesh_front.py), inside the graphs lock each entry holds."""
        self._front = front
        if self._fused is not None:
            self._fused._front = front

    @property
    def front(self):
        """The attached mesh front (rank 0 of ``serve --mesh``), or None."""
        return self._front

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
        tensor (a clone of the graph's static output on CUDA).  With a
        mesh front attached the call is first announced to the other
        ranks."""
        r = len(next(iter(arrays.values())))
        with self.graphs.lock, torch.inference_mode(), (
                contextlib.nullcontext() if self._front is None
                else self._front.rung(program, arrays)):
            slot = staging.take()
            for name, a in arrays.items():
                slot[name][:r].numpy()[...] = a
            (y,) = self.graphs.run((program, r), fn,
                                   tuple(slot[n][:r] for n in arrays),
                                   staged=slot, owner=self)
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
        for unit in self.warm_units():
            unit()
        return self.warmed()

    def warm_units(self) -> list:
        """:meth:`warm`'s device calls in order, each a call of no
        arguments: a reload on a serving mesh runs them one at a time on
        every rank (serve/mesh_front.py), then :meth:`warmed`."""
        units = []
        for rung in self.ladder.ladder:
            units.append(functools.partial(self._warm_rung, rung, False))
            if self.sparse_feed:
                units.append(functools.partial(self._warm_rung, rung, True))
        if self._fused is not None:
            units += self._fused.warm_units(self.feature_dim)
        return units

    def _warm_rung(self, rung: int, sparse: bool) -> None:
        w, f, k = self.window_size, self.feature_dim, self.sparse_nnz_cap
        if sparse:
            self._apply_sparse_numpy(np.zeros((rung, w, k), np.int32),
                                     np.zeros((rung, w, k), np.float32))
        else:
            # graftlint: disable=DN002 -- warm-up shape donor: one zero [rung, W, F] batch per rung at capture time, before the plane serves; requests never allocate it
            self._apply_numpy(np.zeros((rung, w, f), np.float32))

    def warmed(self) -> dict:
        """The end of a warm-up whose units ran: the cache handed back and
        later captures counted.  Returns the graphs' stats."""
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
            "fused": (self._fused.cache_size()
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
                 cuda_graphs: bool = True,
                 mesh=None):
        if quant not in quant_ops.QUANT_MODES:
            raise ValueError(
                f"quant mode {quant!r} not in {quant_ops.QUANT_MODES}")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        if (mesh is not None and mesh.backend == "gloo" and cuda_graphs
                and self.device.type == "cuda"):
            raise ValueError(
                "cuda_graphs=True on a gloo mesh: gloo's collectives cannot "
                "be captured in the rung graphs; pass cuda_graphs=False for "
                "eager serving, or use NCCL")
        self.quant = quant
        self.recurrence = recurrence
        self._params_digest: str | None = None
        self._qparams = None
        ref_params = None
        if quant == "off":
            self.model = QuantileGRU(model_config, device=self.device,
                                     mesh=mesh)
            self.model.load_params(params)
        else:
            # The module on the meta device checks the names and shapes,
            # holds the rank's boxes and groups and no weights; the narrow
            # tree is what is served.
            self.model = QuantileGRU(model_config, device="meta", mesh=mesh)
            self.model.load_params(params)
            ref_params = {name: self.model.own_box(name, v).to(self.device)
                          for name, v in params.items()}
            self._qparams = quant_ops.quantize_params(
                ref_params, quant, self._contraction_group)
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
        self.step = None             # the checkpoint step, once restored
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
            preds = self.model(x, recurrence=self.recurrence, params=params)
            return gather_along(preds, -2, self.model.expert_group)

    def _contraction_group(self, name: str):
        """The process group that shards weight ``name``'s contraction
        axis on this predictor's mesh (its int8 scales' MAX runs over
        it), or None."""
        if not self.model.sharded:
            return None
        from deeprest_tpu_torch.models.qrnn import param_shapes
        from deeprest_tpu_torch.parallel.sharding import contraction_axis

        axis = contraction_axis(name, param_shapes(self.model_config)[name])
        return None if axis is None else getattr(self.mesh, f"{axis}_group")

    def _measure_parity(self, ref_params, budget: dict | None) -> dict:
        """The quantized apply against the f32 reference on the seeded
        probe batch (``ops/quantize.probe_batch``), reduced to the
        per-(metric, quantile) envelope; run eagerly, outside the rung
        graphs.  With a stored ``budget`` any violated cell raises.  On a
        mesh both answers are gathered whole (a collective: every rank
        measures), and a violation on any rank raises on every rank."""
        probe = torch.from_numpy(quant_ops.probe_batch(
            self.window_size, self.feature_dim)).to(self.device)
        experts = self.model.expert_group
        with torch.inference_mode():
            want = gather_along(self.model(
                probe, recurrence=self.recurrence, params=ref_params),
                -2, experts)
            got = gather_along(self.model(
                probe, recurrence=self.recurrence,
                params=resolve_params(self._qparams)), -2, experts)
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
            if (self.mesh is not None and self.mesh.size > 1
                    and not agree(self.mesh, not violations)
                    and not violations):
                violations = ["another rank of the mesh measured a cell "
                              "over its budget"]
            if violations:
                raise quant_ops.QuantParityError(
                    f"quantized ({self.quant}) predictions exceed the "
                    "stored parity envelope: "
                    + "; ".join(violations[:8])
                    + (f" (+{len(violations) - 8} more)"
                       if len(violations) > 8 else ""))
        return envelope

    # -- the fleet tier: one plane's graphs, many tenants' weights ------

    def bound_state(self) -> dict[str, torch.Tensor]:
        """The tensors of this predictor that its serving programs read and
        that differ per tenant, by name: every weight leaf (a
        ``QuantTensor``'s data and scale apart), the sparse apply's input
        stats and the fused engine's stats.  A plane's are its graphs'
        bound slot; a tenant's are copied into that slot before each run,
        and are what the pool spills and restores."""
        out = {}
        params = self.params
        for name in sorted(params):
            leaf = params[name]
            if isinstance(leaf, quant_ops.QuantTensor):
                out[f"w.{name}.data"], out[f"w.{name}.scale"] = leaf
            else:
                out[f"w.{name}"] = leaf
        if self.sparse_feed:
            out["x_mn"], out["x_rg"] = self._x_mn, self._x_rg
        if self._fused is not None:
            out.update(self._fused.bound_state())
        return out

    def load_bound_state(self, state: dict) -> None:
        """Point this predictor at ``state`` (:meth:`bound_state`'s names):
        the pool's spill to pinned host copies and its restore.  Values are
        not copied; the tensors it held are dropped."""
        weights = {}
        for key, t in state.items():
            if not key.startswith("w."):
                continue
            name = key[2:]
            if name.endswith((".data", ".scale")):
                name, part = name.rsplit(".", 1)
                weights.setdefault(name, {})[part] = t
            else:
                weights[name] = t
        if self._qparams is None:
            for name, t in weights.items():
                setattr(self.model, name,
                        torch.nn.Parameter(t, requires_grad=False))
        else:
            self._qparams = {
                name: (quant_ops.QuantTensor(t["data"], t["scale"])
                       if isinstance(t, dict) else t)
                for name, t in weights.items()}
        if self.sparse_feed:
            self._x_mn, self._x_rg = state["x_mn"], state["x_rg"]
        if self._fused is not None:
            self._fused.load_bound_state(state)

    def spill(self) -> dict[str, torch.Tensor]:
        """Move this predictor's :meth:`bound_state` to host copies (pinned
        on CUDA) and point it at them, once the copies and every bind
        enqueued before them have landed; returns the copies.  The same
        bytes, so a run that binds from them is bit for bit one that binds
        from the device.  On rank 0 of a serving mesh it is a mirrored op:
        every rank spills its own shards."""
        return self._mirrored("spill", self._spill_here)

    def restore(self, host: dict) -> None:
        """Copy ``host`` (what :meth:`spill` returned) back to the device,
        one copy a tensor, and point this predictor at it.  On rank 0 of a
        serving mesh it is a mirrored op: every rank restores its own
        spill."""
        self._mirrored("restore", functools.partial(self._restore_here,
                                                    host))

    def _mirrored(self, what: str, body):
        """``body()`` here, announced first to the other ranks as the op
        ``what`` when a mesh front is attached (serve/mesh_front.py)."""
        if self._front is None:
            return body()
        return self._front.mirrored(what, body)

    def _spill_here(self) -> dict[str, torch.Tensor]:
        cuda = self.device.type == "cuda"
        host = {}
        for name, t in self.bound_state().items():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
            h.copy_(t, non_blocking=cuda)
            host[name] = h
        self._landed()
        self.load_bound_state(host)
        return host

    def _restore_here(self, host: dict) -> None:
        dev = {name: t.to(self.device, non_blocking=True)
               for name, t in host.items()}
        self._landed()
        self.load_bound_state(dev)

    def _landed(self) -> None:
        """Wait for the copies enqueued so far on the current stream."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            event.synchronize()

    def whole_params(self) -> dict[str, torch.Tensor]:
        """Every served leaf whole (what a one-device clone is built from):
        this rank's leaves where nothing is sharded; on a sharded mesh a
        gather, which every rank makes, and which rank 0 of a serving mesh
        announces to the others as a mirrored op."""
        if not self.model.sharded:
            return {k: v.detach() for k, v in self.params.items()}

        def gather():
            with torch.inference_mode():
                return self._gathered(self.params)

        return self._mirrored("gather", gather)

    def _copy_model(self) -> QuantileGRU:
        """A deep copy of the module that shares its mesh's process groups
        (the job's, never copied)."""
        memo = {id(g): g for g in (getattr(self.model, f, None)
                                   for f in GROUP_FIELDS) if g is not None}
        model = copy.deepcopy(self.model, memo)
        if memo:
            hold_groups(model)
        return model

    def _new_plane(self) -> "Predictor":
        """A serving plane for tenants of this predictor's architecture: a
        predictor over copies of its weights and stats, with rung graphs,
        staging and a fused engine of its own, whose tensors become the
        graphs' bound slot.  No tenant's tensors are ever written.  A mesh
        predictor's plane is on its mesh, with its groups."""
        plane = copy.copy(self)
        plane.model = self._copy_model()
        if self._qparams is not None:
            plane._qparams = {
                name: (quant_ops.QuantTensor(v.data.clone(), v.scale.clone())
                       if isinstance(v, quant_ops.QuantTensor) else v.clone())
                for name, v in self._qparams.items()}
        # fresh graphs, ladder, staging and fused engine (its stats made
        # anew from the host stats), all running the plane's own _apply
        plane._init_serving(*self._serving_args)
        plane._plane = plane
        plane.graphs.slot = BoundSlot(plane.bound_state(), plane)
        return plane

    def _adopt_plane(self, plane: "Predictor") -> None:
        """Serve through ``plane``'s programs, graphs, pinned staging and
        readback; this predictor keeps its own weights and stats, bound
        into the plane's slot before each run."""
        self._plane = plane
        self.graphs = plane.graphs
        self._apply = plane._apply
        self._apply_sparse = plane._apply_sparse
        self._apply_staging = plane._apply_staging
        self._sparse_staging = plane._sparse_staging
        self.ladder._readback = plane.ladder._readback
        if self._fused is not None:
            self._fused.adopt_executables(plane._fused, owner=self)

    def fleet_plane(self) -> "Predictor":
        """The plane this predictor serves through, made from it and
        adopted now when it has none: the fleet's first admission, and
        on a serving mesh every rank's default tenant before its
        warm-up."""
        if self._plane is None:
            self._adopt_plane(self._new_plane())
        return self._plane

    def share_executables_from(self, donor: "Predictor") -> None:
        """Serve through the donor's rung graphs (fleet tier,
        serve/fleet.py), as the JAX predictor adopts its donor's jitted
        programs: predictors of the same architecture and quant mode then
        serve different tenants' weights through ONE graph set, and
        ``jit_cache_size`` stays flat in the number of tenants.

        A graph reads the tensors its program closed over at capture, so
        the graphs belong to a plane, a predictor over copies of the
        donor's weights (made here, and adopted by the donor too, when the
        donor serves through none yet); each run binds the caller's
        weights and stats into the plane's slot first.  The compatibility
        this needs is checked loudly here and in
        ``FusedRolledEngine.adopt_executables``.

        On a mesh above one rank: a mesh predictor shares only a plane of
        its own mesh.  A one-device predictor over a mesh donor (the
        fleet's template) serves through the one-device plane kept beside
        it, which the first such predictor makes from itself, so the
        one-device tenants share one plane and none of them serves
        through the mesh's programs."""
        if not isinstance(donor, Predictor):
            raise TypeError(
                f"can only share executables between Predictors, got "
                f"{type(donor).__name__}")
        if donor is self:
            return
        if _spans_ranks(self) and donor.mesh is not self.mesh:
            raise ValueError(
                "a predictor on a mesh above one rank shares executables "
                "only with a plane of its own mesh (the fleet's default "
                "tenant); every other tenant is a one-device predictor")
        if _spans_ranks(donor) and not _spans_ranks(self):
            template = donor._plane or donor
            if template._device_plane is None:
                self._check_architecture(donor)
                template._device_plane = self._new_plane()
            donor = template._device_plane
        self._check_architecture(donor)
        if self.device != donor.device or (
                self.graphs.captured != donor.graphs.captured):
            raise ValueError(
                "cannot share executables across devices or graph modes "
                f"({self.device}, captured={self.graphs.captured} vs "
                f"{donor.device}, captured={donor.graphs.captured})")
        mine, theirs = self.bound_state(), donor.bound_state()
        if ({k: (tuple(v.shape), v.dtype) for k, v in mine.items()}
                != {k: (tuple(v.shape), v.dtype) for k, v in theirs.items()}):
            raise ValueError(
                "cannot share fused executables: params tree structures "
                "differ (a different tree re-traces a new executable)")
        plane = donor._plane
        if plane is None:
            plane = donor._new_plane()
            donor._adopt_plane(plane)
        if self._plane is not plane:
            self._adopt_plane(plane)

    def _check_architecture(self, donor: "Predictor") -> None:
        """Raise unless ``donor``'s programs compute this predictor's:
        the architecture, quant mode, window, ladder, sparse feed and the
        fused engine's geometry."""
        if self.model_config != donor.model_config:
            raise ValueError(
                "cannot share executables across architectures: "
                f"{self.model_config} != {donor.model_config}")
        if self.quant != donor.quant:
            raise ValueError(
                f"cannot share executables across quant modes "
                f"({self.quant!r} vs {donor.quant!r}): the params tree "
                "leaf dtypes differ, which re-traces per mode")
        if self.window_size != donor.window_size:
            raise ValueError(
                f"cannot share executables across window sizes "
                f"({self.window_size} vs {donor.window_size})")
        if self.ladder.ladder != donor.ladder.ladder:
            raise ValueError(
                f"cannot share executables across shape ladders "
                f"({self.ladder.ladder} vs {donor.ladder.ladder})")
        if (self.sparse_feed, self.sparse_nnz_cap) != (
                donor.sparse_feed, donor.sparse_nnz_cap):
            raise ValueError(
                "cannot share executables across sparse-feed settings")
        if (self._fused is None) != (donor._fused is None):
            raise ValueError(
                "cannot share executables between a fused and an unfused "
                "predictor")
        if self._fused is not None:
            self._fused.check_adoptable(donor._fused)

    @property
    def device_plane(self) -> "Predictor | None":
        """A mesh template's one-device plane (its one-device tenants'),
        or None."""
        return self._device_plane

    @property
    def plane(self) -> "Predictor | None":
        """The plane whose graphs this predictor serves through (itself for
        a plane), or None outside a fleet."""
        return self._plane

    def params_digest(self) -> str:
        """Stable fingerprint of the served params — the ``params_hash``
        half of the capacity-surface cache key (serve/surface.py): sha1
        over the stored leaves in the JAX package's flatten order (sorted
        names; a ``QuantTensor``'s data, then its scale) and stored dtypes,
        after the quant mode when it is not "off", so it equals the JAX
        ``Predictor``'s on the same checkpoint and mode.  Computed once per
        predictor (one readback of every leaf) and cached.  On a sharded
        mesh the leaves are gathered whole first (a collective: every rank
        calls it; a ``QuantTensor``'s scale along every sharded dimension
        but its contraction one, which it does not have), so the digest is
        the one-device predictor's."""
        if self._params_digest is None:
            h = hashlib.sha1()
            if self.quant != "off":
                h.update(self.quant.encode())
            params = self.params
            if self.model.sharded:
                with torch.inference_mode():
                    params = self._gathered(params)
            for name in sorted(params):
                leaf = params[name]
                for t in (leaf if isinstance(leaf, quant_ops.QuantTensor)
                          else (leaf,)):
                    raw = t.detach().reshape(-1).view(torch.uint8)
                    h.update(raw.cpu().numpy())     # no host copy of it
            self._params_digest = h.hexdigest()[:16]
        return self._params_digest

    def _gathered(self, params: dict) -> dict:
        """The whole of each leaf of this rank's ``params`` (a
        collective, in sorted leaf order on every rank)."""
        from deeprest_tpu_torch.models.qrnn import param_shapes
        from deeprest_tpu_torch.parallel.sharding import gather_leaf, spec_of

        shapes = param_shapes(self.model_config)
        out = {}
        for name in sorted(params):
            leaf, shape = params[name], shapes[name]
            spec = spec_of(name, shape)
            if isinstance(leaf, quant_ops.QuantTensor):
                k = len(shape) - 2
                whole_k = tuple(None if d == k else a
                                for d, a in enumerate(spec))
                out[name] = quant_ops.QuantTensor(
                    gather_leaf(self.mesh, leaf.data, spec),
                    gather_leaf(self.mesh, leaf.scale, whole_k))
            else:
                out[name] = gather_leaf(self.mesh, leaf, spec)
        return out

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
                        cuda_graphs: bool = True,
                        mesh_config=None,
                        mesh=None) -> "Predictor":
        """Restore params and host state from a ``deeprest-sharded-v1``
        checkpoint; the architecture comes from the sidecar's
        ``model_config`` with ``feature_dim`` and ``num_metrics`` taken from
        the sidecar's data fields, as the JAX trainer sets them.

        ``mesh_config`` (a ``MeshConfig`` or None) lays the serving mesh
        under the params (``parallel.make_mesh`` on ``device``; in a job
        every rank calls this): each rank reads only its boxes of them,
        placed by the rule table training places them with, from a
        checkpoint saved on any mesh.  ``mesh`` (a live ``Mesh``, instead
        of ``mesh_config``) places them on it: a served mesh's reload
        reuses the mesh it serves on.  In a job of more than one rank,
        rank 0 alone picks the step (``step`` None: the newest) and reads
        the stored parity budget, and a read that fails on any rank raises
        on every rank (``FileNotFoundError`` on the ranks whose own read
        succeeded) before any collective.

        ``quant``: the first load at a mode measures the parity envelope
        and writes it next to the checkpoint (``quant_parity_<mode>.json``,
        the JAX package's file; on a mesh rank 0 alone writes it); every
        later load re-measures and is gated by the stored budget."""
        from deeprest_tpu_torch.parallel.mesh import make_mesh
        from deeprest_tpu_torch.parallel.sharding import box_reader
        from deeprest_tpu_torch.train.checkpoint import (
            latest_step, load_params, load_sidecar,
        )

        if mesh is not None and mesh_config is not None:
            raise ValueError("pass a mesh or a mesh_config, not both")
        if mesh_config is not None:
            mesh = make_mesh(mesh_config, device)
        job = mesh is not None and mesh.group is not None and mesh.size > 1
        chief = not job or mesh.rank == 0
        env_path = cls._quant_envelope_path(directory, quant)
        head = None
        if chief:
            if step is None:
                step = latest_step(directory)
            head = {"step": step, "budget": None}
            if quant != "off" and os.path.exists(env_path):
                with open(env_path, encoding="utf-8") as fh:
                    head["budget"] = json.load(fh)
        if job:
            head = broadcast_json(mesh, head)
        step, quant_budget = head["step"], head["budget"]
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
        failure = None
        try:
            extra = load_sidecar(directory, step)
            params = load_params(directory, step, box_of=box_reader(mesh))
        except Exception as exc:
            failure = exc
        if job and not agree(mesh, failure is None) and failure is None:
            failure = FileNotFoundError(
                f"checkpoint step {step} under {directory!r} failed to "
                "load on another rank of the mesh")
        if failure is not None:
            raise failure
        if "model_config" not in extra:
            raise ValueError(f"checkpoint {directory!r} predates sidecar "
                             "model configs; the port cannot serve it")
        mc = dict(extra["model_config"])
        mc["quantiles"] = tuple(mc.get("quantiles", ()))
        metric_names = extra["metric_names"]
        model_config = dataclasses.replace(
            ModelConfig(**mc), feature_dim=extra["feature_dim"],
            num_metrics=len(metric_names))
        predictor = cls(
            params=params,
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
            device=device, recurrence=recurrence, cuda_graphs=cuda_graphs,
            mesh=mesh)
        predictor.step = step
        if quant != "off" and quant_budget is None and chief:
            with open(env_path, "w", encoding="utf-8") as fh:
                json.dump({"step": step, **predictor.parity_envelope},
                          fh, indent=2, sort_keys=True)
        return predictor
