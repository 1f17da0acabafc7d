"""The training and evaluation loop (``deeprest_tpu/train/trainer.py``).

The normalized base series are staged on the device once
(``stage_dataset``).  Each epoch draws its shuffled batch plan, the JAX
trainer's ``[C, S, B]`` superstep chunks with the trailing chunk padded by
zero-weight steps, and stages it on the device once (``graphs.EpochPlan``).
An optimizer update gathers its windows by start index, runs the model with
seeded dropout, the pinball loss with zero-weight padding of the ragged last
batch, the backward (the recurrence's backward is the CUDA kernel
``csrc/gru_bwd.cu`` on a GPU) and Adam with optax's defaults, updating the
state in place where the JAX step donates and returns it.

Supersteps (``steps_per_superstep``): on a CUDA device with S > 1 the run's
first update runs eagerly and is then captured as a CUDA graph
(``graphs.capture_update``), which every later update replays: no host work
per step but the replay and a host-side dropout offset.  The host knows
each chunk's real step count, so it replays only real updates where JAX
scans the padded chunk and skips the padding with ``lax.cond``.  S = 1 and
the CPU run the same update code eagerly.  Losses stay on the device and
are read back once per epoch, or per superstep when it passes a
``log_every_steps`` boundary.

Gradient accumulation (``grad_accum_windows`` G, ``grad_accum_mode``):
one update consumes G microbatches, "loop" accumulating G backward passes,
"exact" folding the feature mask once and pushing each microbatch's
cotangent through the fold in microbatch order (bit-identical to "loop"),
"flat" running the G batches as ``[G·B]`` rows through the model's group
axis.  A partly padded group keeps its zero-weight microbatches, whose
``pinball_loss(allow_empty=True)`` gradients are exactly zero.  The step
counter counts real microbatches, Adam's count updates.

Dropout is a pure function of ``(seed, step, microbatch)``: on the CPU a
generator seeded per microbatch, on a GPU one Philox generator per trainer
whose offset is set from the step before each update, eager or replayed.

Snapshots and resume (``snapshot_every_steps``): at the first superstep
boundary at or past the cadence (never at an epoch's last step) and at
every epoch's end, the full state and the epoch-plan cursor go to disk;
``resume_training`` restores params, Adam's moments and count, the step
and the cursor (from a checkpoint either package wrote), replays the plan
from the cursor and continues as the uninterrupted run would.

Evaluation keeps the reference's semantics: every ``eval_stride``-th test
window, capped at ``eval_max_cycles``, median-quantile predictions floored
at 1e-6 before de-normalization, delta columns integrated back to levels,
absolute errors pooled into the MAE report.

The sparse feed (``TrainConfig.sparse_feed``) stages padded-COO traffic
rows instead of the dense base; each gather densifies and normalizes on
the device, so losses equal the dense feed's bit for bit.

The host-streamed feed (``device_data="off"``, or "auto" over
``device_data_max_bytes``, or a bundle with no base series) sends each
step's windows from the host into static device buffers
(``graphs.HostFeed``, a ring of pinned slots on a copy stream) that the
same update reads, eager or replayed: losses and params equal the staged
feed's bit for bit.  As on the JAX trainer's host path, its cursor,
``on_step`` and snapshots move every step, and it takes neither gradient
accumulation nor a sparse bundle.

Data parallelism (``mesh``, parallel/): one rank a device, every rank
drawing the same global plan and keeping its slice of each batch
(``parallel.stage_plan``).  The pinball loss divides by the GLOBAL batch's
weight sum, staged with the plan, so each rank's loss is its share of the
global loss (the zero-weight rows that pad a ragged batch all land on the
last ranks) and one SUM all-reduce of the gradients and losses an update,
after the backward of its G microbatches and before Adam, leaves every
rank with the global gradients: the params stay bit-equal across ranks.
Dropout draws the global batch's mask and keeps the rank's rows.  The
all-reduce is captured with the update under NCCL; gloo runs eagerly, and
a captured superstep under gloo raises.  Without a process group nothing
is reduced.

The expert and model axes (``parallel/sharding.py``): each rank holds its
box of every leaf and of Adam's moments, and the model runs the mesh's
collectives (models/qrnn.py).  An expert rank's loss covers its experts'
target columns over the GLOBAL metric count, a share of the global loss;
the model ranks compute the same loss.  So the gradients come out whole
on each rank up to the data axis: the one flat bucket is all-reduced over
the data group, and the losses over the data and expert groups.
Evaluation and prediction all-gather the expert axis, so every rank holds
``[..., E, Q]``; checkpoints are written per shard by every rank
(train/checkpoint.py), log lines come from rank 0.

Elastic remeshing (``TrainConfig.elastic``): a ``fit`` or
``resume_training`` survives the loss of ranks in-process.  A probe right
after each dispatch (``_fault_check``: a superstep chunk or an
accumulation group is the unit that fails) raises the injector's loss
before any bookkeeping; a collective whose peer died raises on its own.
The barrier (``_run_epochs_elastic``) catches the device-loss family
(``parallel.is_device_loss``), and outside the ``except`` block
``_handle_device_loss`` runs the legs: DETECT (the injector's tail drop,
or the census of the ranks that still answer, ``parallel/elastic.py``),
REBUILD (``shrink_mesh_config``: the data axis first; the old job's
groups torn down, the survivors renumbered into a smaller job,
``parallel/distributed.py::rejoin``, and everything derived from the mesh
rebuilt), RESTORE (the newest cursor snapshot onto the new mesh, or a
fresh init before the first one) and RESUME (the epoch loop re-entered
at the cursor).  The run that follows is the run ``resume_training`` on
the same shrunk job gives from the same snapshot, bit for bit.  A rank the
loss removed leaves ``fit`` with ``DeviceLossError``; a healthy rank the
shrunk mesh leaves out (5 survivors of data=8 give data=4) stands down:
its ``fit`` returns ``(None, [])`` and ``stood_down`` is True.  The
losses recovered from are bounded by ``remesh_max_attempts``
(``RemeshExhaustedError``); fewer than ``expert·model`` survivors raise
``NoValidMeshError``.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.distributed as dist

from deeprest_tpu_torch.config import Config
from deeprest_tpu_torch.graphs import CapturedGraph
from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans
from deeprest_tpu_torch.models.qrnn import (
    MASK_PARAM_NAMES, MASKED_PARAM_NAMES, QuantileGRU, fold_feature_mask,
    init_params,
)
from deeprest_tpu_torch.ops.gru import Recurrence
from deeprest_tpu_torch.ops.quantile import pinball_loss
from deeprest_tpu_torch.parallel.distributed import (
    current_job, process_batch_slice, rejoin, stage_plan, teardown,
)
from deeprest_tpu_torch.parallel.elastic import (
    DeviceLossError, FaultInjector, RemeshExhaustedError, enumerate_healthy,
    is_device_loss,
)
from deeprest_tpu_torch.parallel.mesh import (
    Mesh, NoValidMeshError, make_mesh, mesh_config_of, shrink_mesh_config,
)
from deeprest_tpu_torch.train.data import DatasetBundle, eval_window_indices
from deeprest_tpu_torch.train.graphs import (
    EpochPlan, HostFeed, capture_update,
)
from deeprest_tpu_torch.train.metrics import Throughput, mae_report

# Philox offsets between the dropout streams of two consecutive steps: far
# above what one update draws (a multiple of 4, as the CUDA generator needs).
DROPOUT_OFFSET_STRIDE = 1 << 20


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the Adam optimizer over them, the count
    of real train steps (microbatches) taken, and the superstep machinery
    bound to this state's tensors: the staged epoch plan, the captured
    update that reads it, and the last update graph dropped, which never
    replays again and lends its memory pool to the next capture."""

    step: int
    model: QuantileGRU
    optimizer: torch.optim.Adam
    plan: EpochPlan | None = None
    graph: CapturedGraph | None = None
    retired: CapturedGraph | None = None

    def retire_graph(self) -> None:
        if self.graph is not None:
            self.retired, self.graph = self.graph, None

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return self.model.params()


@dataclasses.dataclass
class EpochResult:
    epoch: int
    train_loss: float
    test_loss: float | None
    report: dict | None


def dropout_generator(device: torch.device, seed: int,
                      step: int) -> torch.Generator:
    """The CPU dropout stream of one train step (microbatch), seeded from
    ``(seed, step)``: the counterpart of the JAX trainer's ``fold_in(rng,
    step)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return gen


def _same_device(asked, device: torch.device) -> bool:
    """Whether ``asked`` names ``device`` ("cuda" names any card)."""
    asked = torch.device(asked)
    return asked.type == device.type and asked.index in (None, device.index)


def _same_series(held, staged) -> bool:
    """Whether a plan bound to ``held`` may keep its captured update for
    ``staged``: the same staged tensors, or the same host feed."""
    if isinstance(held, tuple) and isinstance(staged, tuple):
        return all(a is b for a, b in zip(held, staged))
    return held is not None and held is staged


class Trainer:
    """Owns the model config, the device and the training loop.

    ``recurrence`` replaces the device dispatch of the GRU recurrence (pass
    ``ops.cuda_gru.gru_recurrence_reference`` to train through the plain
    version on a CUDA device, differentiated by torch autograd).

    ``mesh`` (``parallel.make_mesh``) is this rank's mesh; None builds it
    from ``config.mesh`` on ``device``: without a process group, the
    one-process mesh, which reduces nothing.

    Counters: ``dispatches`` (optimizer updates run: graph replays plus
    eager updates), ``captures`` (CUDA graphs captured), ``replays`` and
    ``capture_seconds`` (host seconds spent capturing).
    """

    def __init__(self, config: Config, feature_dim: int,
                 metric_names: list[str], device=None,
                 recurrence: Recurrence | None = None,
                 mesh: Mesh | None = None):
        self.config = config
        self.metric_names = list(metric_names)
        self.model_config = dataclasses.replace(
            config.model, feature_dim=feature_dim,
            num_metrics=len(metric_names))
        if mesh is None:
            mesh = make_mesh(config.mesh, device)
        elif device is not None and not _same_device(device, mesh.device):
            raise ValueError(f"device {str(device)!r} is not the mesh's "
                             f"device {str(mesh.device)!r}")
        self.device = mesh.device
        # elastic remeshing (the fault barrier's legs and their record)
        self._fault_injector: FaultInjector | None = None
        self._remesh_in_flight = False
        self.remesh_count = 0
        self.last_remesh: dict | None = None
        self.remesh_history: list[dict] = []
        self.stood_down = False
        self._m_device_losses = obs_metrics.REGISTRY.counter(
            "deeprest_train_device_losses_total",
            "device-loss events caught by the elastic fault barrier")
        self._m_remeshes = obs_metrics.REGISTRY.counter(
            "deeprest_train_remeshes_total",
            "elastic remesh outcomes", labelnames=("outcome",))
        self._m_mesh_devices = obs_metrics.REGISTRY.gauge(
            "deeprest_train_mesh_devices",
            "devices in the trainer's current mesh")
        self._m_recovery = obs_metrics.REGISTRY.gauge(
            "deeprest_train_remesh_recovery_seconds",
            "wall seconds of the last remesh recovery "
            "(detect through restore)")
        self._bind_mesh(mesh)
        self.recurrence = recurrence
        self.throughput = Throughput(device=self.device)
        self._warmed = False       # first update (kernel build, capture) excluded
        self._global_step = 0
        # per-step losses of the most recent train_epoch (np [K])
        self._last_epoch_losses: np.ndarray | None = None
        self._quantiles = torch.tensor(self.model_config.quantiles,
                                       dtype=torch.float32, device=self.device)
        self._window_offsets = torch.arange(config.train.window_size,
                                            device=self.device)
        self._generator = None
        # the one side stream of every eager first update and capture: the
        # caching allocator keeps freed blocks per stream, so a new stream
        # per capture would strand an update's working memory each time
        self._side_stream = None
        if self.device.type == "cuda":
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(config.train.seed)
        self.dispatches = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0
        self.superstep_len: int | None = None     # S of the latest epoch
        self.feed: str | None = None     # "staged", "sparse" or "host"
        self.resumed_from_step: int | None = None
        # the epoch-plan cursor of preemption-safe snapshots
        self._snapshot_dir: str | None = None
        self._snapshot_every = 0
        self._snapshot_extra_fn = None
        self._steps_since_snapshot = 0
        self._cursor_epoch: int | None = None
        self._cursor_rng_state: dict | None = None
        self._epoch_steps_done = 0
        self._epoch_num_steps = 0

    def _bind_mesh(self, mesh: Mesh) -> None:
        """Everything derived from the mesh: this rank's rows of every
        global batch and of its dropout mask, its experts (target columns)
        and the loss's metric count, and the mesh gauge.  ``__init__`` and
        :meth:`remesh` call it."""
        config = self.config
        self.mesh = mesh
        bs, data = config.train.batch_size, mesh.config.data
        self._rows = process_batch_slice(bs, mesh.coords["data"], data)
        self._dropout_rows = (None if data == 1 else
                              (bs, self._rows.start, self._rows.stop))
        e = self.model_config.num_metrics
        self._experts = None
        self._loss_kw: dict = {}
        if mesh.config.expert > 1 or mesh.config.model > 1:
            from deeprest_tpu_torch.models.qrnn import param_shapes
            from deeprest_tpu_torch.parallel.sharding import (
                expert_feature_box, rank_box, spec_of,
            )

            # every leaf's placement first: an axis that does not divide
            # what it shards raises here, naming the leaf
            shapes = param_shapes(self.model_config)
            for name, shape in shapes.items():
                rank_box(mesh, spec_of(name, shape), shape, name)
            (lo, hi), _ = expert_feature_box(mesh, shapes["mask_w2"])
            if mesh.config.expert > 1:
                self._experts = slice(lo, hi)
                self._loss_kw = {"num_metrics": e}
        self._m_mesh_devices.set(mesh.size)

    @property
    def _dtype(self) -> torch.dtype:
        return getattr(torch, self.model_config.compute_dtype)

    @property
    def is_chief(self) -> bool:
        """Rank 0, which writes checkpoints and log lines."""
        return self.mesh.rank == 0

    @property
    def global_step(self) -> int:
        return self._global_step

    @property
    def last_epoch_losses(self) -> np.ndarray | None:
        """Per-step losses of the most recent epoch."""
        return self._last_epoch_losses

    def init_state(self, params: Mapping[str, Any] | None = None,
                   seed: int | None = None) -> TrainState:
        """A fresh state from ``params`` (a dict of arrays with the JAX
        names and shapes, e.g. a JAX-initialized tree through
        ``interop.params_from_jax``) or, without it, from
        ``models.qrnn.init_params(seed)``.  Adam with optax's defaults,
        ``capturable`` on a CUDA device, so eager and captured updates run
        the same optimizer arithmetic."""
        if params is None:
            seed = self.config.train.seed if seed is None else seed
            params = init_params(self.model_config, seed)
        model = QuantileGRU(self.model_config, device=self.device,
                            mesh=self.mesh)
        model.load_params(params)
        model.requires_grad_(True)
        opt = torch.optim.Adam(model.parameters(),
                               lr=self.config.train.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8,
                               capturable=self.device.type == "cuda")
        return TrainState(step=0, model=model, optimizer=opt)

    def restore_state(self, directory: str, step: int | None = None
                      ) -> tuple[TrainState, dict | None]:
        """The full train state of a checkpoint either package wrote, on
        any mesh: params, ``step``, Adam's moments (``opt_state/0/{mu,nu}/*``)
        and count (``opt_state/0/count``), and the sidecar.  On a mesh each
        rank reads only its boxes (``parallel.sharding.box_reader``)."""
        from deeprest_tpu_torch.parallel.sharding import box_reader
        from deeprest_tpu_torch.train.checkpoint import (
            latest_step, load_leaves, load_sidecar,
        )

        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {directory!r}")
        leaves = load_leaves(directory, step, box_of=box_reader(self.mesh))
        params = {k[len("params/"):]: v for k, v in leaves.items()
                  if k.startswith("params/")}
        state = self.init_state(params)
        count = int(leaves["opt_state/0/count"])
        if count:
            capturable = self.device.type == "cuda"
            adam_step = float(count)
            for name, p in state.model.named_parameters():
                state.optimizer.state[p] = {
                    "step": torch.tensor(
                        adam_step, dtype=torch.float32,
                        device=p.device if capturable else "cpu"),
                    "exp_avg": leaves[f"opt_state/0/mu/{name}"].to(
                        p.device, p.dtype).clone(),
                    "exp_avg_sq": leaves[f"opt_state/0/nu/{name}"].to(
                        p.device, p.dtype).clone(),
                }
        state.step = int(leaves["step"])
        return state, load_sidecar(directory, step, missing_ok=True)

    def _own(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's experts' columns of targets ``[..., E]``."""
        return y if self._experts is None else y[..., self._experts]

    def _gather_experts(self, preds: torch.Tensor) -> torch.Tensor:
        """Every expert rank's predictions ``[..., E/e, Q]`` → ``[..., E,
        Q]`` on each rank."""
        from deeprest_tpu_torch.parallel.collectives import gather_along

        return gather_along(preds, -2, self.mesh.expert_group)

    # ------------------------------------------------------------------

    def _batches(self, n: int, rng: np.random.Generator):
        """Shuffled index batches, trailing batch padded to full size with
        zero-weight duplicates (one permutation per epoch, as the JAX
        trainer draws it)."""
        bs = self.config.train.batch_size
        order = rng.permutation(n)
        for lo in range(0, n, bs):
            sel = order[lo:lo + bs]
            weight = np.ones(bs, np.float32)
            if len(sel) < bs:
                weight[len(sel):] = 0.0
                # wrap-pad (resize repeats `order` as needed, so corpora
                # smaller than the batch size still yield full batches)
                sel = np.concatenate([sel, np.resize(order, bs - len(sel))])
            yield sel, weight

    # Per-chunk plan byte cap for steps_per_superstep="auto", as the JAX
    # trainer's (8 bytes a window of a step: int32 start + f32 weight).
    _PLAN_CHUNK_MAX_BYTES = 1 << 20

    def _superstep_len(self, num_steps: int) -> int:
        """``steps_per_superstep`` resolved to S for an epoch of
        ``num_steps``: "epoch" is the whole epoch, "auto" min(epoch,
        ``log_every_steps`` or 32), ints clamp to the epoch; all under the
        plan-chunk byte cap, then rounded up to a multiple of G."""
        v = self.config.train.steps_per_superstep
        if v == "epoch":
            s = num_steps
        elif v == "auto":
            log_every = self.config.train.log_every_steps
            s = min(num_steps, log_every if log_every else 32)
        else:
            s = min(int(v), num_steps)
        cap = max(1, self._PLAN_CHUNK_MAX_BYTES
                  // (8 * self.config.train.batch_size))
        s = max(1, min(s, cap))
        g = self.config.train.grad_accum_windows
        if g > 1:
            s = -(-s // g) * g
        return s

    def _epoch_plan(self, n: int, rng: np.random.Generator,
                    s: int) -> tuple[np.ndarray, np.ndarray, int]:
        """The epoch's shuffled batch plan in superstep chunks: ``(starts
        [C, S, B] int32, weights [C, S, B] float32, num_steps)``, the
        trailing chunk padded with zero-weight steps (starts 0).  Consumes
        one ``rng.permutation``, as the per-step loop does."""
        bs = self.config.train.batch_size
        batches = list(self._batches(n, rng))
        num_steps = len(batches)
        n_chunks = -(-num_steps // s)
        starts = np.zeros((n_chunks * s, bs), np.int32)
        weights = np.zeros((n_chunks * s, bs), np.float32)
        for i, (sel, w) in enumerate(batches):
            starts[i] = sel
            weights[i] = w
        return (starts.reshape(n_chunks, s, bs),
                weights.reshape(n_chunks, s, bs), num_steps)

    def stage_dataset(self, bundle: DatasetBundle):
        """The base series on the device: ``(x_base [T, F]`` normalized in
        the compute dtype, ``y_base [T, E]`` f32), or with
        ``TrainConfig.sparse_feed`` and a sparse bundle ``(SparseBase,
        y_base)`` (:meth:`_stage_sparse`).  Train window i starts at base
        row i, test window i at ``split + i``.  None, for the host-streamed
        feed, under ``device_data="off"``, for a bundle with no base
        series, and under "auto" for a dense base over
        ``device_data_max_bytes`` (counted as the reference counts it);
        ``"always"`` stages it.  "auto" stages on the CPU too, where the
        reference host-feeds."""
        cfg = self.config.train
        if cfg.sparse_feed and bundle.is_sparse:
            return self._stage_sparse(bundle)
        if bundle.x_base is None and bundle.is_sparse:
            # A sparse-only bundle has no dense base to fall back to.
            raise ValueError(
                "bundle carries only sparse (padded-COO) traffic but "
                "TrainConfig.sparse_feed is off; enable sparse_feed or "
                "rebuild the bundle with dense traffic")
        if (cfg.device_data == "off" or bundle.x_base is None
                or bundle.y_base is None):
            return None
        dtype = self._dtype
        # Counted before the cast, as the reference counts it: x at 2 bytes
        # an element in bf16, else as it lies, plus the targets.
        x_bytes = (bundle.x_base.size * 2 if dtype == torch.bfloat16
                   else bundle.x_base.nbytes)
        total = x_bytes + bundle.y_base.nbytes
        if cfg.device_data == "auto" and total > cfg.device_data_max_bytes:
            return None
        x = torch.from_numpy(np.ascontiguousarray(bundle.x_base))
        y = torch.from_numpy(np.ascontiguousarray(bundle.y_base))
        return (x.to(self.device, dtype), y.to(self.device, torch.float32))

    def _stage_sparse(self, bundle: DatasetBundle):
        """The padded-COO traffic base and its normalization stats on the
        device: RAW ``cols``/``vals`` rows (~F/(2K) fewer bytes than the
        dense base) that each step's gather densifies and normalizes
        there (``ops/densify.py``; bit-identical to the dense feed).  There
        is no host-fed fallback, so a base over ``device_data_max_bytes``
        raises under "auto"."""
        from deeprest_tpu_torch.ops.densify import SparseBase

        cfg = self.config.train
        if bundle.y_base is None:
            raise ValueError("sparse bundle lacks y_base; the targets "
                             "stay dense and must be stageable")
        total = (bundle.x_cols.nbytes + bundle.x_vals.nbytes
                 + bundle.y_base.nbytes)
        if cfg.device_data == "auto" and total > cfg.device_data_max_bytes:
            raise ValueError(
                f"sparse base ({total} bytes) exceeds "
                f"device_data_max_bytes ({cfg.device_data_max_bytes}); "
                "there is no host-feed fallback for the sparse form — "
                "raise the budget or shrink history_max/nnz_cap")

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                self.device)

        x_stats = bundle.x_stats
        base = SparseBase(
            cols=dev(bundle.x_cols, np.int32),
            vals=dev(bundle.x_vals, np.float32),
            mn=dev(np.asarray(x_stats.min, np.float32).reshape(-1),
                   np.float32),
            rg=dev(np.asarray(x_stats.range, np.float32).reshape(-1),
                   np.float32),
            capacity=int(bundle.sparse_capacity or bundle.feature_dim))
        return base, dev(bundle.y_base, np.float32)

    def _gather(self, staged, starts: torch.Tensor):
        """``[n, W, F]`` inputs and ``[n, W, E]`` targets of the windows
        starting at ``starts`` (a device tensor) in the staged series; a
        sparse base gathers ``[n, W, K]`` rows and densifies and
        normalizes them on the device (inside a captured update too: the
        dense windows come from the graph's pool)."""
        from deeprest_tpu_torch.ops.densify import (
            SparseBase, gather_densify_normalize,
        )

        if isinstance(staged, HostFeed):
            return staged.x[0], staged.y[0]
        x_base, y_base = staged
        idx = starts[:, None] + self._window_offsets[None, :]
        if isinstance(x_base, SparseBase):
            return gather_densify_normalize(x_base, idx), y_base[idx]
        return x_base[idx], y_base[idx]

    def _windows(self, staged, starts: np.ndarray):
        return self._gather(staged, torch.from_numpy(
            np.asarray(starts, np.int64)).to(self.device))

    def _dropout(self, step: int, g: int) -> torch.Generator:
        """The dropout stream of microbatch ``g`` of the update at
        ``step``: a fresh CPU generator, or the trainer's GPU generator
        (its offset set from the step by :meth:`_set_dropout_offset`, the
        microbatches drawing from it in order)."""
        if self._generator is None:
            return dropout_generator(self.device, self.config.train.seed,
                                     step + g)
        return self._generator

    def _set_dropout_offset(self, step: int) -> None:
        if self._generator is not None:
            self._generator.set_offset(step * DROPOUT_OFFSET_STRIDE)

    def _update(self, state: TrainState, staged, starts: torch.Tensor,
                weights: torch.Tensor, den: torch.Tensor,
                step: int) -> torch.Tensor:
        """One optimizer update from the ``[G, B]`` microbatches ``starts``
        / ``weights`` (device tensors; this rank's rows) and their global
        weight sums ``den`` ``[G]``; returns their ``[G]`` f32 losses
        (global ones: all-reduced with the gradients).  Runs eagerly or
        under capture: no host sync, no host-to-device copy.  ``step``
        seeds the CPU dropout streams only."""
        g, b = starts.shape
        mode = self.config.train.grad_accum_mode if g > 1 else "loop"
        model, quantiles = state.model, self._quantiles
        rows = self._dropout_rows
        state.optimizer.zero_grad(set_to_none=True)
        if mode == "flat":
            xb, yb = self._gather(staged, starts.reshape(-1))
            preds = model(xb.reshape(g, b, *xb.shape[1:]),
                          deterministic=False, generator=self._dropout(step, 0),
                          recurrence=self.recurrence, dropout_rows=rows)
            yb = self._own(yb.reshape(g, b, *yb.shape[1:]))
            losses = torch.stack([
                pinball_loss(preds[i], yb[i], quantiles,
                             sample_weight=weights[i], allow_empty=True,
                             weight_sum=den[i], **self._loss_kw)
                for i in range(g)])
            losses.sum().backward()
        elif mode == "exact":
            losses = self._exact_grads(state, staged, starts, weights, den,
                                       step)
        else:
            losses = []
            for i in range(g):
                xb, yb = self._gather(staged, starts[i])
                preds = model(xb, deterministic=False,
                              generator=self._dropout(step, i),
                              recurrence=self.recurrence, dropout_rows=rows)
                loss = pinball_loss(preds, self._own(yb), quantiles,
                                    sample_weight=weights[i],
                                    allow_empty=g > 1, weight_sum=den[i],
                                    **self._loss_kw)
                loss.backward()
                losses.append(loss.detach())
            losses = torch.stack(losses)
        losses = self._all_reduce(state, losses.detach().float())
        state.optimizer.step()
        return losses

    def _all_reduce(self, state: TrainState,
                    losses: torch.Tensor) -> torch.Tensor:
        """Sum every rank's gradients (in place) and ``[G]`` losses over
        the mesh's data group in one flat f32 bucket, then the losses over
        the expert group; returns the global losses.  Each data (and
        expert) rank's loss is its share of the global loss, and the mesh's
        collectives leave each leaf's gradient whole up to the data axis,
        so the sum is the global gradient.  A no-op without groups."""
        data, expert = self.mesh.data_group, self.mesh.expert_group
        if data is not None:
            grads = [p.grad for p in state.model.parameters()]
            bucket = torch.cat([gr.reshape(-1) for gr in grads] + [losses])
            dist.all_reduce(bucket, op=dist.ReduceOp.SUM, group=data)
            lo = 0
            for gr in grads:
                gr.copy_(bucket[lo:lo + gr.numel()].view_as(gr))
                lo += gr.numel()
            losses = bucket[lo:]
        if expert is not None:
            dist.all_reduce(losses, op=dist.ReduceOp.SUM, group=expert)
        return losses

    def _exact_grads(self, state: TrainState, staged, starts, weights,
                     den, step: int) -> torch.Tensor:
        """"exact" accumulation: the feature mask folds into the layer-0
        input weights once; each microbatch runs forward/backward against
        the folded params, its cotangent of the folded weights goes back
        through the fold on its own, and the grads sum in microbatch order
        (the JAX trainer's ``_accum_grads_exact``).  Sets ``.grad``;
        returns the ``[G]`` losses."""
        params = state.model.params()
        folded = fold_feature_mask(params, state.model.model_group)
        # what the model reads under mask_folded: all but the mask's params
        names = [n for n in folded if n not in MASK_PARAM_NAMES]
        masked = [n for n in MASKED_PARAM_NAMES if n in folded]
        fold_params = list(MASK_PARAM_NAMES) + masked
        total: dict[str, torch.Tensor] = {}
        losses = []
        g = starts.shape[0]
        for i in range(g):
            xb, yb = self._gather(staged, starts[i])
            preds = state.model(xb, deterministic=False,
                                generator=self._dropout(step, i),
                                mask_folded=True, params=folded,
                                recurrence=self.recurrence,
                                dropout_rows=self._dropout_rows)
            loss = pinball_loss(preds, self._own(yb), self._quantiles,
                                sample_weight=weights[i], allow_empty=True,
                                weight_sum=den[i], **self._loss_kw)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [folded[n] for n in names])))
            through = torch.autograd.grad(
                [folded[n] for n in masked], [params[n] for n in fold_params],
                grad_outputs=[grads[n] for n in masked],
                retain_graph=i < g - 1)
            grads.update(zip(fold_params, through))
            for name in params:
                total[name] = (grads[name] if name not in total
                               else total[name] + grads[name])
            losses.append(loss.detach())
        for name, p in params.items():
            p.grad = total[name]
        return torch.stack(losses)

    def train_step(self, state: TrainState, staged, starts: np.ndarray,
                   weights: np.ndarray) -> torch.Tensor:
        """One eager optimizer step on the (global) batch of windows
        starting at ``starts`` with sample weights ``weights``, this rank
        taking its rows; returns the loss as a device scalar."""
        starts, weights, den = stage_plan(
            self.mesh, np.asarray(starts, np.int64)[None],
            np.asarray(weights, np.float32)[None])
        st, wt, dn = (torch.from_numpy(a).to(self.device)
                      for a in (starts, weights, den))
        self._set_dropout_offset(state.step)
        loss = self._update(state, staged, st, wt, dn, state.step)[0]
        state.step += 1
        self.dispatches += 1
        return loss

    def _stage_plan(self, state: TrainState, staged, starts: np.ndarray,
                    weights: np.ndarray, first_update: int) -> EpochPlan:
        """The epoch plan into ``state``'s static buffers, bound to the
        staged series it gathers from.  A captured update reads both at
        fixed addresses, so new buffers (a plan of another shape) or other
        staged tensors drop it, and the next update captures anew; the plan
        holds the staged tensors alive as long as a graph may read them."""
        g = self.config.train.grad_accum_windows
        starts, weights, den = stage_plan(self.mesh, starts, weights)
        shape = (starts.size // (g * starts.shape[-1]), g, starts.shape[-1])
        if state.plan is None or state.plan.shape != shape:
            state.plan = EpochPlan(*shape, device=self.device)
            state.retire_graph()
        if not _same_series(state.plan.staged, staged):
            state.plan.staged = staged
            state.retire_graph()
        state.plan.stage(starts.reshape(-1, starts.shape[-1]),
                         weights.reshape(-1, weights.shape[-1]),
                         den.reshape(-1), first_update)
        return state.plan

    def release_staged(self, state: TrainState) -> None:
        """Let go of the staged series ``state``'s plan holds before new
        ones are staged (a streaming refresh re-stages its grown corpus),
        so the card holds one staged corpus at a time; the captured update
        that reads them retires."""
        if state.plan is not None and state.plan.staged is not None:
            state.plan.staged = None
            state.retire_graph()

    def _run_update(self, state: TrainState, captured: bool) -> None:
        """The update at the plan's cursor: a replay of ``state``'s graph
        when ``captured`` and one exists, else eagerly; with ``captured``
        the eager update runs on a side stream and is then captured."""
        step = state.step
        self._set_dropout_offset(step)

        def body():
            starts, weights, den = state.plan.take()
            state.plan.put(self._update(state, state.plan.staged, starts,
                                        weights, den, step))

        self.dispatches += 1
        if captured and state.graph is not None:
            state.graph.replay()
            self.replays += 1
            return
        if not captured:
            body()
            return
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(device=self.device)
        side = self._side_stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body()
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(side)
        current.synchronize()          # the eager update stays out of the time
        sw = obs_metrics.Stopwatch()
        pool = (state.retired.graph.pool() if state.retired is not None
                else None)
        state.graph = capture_update(body, self.device, [self._generator],
                                     pool=pool, stream=side)
        state.retired = None
        self.capture_seconds += sw.elapsed()
        self.captures += 1

    def train_epoch(self, state: TrainState, bundle: DatasetBundle,
                    epoch_rng: np.random.Generator,
                    staged=None, skip_steps: int = 0,
                    on_step=None) -> tuple[TrainState, float]:
        """One epoch; returns the state and the mean of its per-step losses
        (read back once, here).

        ``skip_steps`` (resume) passes over the first real steps of the
        epoch's plan without running them (the plan is drawn as the
        uninterrupted epoch drew it); it must land on a superstep boundary.
        ``on_step(global_step)`` fires at every superstep boundary (every
        step at S = 1).  The throughput window leaves out the trainer's
        first update, which builds the kernels and captures the graph.

        Without ``staged`` the epoch stages the dataset itself, or, where
        :meth:`stage_dataset` returns None, streams it from the host
        (:meth:`_train_epoch_host`)."""
        cfg = self.config.train
        if staged is None:
            staged = self.stage_dataset(bundle)
        if staged is None:
            return self._train_epoch_host(state, bundle, epoch_rng,
                                          skip_steps, on_step)
        from deeprest_tpu_torch.ops.densify import SparseBase

        self.feed = ("sparse" if isinstance(staged[0], SparseBase)
                     else "staged")
        num_steps = -(-bundle.num_train_windows // cfg.batch_size)
        s = self._superstep_len(num_steps)
        g = cfg.grad_accum_windows
        starts, weights, num_steps = self._epoch_plan(
            bundle.num_train_windows, epoch_rng, s)
        self.superstep_len = s
        self._epoch_num_steps = num_steps
        self._epoch_steps_done = skip_steps
        if skip_steps >= num_steps:
            raise ValueError(
                f"skip_steps={skip_steps} >= epoch length {num_steps}: a "
                "finished epoch resumes at the NEXT epoch's cursor")
        if skip_steps % s:
            raise ValueError(
                f"resume cursor steps_done={skip_steps} is not a "
                f"superstep boundary (S={s}): snapshots only fire at "
                "chunk boundaries — the sidecar is inconsistent with "
                "this config's steps_per_superstep/grad_accum_windows")
        plan = self._stage_plan(state, staged, starts, weights,
                                skip_steps // g)
        captured = self._captured(s)
        log_every = cfg.log_every_steps
        measuring = self._warmed
        if measuring:
            self.throughput.start()
        steps = 0
        for c in range(skip_steps // s, starts.shape[0]):
            real = min(s, num_steps - c * s)
            for lo in range(c * s, c * s + real, g):
                self._run_update(state, captured)
                n_real = min(g, num_steps - lo)
                state.step += n_real
                if self._count_update():
                    steps += n_real
                else:
                    measuring = True
            # the fault barrier's probe, before the cursor moves: a loss
            # during this chunk's dispatches rolls back to the newest
            # durable snapshot (the chunk, an accumulation group at the
            # least, is the unit that fails)
            self._fault_check(real)
            prev = self._global_step
            self._global_step += real
            if log_every and prev // log_every != self._global_step // log_every:
                # graftlint: disable=JX003 -- designed sink: one readback per superstep, only when a log boundary passed
                vals = plan.microbatch_losses(c * s, c * s + real)
                for gs in range(prev + 1, self._global_step + 1):
                    if gs % log_every == 0 and self.is_chief:
                        print(f"step {gs}: loss {vals[gs - prev - 1]:.6f}")
            self._note_steps(state, bundle, real, on_step)
        return state, self._end_epoch(plan, skip_steps, num_steps,
                                      measuring, steps)

    def _captured(self, s: int) -> bool:
        """Whether an epoch of superstep ``s`` replays captured updates:
        S > 1 on a CUDA device.  Under gloo that raises: gloo's collectives
        cannot be captured, and the update never drops to eager quietly."""
        if self.device.type != "cuda" or s == 1:
            return False
        if self.mesh.backend == "gloo":
            raise ValueError(
                f"steps_per_superstep resolves to {s} on a CUDA device, "
                "which captures the update, all-reduce included, in a CUDA "
                "graph: gloo's collectives cannot be captured; use NCCL, or "
                "steps_per_superstep=1 for eager updates under gloo")
        return True

    def _end_epoch(self, plan: EpochPlan, skip_steps: int, num_steps: int,
                   measuring: bool, steps: int) -> float:
        """Close the throughput window and read the epoch's losses back
        (once); returns their mean."""
        if measuring:
            self.throughput.stop(steps)
        epoch_losses = plan.microbatch_losses(skip_steps, num_steps)
        self._last_epoch_losses = epoch_losses
        return float(np.mean(epoch_losses, dtype=np.float64))

    def _count_update(self) -> bool:
        """After an update: True when it falls in the throughput window;
        the trainer's first update (kernel build, capture) is waited for and
        opens the window instead."""
        if self._warmed:
            return True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warmed = True
        self.throughput.start()
        return False

    def _host_feed(self, state: TrainState,
                   bundle: DatasetBundle) -> HostFeed:
        """``state``'s host feed, kept across epochs while its shapes hold
        (a captured update reads its buffers)."""
        cfg = self.config.train
        held = state.plan.staged if state.plan is not None else None
        dims = (self._rows.stop - self._rows.start, bundle.window_size,
                bundle.feature_dim, bundle.num_metrics)
        if isinstance(held, HostFeed) and held.shape == (*dims,
                                                         self._dtype):
            return held
        return HostFeed(*dims, self._dtype, self.device, cfg.prefetch_depth)

    def _train_epoch_host(self, state: TrainState, bundle: DatasetBundle,
                          epoch_rng: np.random.Generator, skip_steps: int,
                          on_step) -> tuple[TrainState, float]:
        """One epoch on the host-streamed feed (the JAX trainer's host
        path): the same shuffled plan and zero-weight padding, each step's
        windows ``x_train[sel]`` / ``y_train[sel]`` put into the feed's
        static buffers, then the staged path's update, captured where it
        would be (S > 1 on a GPU, S only deciding that).  The cursor,
        ``on_step``, log lines and snapshots move every step, so
        ``skip_steps`` may be any step."""
        cfg = self.config.train
        if bundle.is_sparse:
            raise ValueError(
                "sparse (padded-COO) bundles train only through the "
                "staged device-resident feed — the on-device densify "
                "lives inside the staged update; call "
                "stage_dataset(bundle) with TrainConfig.sparse_feed=True")
        if cfg.grad_accum_windows > 1:
            raise ValueError(
                f"grad_accum_windows={cfg.grad_accum_windows} requires the "
                "staged (device-resident) feed — the coalesced update "
                "consumes its microbatches from the on-device plan; stage "
                "the dataset (device_data='always') or set "
                "grad_accum_windows=1")
        n = bundle.num_train_windows
        s = self._superstep_len(-(-n // cfg.batch_size))
        starts, weights, num_steps = self._epoch_plan(n, epoch_rng, s)
        self.superstep_len = s
        self._epoch_num_steps = num_steps
        self._epoch_steps_done = skip_steps
        if skip_steps >= num_steps:
            raise ValueError(
                f"skip_steps={skip_steps} >= epoch length {num_steps}: a "
                "finished epoch resumes at the NEXT epoch's cursor")
        feed = self._host_feed(state, bundle)
        self.feed = "host"
        plan = self._stage_plan(state, feed, starts, weights, skip_steps)
        selections = starts.reshape(-1, starts.shape[-1])[:, self._rows]
        captured = self._captured(s)
        log_every = cfg.log_every_steps
        measuring = self._warmed
        if measuring:
            self.throughput.start()
        steps = 0
        try:
            for i in range(skip_steps, num_steps):
                feed.put(bundle.x_train, bundle.y_train, selections[i])
                self._run_update(state, captured)
                state.step += 1
                if self._count_update():
                    steps += 1
                else:
                    measuring = True
                self._fault_check(1)
                self._global_step += 1
                if log_every and self._global_step % log_every == 0 \
                        and self.is_chief:
                    # graftlint: disable=JX003 -- designed sink: one scalar readback per log_every steps, the logging contract
                    loss = plan.microbatch_losses(i, i + 1)[0]
                    print(f"step {self._global_step}: loss {loss:.6f}")
                self._note_steps(state, bundle, 1, on_step)
        finally:
            feed.close()
        return state, self._end_epoch(plan, skip_steps, num_steps,
                                      measuring, steps)

    # -- preemption-safe snapshots -----------------------------------------

    def enable_snapshots(self, directory: str, every_steps: int,
                         extra_fn=None) -> None:
        """Cursor snapshots every ``every_steps`` real steps (at the first
        superstep boundary at or past the cadence): the full state and the
        epoch-plan cursor (epoch, steps done in it, the shuffle rng's state
        at the epoch's start, global step), written atomically.
        ``extra_fn`` (optional) supplies extra sidecar keys per snapshot
        (the streaming trainer's refresh counter, stats union and ring
        watermarks, so a mid-refresh snapshot is a stream-resume point)."""
        if every_steps < 1:
            raise ValueError(
                f"enable_snapshots(every_steps={every_steps}): must be "
                ">= 1 (leave snapshots unconfigured to disable)")
        self._snapshot_dir = directory
        self._snapshot_every = int(every_steps)
        self._snapshot_extra_fn = extra_fn
        self._steps_since_snapshot = 0

    def _begin_epoch_cursor(self, epoch: int,
                            data_rng: np.random.Generator) -> None:
        """Pin the cursor of one epoch: its index and the rng state before
        the epoch plan draws its permutation."""
        self._cursor_epoch = epoch
        self._cursor_rng_state = copy.deepcopy(data_rng.bit_generator.state)
        self._epoch_steps_done = 0

    def _note_steps(self, state: TrainState, bundle: DatasetBundle,
                    n: int, on_step=None) -> None:
        """Advance the cursor by ``n`` real steps; snapshot when the
        cadence is due, never at the epoch's last step (the epoch-end
        snapshot covers it)."""
        self._epoch_steps_done += n
        if self._snapshot_every:
            self._steps_since_snapshot += n
            if (self._steps_since_snapshot >= self._snapshot_every
                    and self._epoch_steps_done < self._epoch_num_steps):
                self.snapshot(state, bundle)
        if on_step is not None:
            on_step(self._global_step)

    def snapshot(self, state: TrainState, bundle: DatasetBundle) -> str:
        """One atomic cursor snapshot, then retention of the newest
        ``snapshot_keep`` (see :meth:`enable_snapshots`)."""
        if self._snapshot_dir is None:
            raise RuntimeError("snapshots not enabled (enable_snapshots)")
        extra = (dict(self._snapshot_extra_fn())
                 if self._snapshot_extra_fn is not None else {})
        extra["train_cursor"] = {
            "epoch": self._cursor_epoch,
            "steps_done": int(self._epoch_steps_done),
            "rng_state": self._cursor_rng_state,
            "global_step": int(self._global_step),
        }
        self._steps_since_snapshot = 0
        path = self.save(self._snapshot_dir, state, bundle,
                         extra_host_state=extra)
        keep = self.config.train.snapshot_keep
        if keep and self.is_chief:
            from deeprest_tpu_torch.train.checkpoint import (
                prune_cursor_snapshots,
            )

            prune_cursor_snapshots(self._snapshot_dir, keep)
        return path

    # -- elastic remeshing ----------------------------------------------

    def install_fault_injector(self, injector: FaultInjector) -> None:
        """Arm the deterministic synthetic device-loss injector (every rank
        of a job installs the same one).  Without it the detect signal is a
        collective that fails because a peer is gone."""
        self._fault_injector = injector

    def _fault_check(self, n: int) -> None:
        """Probe the injector right after a dispatch covering the next
        ``n`` global steps, before any cursor, snapshot or log bookkeeping,
        so a loss rolls back to the newest durable snapshot as a dispatch
        that failed on the device would."""
        if self._fault_injector is not None:
            self._fault_injector.note_steps(self._global_step, n)

    @property
    def remesh_in_flight(self) -> bool:
        """True while the fault barrier rebuilds and restores: the
        streaming trainer defers refresh decisions (never drops them)
        while this holds."""
        return self._remesh_in_flight

    def remesh(self, attempt: int = 1, reason: str = "") -> int:
        """The DETECT and REBUILD legs: tear down the job's groups, find the
        surviving ranks (the injector's tail drop, or the census of
        :func:`parallel.enumerate_healthy`), shrink the mesh over them
        (data axis first, expert and model kept), join the survivors the
        new mesh takes into a smaller job and rebuild everything derived
        from the mesh.  Returns the healthy rank count.

        Raises :class:`NoValidMeshError` (counted) when fewer than
        ``expert * model`` ranks survive, and :class:`DeviceLossError` on
        a rank that is itself lost.  A healthy rank the new mesh leaves out
        sets :attr:`stood_down` and takes no part in the new job."""
        mesh = self.mesh
        with obs_spans.RECORDER.span("elastic.detect",
                                     component="deeprest-elastic") as sp:
            job = current_job() if mesh.group is not None else None
            if job is not None:
                # first, so a peer blocked on one of our groups fails over
                # at once instead of at its timeout
                teardown()
            if self._fault_injector is not None:
                healthy = self._fault_injector.healthy(list(range(mesh.size)))
            else:
                healthy = enumerate_healthy(self.device)
            sp.tag(attempt=attempt, reason=reason[:200], devices=mesh.size,
                   healthy=len(healthy))
        backoff_s = self.config.train.remesh_backoff_ms / 1e3 * attempt
        if backoff_s:
            time.sleep(backoff_s)
        with obs_spans.RECORDER.span("elastic.rebuild",
                                     component="deeprest-elastic") as sp:
            try:
                cfg = shrink_mesh_config(mesh_config_of(mesh), len(healthy))
            except NoValidMeshError:
                self._m_remeshes.inc(outcome="no_valid_mesh")
                raise
            if mesh.rank not in healthy:
                raise DeviceLossError(
                    f"rank {mesh.rank} of {mesh.size} was lost "
                    f"({reason[:200]}); the survivors {healthy} go on "
                    "without it", lost=mesh.size - len(healthy))
            survivors = healthy[:cfg.size]
            if mesh.rank not in survivors:
                self.stood_down = True
                sp.tag(stood_down=True)
                return len(healthy)
            if job is not None:
                rejoin(survivors, job.generation + 1)
            self._bind_mesh(make_mesh(cfg, self.device))
            sp.tag(mesh=f"{cfg.data}x{cfg.expert}x{cfg.model}")
        return len(healthy)

    def _handle_device_loss(self, bundle: DatasetBundle, directory: str,
                            attempt: int, reason: str):
        """The remesh handler the fault barrier routes every caught device
        loss to: rebuild the mesh over the survivors, restore the newest
        cursor snapshot onto it in-process and return the resume
        coordinates ``resume_training`` would compute in a fresh job on the
        same mesh, ``(state, data_rng, start_epoch, skip_steps)``; None on
        a rank that stood down."""
        from deeprest_tpu_torch.train.checkpoint import latest_cursor_step

        sw = obs_metrics.Stopwatch()
        self._remesh_in_flight = True
        try:
            self._m_device_losses.inc()
            self.remesh(attempt=attempt, reason=reason)
            if self.stood_down:
                return None
            seed = self.config.train.seed
            with obs_spans.RECORDER.span(
                    "elastic.restore", component="deeprest-elastic") as sp:
                step = latest_cursor_step(directory)
                data_rng = np.random.default_rng(seed)
                if step is None:
                    # lost before the first durable snapshot: nothing to
                    # restore, so a fresh init on the new mesh, what a
                    # restarted job would be forced to do
                    state = self.init_state()
                    start_epoch = skip_steps = 0
                    self._global_step = 0
                else:
                    state, extra = self.restore_state(directory, step)
                    cursor = extra["train_cursor"]
                    self._global_step = int(cursor["global_step"])
                    data_rng.bit_generator.state = cursor["rng_state"]
                    start_epoch = int(cursor["epoch"])
                    skip_steps = int(cursor["steps_done"])
                sp.tag(restored_step=step, epoch=start_epoch,
                       skip_steps=skip_steps)
            self._steps_since_snapshot = 0
            recovery_s = sw.elapsed()
            self._record_remesh(attempt, step, recovery_s)
            with obs_spans.RECORDER.span(
                    "elastic.resume", component="deeprest-elastic") as sp:
                # the resume leg proper is the re-entered epoch loop;
                # this span marks the handoff
                sp.tag(global_step=self._global_step,
                       recovery_s=round(recovery_s, 4))
            return state, data_rng, start_epoch, skip_steps
        finally:
            self._remesh_in_flight = False

    def _record_remesh(self, attempt: int, restored_step: int | None,
                       recovery_s: float) -> None:
        """Count a finished recovery and keep its record."""
        self.remesh_count += 1
        self.last_remesh = {"attempt": attempt,
                            "restored_step": restored_step,
                            "mesh": dict(self.mesh.shape),
                            "recovery_s": recovery_s}
        self.remesh_history.append(self.last_remesh)
        self._m_recovery.set(recovery_s)
        self._m_remeshes.inc(outcome="ok")

    @staticmethod
    def _drop_device_state(state: TrainState | None) -> None:
        """Let go of what a failed state holds on the device: its captured
        updates (under NCCL a capture holds the old communicator, so none
        may replay after a remesh) and its staged plan and series."""
        if state is not None:
            state.graph = state.retired = None
            state.plan = None

    def _run_epochs_elastic(self, bundle, state, data_rng, start_epoch,
                            skip_steps, baseline_preds, on_epoch,
                            num_epochs, on_step):
        """THE fault barrier: run the epochs; on a device loss, remesh and
        restore in-process and go on, bounded by ``remesh_max_attempts``,
        each rebuild after a backoff.  A rank that stood down returns
        ``(None, [])``."""
        cfg = self.config.train
        directory = self._snapshot_dir or cfg.checkpoint_dir
        if not directory or not cfg.snapshot_every_steps:
            raise ValueError(
                "TrainConfig.elastic=True requires cursor snapshots: set "
                "checkpoint_dir and snapshot_every_steps >= 1 (the "
                "remesh barrier restores from the newest one)")
        attempts = 0
        while True:
            reason = None
            try:
                return self._run_epochs(bundle, state, data_rng,
                                        start_epoch, skip_steps,
                                        baseline_preds, on_epoch,
                                        num_epochs, on_step)
            except Exception as exc:
                if not is_device_loss(exc):
                    raise
                attempts += 1
                if attempts > cfg.remesh_max_attempts:
                    self._m_remeshes.inc(outcome="exhausted")
                    raise RemeshExhaustedError(
                        f"device loss #{attempts} exceeds "
                        f"remesh_max_attempts={cfg.remesh_max_attempts}; "
                        "surfacing the failure instead of respinning"
                    ) from exc
                reason = f"{type(exc).__name__}: {exc}"
            # Recovery runs OUTSIDE the except block: the traceback pins
            # the failed epoch loop's frames (its staged feed, the old
            # mesh's groups) alive; leaving the handler first frees them
            # before the teardown and the re-staging.
            self._drop_device_state(state)
            state = None
            resumed = self._handle_device_loss(bundle, directory, attempts,
                                               reason)
            if resumed is None:
                return None, []
            state, data_rng, start_epoch, skip_steps = resumed

    # ------------------------------------------------------------------

    def evaluate(self, state: TrainState, bundle: DatasetBundle,
                 baseline_preds: Mapping[str, np.ndarray] | None = None,
                 staged=None) -> tuple[float, dict]:
        """Reference-semantics eval: strided windows, de-normalized MAE.

        ``baseline_preds`` maps method name → de-normalized ``[N_test, W,
        E]`` predictions aligned with ``bundle.x_test``.  Runs without
        autograd, so the recurrence is the inference form.  Without
        ``staged`` it stages the dataset, or, where :meth:`stage_dataset`
        returns None, pages ``x_test[sel]`` and ``y_test[sel]`` from the
        host as the reference does.
        """
        cfg = self.config.train
        if staged is None:
            staged = self.stage_dataset(bundle)
        if staged is None and bundle.is_sparse:
            raise ValueError(
                "sparse (padded-COO) bundles evaluate only through the "
                "staged device-resident feed (see train_epoch)")
        idx = eval_window_indices(bundle.num_test_windows, cfg.eval_stride,
                                  cfg.eval_max_cycles)
        if len(idx) == 0:
            raise ValueError("no eval windows: test split shorter than stride")
        preds_chunks, loss_terms = [], []
        with torch.no_grad():
            for lo in range(0, len(idx), cfg.eval_batch_size):
                sel = idx[lo:lo + cfg.eval_batch_size]
                if staged is None:
                    xb = torch.from_numpy(np.ascontiguousarray(
                        bundle.x_test[sel])).to(self.device, self._dtype)
                    yb = torch.from_numpy(np.ascontiguousarray(
                        bundle.y_test[sel])).to(self.device)
                else:
                    xb, yb = self._windows(staged, bundle.split + sel)
                p = self._gather_experts(
                    state.model(xb, recurrence=self.recurrence))
                loss = pinball_loss(p, yb, self._quantiles)
                preds_chunks.append(p.float().cpu().numpy())
                loss_terms.append(loss.float() * len(sel))
        preds = np.concatenate(preds_chunks, axis=0)
        loss = float(torch.stack(loss_terms).sum()) / len(idx)

        # floor the normalized median at 1e-6 BEFORE de-normalizing (the
        # reference's clamp order)
        med = state.model.median_index()
        preds_denorm = bundle.denorm_targets(
            np.maximum(np.asarray(preds[..., med]), 1e-6))
        mask = bundle.delta_mask
        labels_denorm = bundle.level_labels(idx)
        preds_denorm = bundle.integrate_test_preds(preds_denorm, idx)

        errors = {"deepr": np.abs(preds_denorm - labels_denorm)}
        if baseline_preds:
            for method, series in baseline_preds.items():
                # graftlint: disable=JX003 -- host data: baseline predictions are numpy arrays, no device sync happens here
                series = np.array(np.asarray(series)[idx], copy=True)
                if bundle._has_delta():
                    series[..., mask] += (labels_denorm[:, :1, mask]
                                          - series[:, :1, mask])
                errors[method] = np.abs(series - labels_denorm)
        return float(loss), mae_report(errors, bundle.metric_names)

    # ------------------------------------------------------------------

    def fit(self, bundle: DatasetBundle, state: TrainState | None = None,
            baseline_preds: Mapping[str, np.ndarray] | None = None,
            on_epoch: Callable[[EpochResult, TrainState], None] | None = None,
            num_epochs: int | None = None, on_step=None
            ) -> tuple[TrainState, list[EpochResult]]:
        """Train ``num_epochs`` (default ``config.train.num_epochs``)
        epochs, evaluating after each.  Saves into
        ``config.train.checkpoint_dir`` every ``checkpoint_every_epochs``
        epochs and after the last, or, with ``snapshot_every_steps``, writes
        cursor snapshots there at the cadence and at every epoch's end.
        With ``TrainConfig.elastic`` the epochs run behind the fault
        barrier (:meth:`_run_epochs_elastic`)."""
        if state is None:
            state = self.init_state()
        data_rng = np.random.default_rng(self.config.train.seed)
        run = (self._run_epochs_elastic if self.config.train.elastic
               else self._run_epochs)
        return run(bundle, state, data_rng, 0, 0, baseline_preds, on_epoch,
                   num_epochs, on_step)

    def resume_training(self, bundle: DatasetBundle,
                        directory: str | None = None,
                        baseline_preds: Mapping[str, np.ndarray] | None = None,
                        on_epoch: Callable[[EpochResult, TrainState], None]
                        | None = None,
                        num_epochs: int | None = None, on_step=None
                        ) -> tuple[TrainState, list[EpochResult]]:
        """Restart a preempted :meth:`fit` from the newest cursor snapshot
        under ``directory`` (default the snapshot or checkpoint directory)
        and run to completion: params, Adam's moments and count, the step
        and the shuffle rng come back, the interrupted epoch's plan is
        drawn again and its first ``steps_done`` steps are passed over, so
        every later step sees the batches, dropout streams and step counts
        of the uninterrupted run."""
        from deeprest_tpu_torch.train.checkpoint import latest_cursor_step

        cfg = self.config.train
        directory = directory or self._snapshot_dir or cfg.checkpoint_dir
        if not directory:
            raise ValueError("resume_training needs a snapshot directory "
                             "(TrainConfig.checkpoint_dir or the "
                             "directory argument)")
        step = latest_cursor_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no cursor-bearing snapshot under {directory!r} — "
                "nothing to resume (run fit with "
                "TrainConfig.snapshot_every_steps > 0 first)")
        state, extra = self.restore_state(directory, step)
        cursor = extra["train_cursor"]
        self._global_step = int(cursor["global_step"])
        self.resumed_from_step = step
        data_rng = np.random.default_rng(cfg.seed)
        data_rng.bit_generator.state = cursor["rng_state"]
        run = self._run_epochs_elastic if cfg.elastic else self._run_epochs
        return run(bundle, state, data_rng, int(cursor["epoch"]),
                   int(cursor["steps_done"]), baseline_preds, on_epoch,
                   num_epochs, on_step)

    def _run_epochs(self, bundle: DatasetBundle, state: TrainState,
                    data_rng: np.random.Generator, start_epoch: int,
                    skip_steps: int,
                    baseline_preds: Mapping[str, np.ndarray] | None,
                    on_epoch: Callable[[EpochResult, TrainState], None] | None,
                    num_epochs: int | None, on_step=None
                    ) -> tuple[TrainState, list[EpochResult]]:
        cfg = self.config.train
        if cfg.snapshot_every_steps and cfg.checkpoint_dir \
                and self._snapshot_dir is None:
            self.enable_snapshots(cfg.checkpoint_dir,
                                  cfg.snapshot_every_steps)
        history: list[EpochResult] = []
        total = num_epochs if num_epochs is not None else cfg.num_epochs
        staged = self.stage_dataset(bundle) if total > start_epoch else None
        for epoch in range(start_epoch, total):
            self._begin_epoch_cursor(epoch, data_rng)
            state, train_loss = self.train_epoch(
                state, bundle, data_rng, staged=staged,
                skip_steps=(skip_steps if epoch == start_epoch else 0),
                on_step=on_step)
            test_loss, report = self.evaluate(state, bundle, baseline_preds,
                                              staged=staged)
            result = EpochResult(epoch=epoch, train_loss=train_loss,
                                 test_loss=test_loss, report=report)
            history.append(result)
            if on_epoch is not None:
                on_epoch(result, state)
            # The cursor of the next epoch at step 0; the epoch-end
            # snapshot carries it and replaces the plain cadence save.
            self._begin_epoch_cursor(epoch + 1, data_rng)
            cadence_due = cfg.checkpoint_dir and (
                (epoch + 1) % cfg.checkpoint_every_epochs == 0
                or epoch + 1 == total)
            if self._snapshot_dir is not None:
                self.snapshot(state, bundle)
            elif cadence_due:
                self.save(cfg.checkpoint_dir, state, bundle)
        return state, history

    def save(self, directory: str, state: TrainState, bundle: DatasetBundle,
             extra_host_state: Mapping[str, Any] | None = None) -> str:
        """Checkpoint the state plus the host-side stats needed to serve.
        Under a process group every rank calls it: each writes the boxes
        of the leaves it owns (a leaf replicated on an axis from that
        axis's coordinate 0 only), rank 0 the manifest and the sidecar
        (train/checkpoint.py).

        The leaves carry the JAX ``TrainState`` names
        (:meth:`state_leaves`), so the JAX package's
        ``Predictor.from_checkpoint`` and ``Trainer.resume_training``
        restore the checkpoint as well as the port's.
        """
        from deeprest_tpu_torch.models.qrnn import param_shapes
        from deeprest_tpu_torch.train.checkpoint import save_checkpoint

        extra = {
            "metric_names": bundle.metric_names,
            "x_stats": bundle.x_stats.to_dict(),
            "y_stats": bundle.y_stats.to_dict(),
            "window_size": bundle.window_size,
            "feature_dim": bundle.feature_dim,
            "model_config": dataclasses.asdict(self.model_config),
            "space": bundle.space_dict,
            "delta_mask": (np.asarray(bundle.delta_mask, bool).tolist()
                           if bundle.delta_mask is not None else None),
        }
        if extra_host_state:
            clash = set(extra_host_state) & set(extra)
            if clash:
                raise ValueError(
                    f"extra_host_state would overwrite reserved sidecar "
                    f"keys: {sorted(clash)}")
            extra.update(extra_host_state)
        leaves = self.state_leaves(state)
        params = {k[len("params/"):]: leaves.pop(k) for k in list(leaves)
                  if k.startswith("params/")}
        shapes = {}
        for name, shape in param_shapes(self.model_config).items():
            for pre in ("params/", "opt_state/0/mu/", "opt_state/0/nu/"):
                shapes[pre + name] = shape
        return save_checkpoint(directory, params, state.step, extra,
                               other_leaves=leaves, mesh=self.mesh,
                               shapes=shapes)

    def state_leaves(self, state: TrainState) -> dict[str, Any]:
        """Every leaf of ``state`` by the JAX ``TrainState``'s "/"-joined
        name (this rank's boxes on a mesh): ``params/*``, ``step``,
        Adam's moments and count in optax's layout
        (``opt_state/0/{mu,nu}/*``, ``opt_state/0/count``), and ``rng``,
        which holds the port's train seed (the port's dropout stream is
        not JAX's).  What :meth:`save` writes and the rule table
        places."""
        leaves: dict[str, Any] = {
            f"params/{name}": p for name, p in state.params.items()}
        leaves["step"] = np.asarray(state.step, np.int32)
        leaves["rng"] = np.asarray([0, self.config.train.seed & 0xFFFFFFFF],
                                   np.uint32)
        count = 0
        for name, p in state.model.named_parameters():
            moments = state.optimizer.state.get(p, {})
            leaves[f"opt_state/0/mu/{name}"] = moments.get(
                "exp_avg", torch.zeros_like(p))
            leaves[f"opt_state/0/nu/{name}"] = moments.get(
                "exp_avg_sq", torch.zeros_like(p))
            if "step" in moments:
                count = int(moments["step"])
        leaves["opt_state/0/count"] = np.asarray(count, np.int32)
        return leaves

    # ------------------------------------------------------------------

    def predict(self, state: TrainState, x: np.ndarray,
                batch_size: int = 64) -> np.ndarray:
        """Normalized quantile predictions ``[N, W, E, Q]`` for windows x."""
        outs = []
        with torch.no_grad():
            for lo in range(0, len(x), batch_size):
                xb = torch.from_numpy(np.ascontiguousarray(
                    x[lo:lo + batch_size], np.float32)).to(self.device)
                outs.append(self._gather_experts(
                    state.model(xb, recurrence=self.recurrence))
                    .float().cpu().numpy())
        return np.concatenate(outs, axis=0)
