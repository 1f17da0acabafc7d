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

Not ported yet: elastic remeshing, the mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from deeprest_tpu_torch.config import Config
from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.graphs import CapturedGraph
from deeprest_tpu_torch.models.qrnn import (
    MASK_PARAM_NAMES, MASKED_PARAM_NAMES, QuantileGRU, fold_feature_mask,
    init_params,
)
from deeprest_tpu_torch.ops.gru import Recurrence
from deeprest_tpu_torch.ops.quantile import pinball_loss
from deeprest_tpu_torch.train.data import DatasetBundle, eval_window_indices
from deeprest_tpu_torch.train.graphs import EpochPlan, capture_update
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


class Trainer:
    """Owns the model config, the device and the training loop.

    ``recurrence`` replaces the device dispatch of the GRU recurrence (pass
    ``ops.cuda_gru.gru_recurrence_reference`` to train through the plain
    version on a CUDA device, differentiated by torch autograd).

    Counters: ``dispatches`` (optimizer updates run: graph replays plus
    eager updates), ``captures`` (CUDA graphs captured), ``replays`` and
    ``capture_seconds`` (host seconds spent capturing).
    """

    def __init__(self, config: Config, feature_dim: int,
                 metric_names: list[str], device=None,
                 recurrence: Recurrence | None = None):
        self.config = config
        self.metric_names = list(metric_names)
        self.model_config = dataclasses.replace(
            config.model, feature_dim=feature_dim,
            num_metrics=len(metric_names))
        self.device = resolve_device(device)
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
        model = QuantileGRU(self.model_config, device=self.device)
        model.load_params(params)
        model.requires_grad_(True)
        opt = torch.optim.Adam(model.parameters(),
                               lr=self.config.train.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8,
                               capturable=self.device.type == "cuda")
        return TrainState(step=0, model=model, optimizer=opt)

    def restore_state(self, directory: str, step: int | None = None
                      ) -> tuple[TrainState, dict | None]:
        """The full train state of a checkpoint either package wrote:
        params, ``step``, Adam's moments (``opt_state/0/{mu,nu}/*``) and
        count (``opt_state/0/count``), and the sidecar."""
        from deeprest_tpu_torch.train.checkpoint import (
            latest_step, load_leaves, load_sidecar,
        )

        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {directory!r}")
        leaves = load_leaves(directory, step)
        params = {k[len("params/"):]: v for k, v in leaves.items()
                  if k.startswith("params/")}
        state = self.init_state(params)
        count = int(leaves["opt_state/0/count"])
        if count:
            capturable = self.device.type == "cuda"
            for name, p in state.model.named_parameters():
                state.optimizer.state[p] = {
                    "step": torch.tensor(
                        float(count), dtype=torch.float32,
                        device=p.device if capturable else "cpu"),
                    "exp_avg": leaves[f"opt_state/0/mu/{name}"].to(
                        p.device, p.dtype).clone(),
                    "exp_avg_sq": leaves[f"opt_state/0/nu/{name}"].to(
                        p.device, p.dtype).clone(),
                }
        state.step = int(leaves["step"])
        return state, load_sidecar(directory, step, missing_ok=True)

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
        row i, test window i at ``split + i``.  Under ``device_data="auto"``
        a dense base over ``device_data_max_bytes`` raises, where the
        reference would host-feed it (ROADMAP queue 1, item 13);
        ``"always"`` stages it."""
        cfg = self.config.train
        if cfg.sparse_feed and bundle.is_sparse:
            return self._stage_sparse(bundle)
        if bundle.x_base is None and bundle.is_sparse:
            # A sparse-only bundle has no dense base to fall back to.
            raise ValueError(
                "bundle carries only sparse (padded-COO) traffic but "
                "TrainConfig.sparse_feed is off; enable sparse_feed or "
                "rebuild the bundle with dense traffic")
        if bundle.x_base is None or bundle.y_base is None:
            raise ValueError("bundle carries no base series to stage; build "
                             "it with prepare_dataset")
        dtype = getattr(torch, self.model_config.compute_dtype)
        # Counted before the cast, as the reference counts it: x at 2 bytes
        # an element in bf16, else as it lies, plus the targets.
        x_bytes = (bundle.x_base.size * 2 if dtype == torch.bfloat16
                   else bundle.x_base.nbytes)
        total = x_bytes + bundle.y_base.nbytes
        if cfg.device_data == "auto" and total > cfg.device_data_max_bytes:
            raise ValueError(
                f"dense base ({total} bytes) exceeds device_data_max_bytes "
                f"({cfg.device_data_max_bytes}); the host-streamed feed "
                "that the reference falls back to is not ported yet "
                "(ROADMAP queue 1, item 13) — raise the budget, shrink the "
                'corpus, or pass device_data="always"')
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
                weights: torch.Tensor, step: int) -> torch.Tensor:
        """One optimizer update from the ``[G, B]`` microbatches ``starts``
        / ``weights`` (device tensors); returns their ``[G]`` f32 losses.
        Runs eagerly or under capture: no host sync, no host-to-device
        copy.  ``step`` seeds the CPU dropout streams only."""
        g, b = starts.shape
        mode = self.config.train.grad_accum_mode if g > 1 else "loop"
        model, quantiles = state.model, self._quantiles
        state.optimizer.zero_grad(set_to_none=True)
        if mode == "flat":
            xb, yb = self._gather(staged, starts.reshape(-1))
            preds = model(xb.reshape(g, b, *xb.shape[1:]),
                          deterministic=False, generator=self._dropout(step, 0),
                          recurrence=self.recurrence)
            yb = yb.reshape(g, b, *yb.shape[1:])
            losses = torch.stack([
                pinball_loss(preds[i], yb[i], quantiles,
                             sample_weight=weights[i], allow_empty=True)
                for i in range(g)])
            losses.sum().backward()
        elif mode == "exact":
            losses = self._exact_grads(state, staged, starts, weights, step)
        else:
            losses = []
            for i in range(g):
                xb, yb = self._gather(staged, starts[i])
                preds = model(xb, deterministic=False,
                              generator=self._dropout(step, i),
                              recurrence=self.recurrence)
                loss = pinball_loss(preds, yb, quantiles,
                                    sample_weight=weights[i],
                                    allow_empty=g > 1)
                loss.backward()
                losses.append(loss.detach())
            losses = torch.stack(losses)
        state.optimizer.step()
        return losses.detach().float()

    def _exact_grads(self, state: TrainState, staged, starts, weights,
                     step: int) -> torch.Tensor:
        """"exact" accumulation: the feature mask folds into the layer-0
        input weights once; each microbatch runs forward/backward against
        the folded params, its cotangent of the folded weights goes back
        through the fold on its own, and the grads sum in microbatch order
        (the JAX trainer's ``_accum_grads_exact``).  Sets ``.grad``;
        returns the ``[G]`` losses."""
        params = state.model.params()
        folded = fold_feature_mask(params)
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
                                recurrence=self.recurrence)
            loss = pinball_loss(preds, yb, self._quantiles,
                                sample_weight=weights[i], allow_empty=True)
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
        """One eager optimizer step on the windows starting at ``starts``
        with sample weights ``weights``; returns the loss as a device
        scalar."""
        st = torch.from_numpy(np.asarray(starts, np.int64)).to(self.device)
        wt = torch.from_numpy(np.asarray(weights, np.float32)).to(self.device)
        self._set_dropout_offset(state.step)
        loss = self._update(state, staged, st[None], wt[None], state.step)[0]
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
        shape = (starts.size // (g * starts.shape[-1]), g, starts.shape[-1])
        if state.plan is None or state.plan.shape != shape:
            state.plan = EpochPlan(*shape, device=self.device)
            state.retire_graph()
        if state.plan.staged is None or any(
                a is not b for a, b in zip(state.plan.staged, staged)):
            state.plan.staged = staged
            state.retire_graph()
        state.plan.stage(starts.reshape(-1, starts.shape[-1]),
                         weights.reshape(-1, weights.shape[-1]),
                         first_update)
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
            starts, weights = state.plan.take()
            state.plan.put(self._update(state, state.plan.staged, starts,
                                        weights, step))

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
        t0 = time.perf_counter()
        pool = (state.retired.graph.pool() if state.retired is not None
                else None)
        state.graph = capture_update(body, self.device, [self._generator],
                                     pool=pool, stream=side)
        state.retired = None
        self.capture_seconds += time.perf_counter() - t0
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
        first update, which builds the kernels and captures the graph."""
        cfg = self.config.train
        if staged is None:
            staged = self.stage_dataset(bundle)
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
        captured = self.device.type == "cuda" and s > 1
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
                if not self._warmed:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self._warmed = True
                    self.throughput.start()
                    measuring = True
                else:
                    steps += n_real
            prev = self._global_step
            self._global_step += real
            if log_every and prev // log_every != self._global_step // log_every:
                # graftlint: disable=JX003 -- designed sink: one readback per superstep, only when a log boundary passed
                vals = plan.microbatch_losses(c * s, c * s + real)
                for gs in range(prev + 1, self._global_step + 1):
                    if gs % log_every == 0:
                        print(f"step {gs}: loss {vals[gs - prev - 1]:.6f}")
            self._note_steps(state, bundle, real, on_step)
        if measuring:
            self.throughput.stop(steps)
        epoch_losses = plan.microbatch_losses(skip_steps, num_steps)
        self._last_epoch_losses = epoch_losses
        return state, float(np.mean(epoch_losses, dtype=np.float64))

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
        if keep:
            from deeprest_tpu_torch.train.checkpoint import (
                prune_cursor_snapshots,
            )

            prune_cursor_snapshots(self._snapshot_dir, keep)
        return path

    # ------------------------------------------------------------------

    def evaluate(self, state: TrainState, bundle: DatasetBundle,
                 baseline_preds: Mapping[str, np.ndarray] | None = None,
                 staged=None) -> tuple[float, dict]:
        """Reference-semantics eval: strided windows, de-normalized MAE.

        ``baseline_preds`` maps method name → de-normalized ``[N_test, W,
        E]`` predictions aligned with ``bundle.x_test``.  Runs without
        autograd, so the recurrence is the inference form.
        """
        cfg = self.config.train
        if staged is None:
            staged = self.stage_dataset(bundle)
        idx = eval_window_indices(bundle.num_test_windows, cfg.eval_stride,
                                  cfg.eval_max_cycles)
        if len(idx) == 0:
            raise ValueError("no eval windows: test split shorter than stride")
        preds_chunks, loss_terms = [], []
        with torch.no_grad():
            for lo in range(0, len(idx), cfg.eval_batch_size):
                sel = idx[lo:lo + cfg.eval_batch_size]
                xb, yb = self._windows(staged, bundle.split + sel)
                p = state.model(xb, recurrence=self.recurrence)
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
        cursor snapshots there at the cadence and at every epoch's end."""
        if state is None:
            state = self.init_state()
        data_rng = np.random.default_rng(self.config.train.seed)
        return self._run_epochs(bundle, state, data_rng, 0, 0,
                                baseline_preds, on_epoch, num_epochs, on_step)

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
        return self._run_epochs(bundle, state, data_rng,
                                int(cursor["epoch"]),
                                int(cursor["steps_done"]), baseline_preds,
                                on_epoch, num_epochs, on_step)

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

        The leaves carry the JAX ``TrainState`` names, so the JAX
        package's ``Predictor.from_checkpoint`` and
        ``Trainer.resume_training`` restore the checkpoint as well as the
        port's: ``params/*``, ``step``, Adam's moments and count in optax's
        layout (``opt_state/0/{mu,nu}/*``, ``opt_state/0/count``), and
        ``rng``, which holds the port's train seed (the port's dropout
        stream is not JAX's).
        """
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
        leaves: dict[str, Any] = {
            "step": np.asarray(state.step, np.int32),
            "rng": np.asarray([0, self.config.train.seed & 0xFFFFFFFF],
                              np.uint32),
        }
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
        return save_checkpoint(directory, state.params, state.step, extra,
                               other_leaves=leaves)

    # ------------------------------------------------------------------

    def predict(self, state: TrainState, x: np.ndarray,
                batch_size: int = 64) -> np.ndarray:
        """Normalized quantile predictions ``[N, W, E, Q]`` for windows x."""
        outs = []
        with torch.no_grad():
            for lo in range(0, len(x), batch_size):
                xb = torch.from_numpy(np.ascontiguousarray(
                    x[lo:lo + batch_size], np.float32)).to(self.device)
                outs.append(state.model(xb, recurrence=self.recurrence)
                            .float().cpu().numpy())
        return np.concatenate(outs, axis=0)
