"""The training and evaluation loop (``deeprest_tpu/train/trainer.py``, the
per-step loop).

One optimizer step per dispatch, as the JAX trainer's per-step path: the
normalized base series are staged on the device once (``stage_dataset``),
each step gathers its ``[B, W]`` windows by start index, runs the model
with seeded dropout, the pinball loss with zero-weight padding of the
ragged last batch, the backward (the recurrence's backward is the CUDA
kernel ``csrc/gru_bwd.cu`` on a GPU) and Adam with optax's defaults.  The
state is updated in place, where the JAX step donates and returns it.
Per-step losses stay on the device and are read back once per epoch, or
at a ``log_every_steps`` boundary.

Evaluation keeps the reference's semantics: every ``eval_stride``-th test
window, capped at ``eval_max_cycles``, median-quantile predictions floored
at 1e-6 before de-normalization, delta columns integrated back to levels,
absolute errors pooled into the MAE report.

Not ported yet: supersteps, CUDA-graph capture, gradient accumulation,
snapshots and resume, elastic remeshing, the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from deeprest_tpu_torch.config import Config
from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.models.qrnn import QuantileGRU, init_params
from deeprest_tpu_torch.ops.gru import Recurrence
from deeprest_tpu_torch.ops.quantile import pinball_loss
from deeprest_tpu_torch.train.data import DatasetBundle, eval_window_indices
from deeprest_tpu_torch.train.metrics import Throughput, mae_report


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the Adam optimizer over them, and the
    count of optimizer steps taken."""

    step: int
    model: QuantileGRU
    optimizer: torch.optim.Adam

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
    """The dropout stream of one train step, seeded from ``(seed, step)``:
    the counterpart of the JAX trainer's ``fold_in(rng, step)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    return gen


class Trainer:
    """Owns the model config, the device and the training loop.

    ``recurrence`` replaces the device dispatch of the GRU recurrence (pass
    ``ops.cuda_gru.gru_recurrence_reference`` to train through the plain
    version on a CUDA device, differentiated by torch autograd).
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
        self._warmed = False       # first-ever step (kernel build) excluded
        self._global_step = 0
        # per-step losses of the most recent train_epoch (np [K])
        self._last_epoch_losses: np.ndarray | None = None

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
        ``models.qrnn.init_params(seed)``.  Adam with optax's defaults."""
        if params is None:
            seed = self.config.train.seed if seed is None else seed
            params = init_params(self.model_config, seed)
        model = QuantileGRU(self.model_config, device=self.device)
        model.load_params(params)
        model.requires_grad_(True)
        opt = torch.optim.Adam(model.parameters(),
                               lr=self.config.train.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        return TrainState(step=0, model=model, optimizer=opt)

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

    def stage_dataset(self, bundle: DatasetBundle):
        """The normalized base series on the device: ``(x_base [T, F]`` in
        the compute dtype, ``y_base [T, E]`` f32).  Train window i starts at
        base row i, test window i at ``split + i``."""
        if bundle.x_base is None or bundle.y_base is None:
            raise ValueError("bundle carries no base series to stage; build "
                             "it with prepare_dataset")
        dtype = getattr(torch, self.model_config.compute_dtype)
        x = torch.from_numpy(np.ascontiguousarray(bundle.x_base))
        y = torch.from_numpy(np.ascontiguousarray(bundle.y_base))
        return (x.to(self.device, dtype), y.to(self.device, torch.float32))

    def _windows(self, staged, starts: np.ndarray):
        """Gather ``[n, W, F]`` inputs and ``[n, W, E]`` targets of the
        windows starting at ``starts`` from the staged base series."""
        x_base, y_base = staged
        w = self.config.train.window_size
        idx = (torch.from_numpy(np.asarray(starts, np.int64)).to(self.device)
               [:, None] + torch.arange(w, device=self.device)[None, :])
        return x_base[idx], y_base[idx]

    def train_step(self, state: TrainState, staged, starts: np.ndarray,
                   weights: np.ndarray) -> torch.Tensor:
        """One optimizer step on the windows starting at ``starts`` with
        sample weights ``weights``; returns the loss as a device scalar."""
        xb, yb = self._windows(staged, starts)
        wb = torch.from_numpy(np.asarray(weights, np.float32)).to(self.device)
        gen = dropout_generator(self.device, self.config.train.seed,
                                state.step)
        preds = state.model(xb, deterministic=False, generator=gen,
                            recurrence=self.recurrence)
        loss = pinball_loss(preds, yb, self.model_config.quantiles,
                            sample_weight=wb)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    def train_epoch(self, state: TrainState, bundle: DatasetBundle,
                    epoch_rng: np.random.Generator,
                    staged=None) -> tuple[TrainState, float]:
        """One epoch; returns the state and the mean of its per-step
        losses (read back once, here)."""
        if staged is None:
            staged = self.stage_dataset(bundle)
        log_every = self.config.train.log_every_steps
        losses = []
        steps = 0
        measuring = self._warmed
        if measuring:
            self.throughput.start()
        for sel, weight in self._batches(bundle.num_train_windows, epoch_rng):
            loss = self.train_step(state, staged, sel, weight)
            losses.append(loss)
            self._global_step += 1
            if not self._warmed:
                # the first step builds the kernels and initializes the
                # libraries; keep it out of the steady-state window
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._warmed = True
                self.throughput.start()
                measuring = True
            else:
                steps += 1
            if log_every and self._global_step % log_every == 0:
                # graftlint: disable=JX003 -- designed sink: one scalar readback per log_every steps, the logging contract
                print(f"step {self._global_step}: loss {float(loss):.6f}")
        if measuring:
            self.throughput.stop(steps)
        epoch_losses = torch.stack(losses).float().cpu().numpy()
        self._last_epoch_losses = epoch_losses
        return state, float(np.mean(epoch_losses, dtype=np.float64))

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
                loss = pinball_loss(p, yb, self.model_config.quantiles)
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
            num_epochs: int | None = None
            ) -> tuple[TrainState, list[EpochResult]]:
        """Train ``num_epochs`` (default ``config.train.num_epochs``)
        epochs, evaluating after each and saving into
        ``config.train.checkpoint_dir`` every ``checkpoint_every_epochs``
        epochs and after the last."""
        cfg = self.config.train
        if state is None:
            state = self.init_state()
        data_rng = np.random.default_rng(cfg.seed)
        total = num_epochs if num_epochs is not None else cfg.num_epochs
        staged = self.stage_dataset(bundle)
        history: list[EpochResult] = []
        for epoch in range(total):
            state, train_loss = self.train_epoch(state, bundle, data_rng,
                                                 staged=staged)
            test_loss, report = self.evaluate(state, bundle, baseline_preds,
                                              staged=staged)
            result = EpochResult(epoch=epoch, train_loss=train_loss,
                                 test_loss=test_loss, report=report)
            history.append(result)
            if on_epoch is not None:
                on_epoch(result, state)
            if cfg.checkpoint_dir and (
                    (epoch + 1) % cfg.checkpoint_every_epochs == 0
                    or epoch + 1 == total):
                self.save(cfg.checkpoint_dir, state, bundle)
        return state, history

    def save(self, directory: str, state: TrainState, bundle: DatasetBundle,
             extra_host_state: Mapping[str, Any] | None = None) -> str:
        """Checkpoint the state plus the host-side stats needed to serve.

        The leaves carry the JAX ``TrainState`` names, so the JAX
        package's ``Predictor.from_checkpoint`` restores the checkpoint as
        well as the port's: ``params/*``, ``step``, Adam's moments and
        count in optax's layout (``opt_state/0/{mu,nu}/*``,
        ``opt_state/0/count``), and ``rng``, which holds the port's train
        seed (the port's dropout stream is not JAX's).  The port does not
        read the optimizer state back yet (resume is not ported).
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
