"""Training diagnostics figures (``deeprest_tpu/train/plots.py``).

Per-metric learning curves of train/test loss over epochs, and
prediction-vs-ground-truth series of the de-normalized median-quantile
estimate on the evaluation windows with the outer quantile band (the
reference driver's matplotlib output, estimate.py:125-169).

:func:`prediction_arrays` computes what :func:`prediction_plots` draws
without drawing, so the arrays can be checked where matplotlib is absent.
matplotlib is imported only to draw (the Agg backend, headless-safe);
:func:`require_matplotlib` lets a caller fail before it trains.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def require_matplotlib() -> None:
    """Raise a RuntimeError naming matplotlib when it cannot be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        raise RuntimeError(
            "drawing the training plots needs matplotlib, which is not "
            f"installed here ({exc}); install it or leave --plots-dir "
            "out") from exc


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def prediction_arrays(trainer, state, bundle) -> dict[str, np.ndarray]:
    """The evaluation windows' arrays the prediction plots draw, in level
    space: ``median``, ``lo`` and ``hi`` (the first and last quantiles)
    de-normalized from ``trainer.predict(state, x_test[idx])`` (the
    median floored at 1e-6 before de-normalizing, delta columns
    integrated from each window's first observed level), ``truth``
    (``bundle.level_labels``) and ``idx``, each ``[N, W, E]`` but idx."""
    from deeprest_tpu_torch.train.data import eval_window_indices

    cfg = trainer.config.train
    idx = eval_window_indices(bundle.num_test_windows, cfg.eval_stride,
                              cfg.eval_max_cycles)
    preds = trainer.predict(state, bundle.x_test[idx])      # [N, W, E, Q]

    def denorm(q: int) -> np.ndarray:
        return bundle.integrate_test_preds(
            bundle.denorm_targets(np.maximum(preds[..., q], 1e-6)), idx)

    return {"median": denorm(state.model.median_index()),
            "lo": denorm(0), "hi": denorm(preds.shape[-1] - 1),
            "truth": bundle.level_labels(idx), "idx": idx}


def learning_curves(history: Sequence, path: str) -> str:
    """Train/test loss per epoch (reference: estimate.py:125-134).

    ``history`` is the list of Trainer ``EpochResult``s.
    """
    plt = _plt()
    epochs = [h.epoch for h in history]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(epochs, [h.train_loss for h in history], label="train")
    if any(h.test_loss is not None for h in history):
        ax.plot(epochs, [h.test_loss for h in history], label="test")
    ax.set_xlabel("epoch")
    ax.set_ylabel("pinball loss")
    ax.set_title("learning curve")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def prediction_plots(
    preds: np.ndarray,
    truth: np.ndarray,
    metric_names: Sequence[str],
    out_dir: str,
    quantile_band: tuple[np.ndarray, np.ndarray] | None = None,
) -> list[str]:
    """Per-metric prediction-vs-truth series (reference: estimate.py:136-169).

    Args:
      preds: ``[N_windows, W, E]`` de-normalized median predictions over the
        evaluation windows; windows are concatenated on the time axis, the
        reference's presentation for its strided non-overlapping eval.
      truth: same-shape ground truth.
      metric_names: length-E labels (``component_resource``).
      out_dir: one PNG per metric is written here.
      quantile_band: optional (lower, upper) arrays of the same shape; drawn
        as a shaded band around the median.
    """
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    n, w, e = preds.shape
    t_axis = np.arange(n * w)
    written = []
    for idx, name in enumerate(metric_names):
        fig, ax = plt.subplots(figsize=(9, 3.5))
        ax.plot(t_axis, truth[:, :, idx].ravel(), label="measurement",
                linewidth=1.0)
        ax.plot(t_axis, preds[:, :, idx].ravel(), label="prediction (q50)",
                linewidth=1.0)
        if quantile_band is not None:
            lo, hi = quantile_band
            ax.fill_between(t_axis, lo[:, :, idx].ravel(),
                            hi[:, :, idx].ravel(), alpha=0.25,
                            label="q05-q95 band", linewidth=0)
        for b in range(1, n):
            ax.axvline(b * w, color="grey", alpha=0.3, linewidth=0.6)
        ax.set_title(name)
        ax.set_xlabel("eval step")
        ax.legend(fontsize=8)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{name.replace('/', '_')}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)
    return written
