"""Training side of the port: dataset preparation, the per-step trainer,
metrics, and the checkpoint format.

The public names are the JAX package's (``deeprest_tpu/train/__init__.py``),
each loaded from its module when first read."""

from deeprest_tpu_torch._exports import lazy_exports

_EXPORTS = {
    "DatasetBundle": "data", "prepare_dataset": "data",
    "Trainer": "trainer", "TrainState": "trainer",
    "mae_report": "metrics", "format_report": "metrics",
    "Throughput": "metrics",
    "save_checkpoint": "checkpoint", "restore_checkpoint": "checkpoint",
    "latest_step": "checkpoint", "latest_cursor_step": "checkpoint",
}

__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
