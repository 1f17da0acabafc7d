"""Importable-by-name factories for the port's process-replica tests: a
spawned worker builds its tiny port Predictor stack from this module (the
spec's ``sys_path`` carries the tests directory into the child).  It
imports numpy and the port only, never JAX or the JAX package, so a worker
that loads it loads neither.

The shapes are tests/router_test_support.py's (F=6, E=3, H=8, W=8).
Params come from an ``.npz`` of JAX-initialized leaves (the test writes it
through ``interop.params_from_jax``) or, without one, from the port's own
seeded init.
"""

import numpy as np

F, E, H, W = 6, 3, 8, 8


def tiny_params(scale: float = 1.0, params_path: str | None = None) -> dict:
    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.models.qrnn import init_params

    if params_path:
        with np.load(params_path) as z:
            params = {k: z[k] for k in z.files}
    else:
        params = init_params(ModelConfig(feature_dim=F, num_metrics=E,
                                          hidden_size=H, dropout_rate=0.0))
    return {k: np.asarray(v, np.float32) * np.float32(scale)
            for k, v in params.items()}


def write_checkpoint(directory: str, params_path: str | None = None,
                     scale: float = 1.0, step: int = 0) -> str:
    """The tiny model as a port checkpoint (``serve --ckpt-dir``), with
    build_tiny's stats and names; returns the directory."""
    import dataclasses

    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.train.checkpoint import save_checkpoint

    mc = ModelConfig(feature_dim=F, num_metrics=E, hidden_size=H,
                     dropout_rate=0.0)
    extra = {
        "metric_names": [f"c{i}_cpu" for i in range(E)],
        "x_stats": {"min": 0.0, "max": 1.0},
        "y_stats": {"min": [0.0] * E, "max": [1.0] * E},
        "window_size": W, "feature_dim": F,
        "model_config": dataclasses.asdict(mc), "space": None,
        "delta_mask": None,
    }
    save_checkpoint(str(directory), tiny_params(scale, params_path),
                    step=step, extra=extra)
    return str(directory)


def build_tiny(scale: float = 1.0, ladder=(8,), params_path=None):
    from deeprest_tpu_torch.config import ModelConfig
    from deeprest_tpu_torch.data.windows import MinMaxStats
    from deeprest_tpu_torch.serve.predictor import Predictor

    mc = ModelConfig(feature_dim=F, num_metrics=E, hidden_size=H,
                     dropout_rate=0.0)
    return Predictor(
        tiny_params(scale, params_path), mc,
        x_stats=MinMaxStats(min=np.float32(0.0), max=np.float32(1.0)),
        y_stats=MinMaxStats(min=np.zeros((E,), np.float32),
                            max=np.ones((E,), np.float32)),
        metric_names=[f"c{i}_cpu" for i in range(E)],
        window_size=W, ladder=tuple(ladder), device="cpu")


class SlowBackend:
    """A stack whose predicts sleep first: a window to SIGKILL a worker
    mid-request, and a predict that outlives a short deadline.  Metadata
    and batcher attachment delegate to the inner stack."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self.delay_s = float(delay_s)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict_series(self, traffic, integrate=True):
        import time

        time.sleep(self.delay_s)
        return self._inner.predict_series(traffic, integrate=integrate)

    def predict_series_many(self, series_list, integrate=True):
        import time

        time.sleep(self.delay_s)
        return self._inner.predict_series_many(series_list,
                                               integrate=integrate)


def build_slow(delay_s: float = 1.0, scale: float = 1.0, ladder=(8,)):
    return SlowBackend(build_tiny(scale=scale, ladder=tuple(ladder)),
                       delay_s)


class ModulesProbe(SlowBackend):
    """A stack that writes the worker's ``sys.modules`` names to a file
    after each predict, so a test reads what the child has imported once
    it has served."""

    def __init__(self, inner, path: str):
        super().__init__(inner, 0.0)
        self.path = path

    def predict_series(self, traffic, integrate=True):
        import sys

        out = self._inner.predict_series(traffic, integrate=integrate)
        with open(self.path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(sorted(sys.modules)))
        return out


def build_probe(path: str, ladder=(8,)):
    return ModulesProbe(build_tiny(ladder=tuple(ladder)), path)
