"""Typed configuration: the fields of ``deeprest_tpu/config.py`` that the
port reads.

``ModelConfig`` is a field-for-field copy, so the ``model_config`` dict a
checkpoint sidecar carries constructs it as it is.  ``rnn_backend`` is
carried for that reason only: the port picks the recurrence from the
tensors' device (ops/gru.py), never from this field.  ``TrainConfig`` copies
the training fields the port's per-step trainer reads, with the JAX
package's defaults, plus the fields of features it does not have yet, which
raise on any value but the one the port implements.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Dimensions of the multi-task quantile GRU (defaults as the JAX
    package's: hidden 128, 1 layer, bidirectional, quantiles .05/.50/.95)."""

    feature_dim: int = 8
    num_metrics: int = 3
    hidden_size: int = 128
    num_layers: int = 1
    bidirectional: bool = True
    quantiles: tuple[float, ...] = (0.05, 0.50, 0.95)
    dropout_rate: float = 0.50
    compute_dtype: str = "float32"
    rnn_backend: str = "auto"

    @property
    def directions(self) -> int:
        return 2 if self.bidirectional else 1

    @property
    def rnn_out_dim(self) -> int:
        return self.hidden_size * self.directions


LEVEL_RESOURCES = ("usage",)
"""Resources modeled as per-bucket increments by default (the
``TrainConfig.delta_resources`` default): disk usage accumulates writes, so
the model learns its change and evaluation integrates it back."""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (defaults as the JAX package's).

    The last four fields name features of the JAX trainer that the port
    does not have yet: the host-streamed feed (``device_data="off"``), fused
    supersteps, window-coalesced gradient accumulation and the sparse feed,
    and elastic remeshing.  The port always stages the normalized base
    series on its device and runs one optimizer step per dispatch, so
    ``device_data`` takes "auto" or "always" (both stage),
    ``steps_per_superstep`` only 1 (the JAX default "auto" would fuse
    steps), and the others only their defaults; anything else raises.
    """

    num_epochs: int = 50
    batch_size: int = 32
    learning_rate: float = 1e-3
    train_split: float = 0.40     # leading fraction of windows used for training
    window_size: int = 60         # sliding-window length (time steps)
    eval_stride: int = 60         # test windows sampled every `stride` steps
    eval_max_cycles: int = 9      # cap on evaluated test windows per epoch
    eval_batch_size: int = 64     # eval windows per device batch
    seed: int = 0
    checkpoint_dir: str | None = None
    checkpoint_every_epochs: int = 10
    log_every_steps: int = 50
    # resources trained as per-bucket increments (train/data.py)
    delta_resources: tuple[str, ...] = LEVEL_RESOURCES
    device_data: str = "auto"
    steps_per_superstep: int | str = 1
    grad_accum_windows: int = 1
    sparse_feed: bool = False
    elastic: bool = False

    def __post_init__(self):
        unported = []
        if self.device_data not in ("auto", "always"):
            unported.append(f"device_data={self.device_data!r} (the port "
                            "always stages the base series: 'auto' or "
                            "'always')")
        if self.steps_per_superstep != 1 \
                or isinstance(self.steps_per_superstep, bool):
            unported.append(f"steps_per_superstep="
                            f"{self.steps_per_superstep!r} (supersteps are "
                            "not ported: 1)")
        if self.grad_accum_windows != 1 \
                or isinstance(self.grad_accum_windows, bool):
            unported.append(f"grad_accum_windows={self.grad_accum_windows!r}"
                            " (gradient accumulation is not ported: 1)")
        if self.sparse_feed:
            unported.append("sparse_feed=True (the sparse feed is not "
                            "ported)")
        if self.elastic:
            unported.append("elastic=True (elastic remeshing is not ported)")
        if unported:
            raise ValueError("TrainConfig: the port does not implement "
                             + "; ".join(unported))


@dataclasses.dataclass(frozen=True)
class InferConfig:
    """Rolled-inference knobs (serve/fused.py).  ``page_windows`` and
    ``coalesce_pages`` left at None follow the device: the ladder's top
    rung and 4 coalesced pages on CUDA, the smallest rung >= 8 and 1 page
    on the CPU."""

    fused: bool = True
    page_windows: int | None = None
    coalesce_pages: int | None = None

    def __post_init__(self):
        if self.page_windows is not None and self.page_windows < 1:
            raise ValueError(
                f"InferConfig.page_windows={self.page_windows}: must be "
                ">= 1 (or None for the device default)")
        if self.coalesce_pages is not None and self.coalesce_pages < 1:
            raise ValueError(
                f"InferConfig.coalesce_pages={self.coalesce_pages}: must "
                "be >= 1 (or None for the device default)")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    infer: InferConfig = dataclasses.field(default_factory=InferConfig)
