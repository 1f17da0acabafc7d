"""Typed configuration: the fields of ``deeprest_tpu/config.py`` that the
port reads.

``ModelConfig`` and ``SurfaceConfig`` are field-for-field copies (the
``model_config`` dict a checkpoint sidecar carries constructs the first as
it is).  ``rnn_backend`` is carried for that reason only: the port picks
the recurrence from the tensors' device (ops/gru.py), never from this
field.  ``TrainConfig`` copies the training fields the port's trainer
reads, with the JAX package's defaults and validation messages, plus the
fields of features it does not have yet, which raise on any value but the
one the port implements.
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

    ``steps_per_superstep``: train steps per superstep, an int >= 1,
    ``"epoch"`` (the whole epoch) or ``"auto"`` (min(epoch length,
    ``log_every_steps`` or 32), capped so a plan chunk stays under ~1 MiB).
    On a CUDA device a superstep of S > 1 replays one captured CUDA graph
    per optimizer update; 1 is the eager per-step loop.
    ``grad_accum_windows`` (G) folds G consecutive plan steps
    (microbatches) into one optimizer update with summed grads, the step
    counter still counting microbatches; ``grad_accum_mode`` says how:
    ``"loop"`` (G forward/backward passes accumulating grads, the
    reference), ``"exact"`` (the mask fold computed once, each
    microbatch's cotangent pushed through it in microbatch order:
    bit-identical to "loop") or ``"flat"`` (the G batches as one ``[G·B]``
    row batch through the model's group axis; weight-grad sums
    re-associate).  ``snapshot_every_steps`` writes a cursor snapshot (the
    full state plus the epoch-plan cursor) at the first superstep boundary
    at or past every N real steps, 0 = off; ``snapshot_keep`` keeps the
    newest K cursor snapshots, 0 = all.

    ``sparse_feed`` stages the traffic as RAW padded-COO ``[T, K]`` rows
    (``sparse_nnz_cap`` = K, the most nonzero columns a bucket row may
    have; a fatter row raises) and densifies and normalizes each step's
    windows on the device (``ops/densify.py``); losses are bit-identical
    to the dense feed's.  Its staged bytes are held to
    ``device_data_max_bytes`` under ``device_data="auto"``.

    Features of the JAX trainer the port does not have yet: the
    host-streamed feed (``device_data="off"``) and elastic remeshing.  The
    port always stages the base series on its device, so ``device_data``
    takes "auto" or "always" (both stage), and ``elastic`` only False;
    anything else raises.
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
    device_data_max_bytes: int = 4 << 30
    steps_per_superstep: int | str = "auto"
    grad_accum_windows: int = 1
    grad_accum_mode: str = "exact"
    snapshot_every_steps: int = 0
    snapshot_keep: int = 3
    sparse_feed: bool = False
    sparse_nnz_cap: int = 64
    elastic: bool = False

    def __post_init__(self):
        v = self.steps_per_superstep
        ok = v in ("auto", "epoch") or (
            isinstance(v, int) and not isinstance(v, bool) and v >= 1)
        if not ok:
            raise ValueError(
                f"TrainConfig.steps_per_superstep={v!r}: must be 'auto', "
                f"'epoch', or an int >= 1")
        g = self.grad_accum_windows
        if not isinstance(g, int) or isinstance(g, bool) or g < 1:
            raise ValueError(
                f"TrainConfig.grad_accum_windows={g!r}: must be an int >= 1")
        if self.grad_accum_mode not in ("exact", "flat", "loop"):
            raise ValueError(
                f"TrainConfig.grad_accum_mode={self.grad_accum_mode!r}: "
                f"must be 'exact', 'flat', or 'loop'")
        if not isinstance(self.sparse_nnz_cap, int) \
                or isinstance(self.sparse_nnz_cap, bool) \
                or self.sparse_nnz_cap < 1:
            raise ValueError(
                f"TrainConfig.sparse_nnz_cap={self.sparse_nnz_cap!r}: "
                f"must be an int >= 1")
        s = self.snapshot_every_steps
        if not isinstance(s, int) or isinstance(s, bool) or s < 0:
            raise ValueError(
                f"TrainConfig.snapshot_every_steps={s!r}: must be an "
                f"int >= 0 (0 = snapshots off)")
        k = self.snapshot_keep
        if not isinstance(k, int) or isinstance(k, bool) or k < 0:
            raise ValueError(
                f"TrainConfig.snapshot_keep={k!r}: must be an int >= 0 "
                "(0 = unlimited retention)")
        if self.sparse_feed and self.device_data == "off":
            raise ValueError(
                "TrainConfig.sparse_feed=True requires the staged "
                "(device-resident) feed — the on-device densify lives "
                "inside the staged executables; set device_data to "
                "'auto' or 'always'")
        unported = []
        if self.device_data not in ("auto", "always"):
            unported.append(f"device_data={self.device_data!r} (the port "
                            "always stages the base series: 'auto' or "
                            "'always')")
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
    on the CPU.  ``sparse_feed`` ships series to the device as padded-COO
    pages of ``sparse_nnz_cap`` columns a row (bit-identical outputs);
    ``quant`` stores the weights int8 or bf16 (``ops/quantize.py``)."""

    fused: bool = True
    page_windows: int | None = None
    coalesce_pages: int | None = None
    sparse_feed: bool = False
    sparse_nnz_cap: int = 64
    quant: str = "off"

    def __post_init__(self):
        if self.quant not in ("off", "int8", "bf16"):
            raise ValueError(
                f"InferConfig.quant={self.quant!r}: must be one of "
                "'off', 'int8', 'bf16'")
        if not isinstance(self.sparse_nnz_cap, int) \
                or isinstance(self.sparse_nnz_cap, bool) \
                or self.sparse_nnz_cap < 1:
            raise ValueError(
                f"InferConfig.sparse_nnz_cap={self.sparse_nnz_cap!r}: "
                f"must be an int >= 1")
        if self.page_windows is not None and self.page_windows < 1:
            raise ValueError(
                f"InferConfig.page_windows={self.page_windows}: must be "
                ">= 1 (or None for the device default)")
        if self.coalesce_pages is not None and self.coalesce_pages < 1:
            raise ValueError(
                f"InferConfig.coalesce_pages={self.coalesce_pages}: must "
                "be >= 1 (or None for the device default)")


@dataclasses.dataclass(frozen=True)
class SurfaceConfig:
    """Capacity-surface plane (serve/surface.py): precomputed what-if
    surfaces answering ``/v1/whatif`` and ``/v1/whatif/surface`` by
    multilinear interpolation, invalidated on every backend reload.

    ``grid`` is the per-axis scale ladder a surface sweeps around its
    base program; ``max_axes`` caps the grid dimensionality (more active
    endpoints than this collapse to one shared scale axis — vertex count
    is ``len(grid) ** axes``); ``jitter`` is the Monte-Carlo probe count
    behind the measured parity envelope.  ``max_surfaces``/``max_bytes``
    bound the host-resident LRU; ``warm_async`` builds cache-miss
    surfaces on a background thread (the miss answers from the frontier
    meanwhile) instead of inline.
    """

    enabled: bool = False
    grid: tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    max_axes: int = 3
    jitter: int = 8
    max_surfaces: int = 8
    max_bytes: int = 64 * 1024 * 1024
    warm_async: bool = True

    def __post_init__(self):
        for name in ("max_axes", "max_surfaces", "max_bytes"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"SurfaceConfig.{name}={v!r}: must be an int >= 1")
        if not isinstance(self.jitter, int) or isinstance(self.jitter, bool) \
                or self.jitter < 0:
            raise ValueError(
                f"SurfaceConfig.jitter={self.jitter!r}: must be an int >= 0")
        grid = tuple(float(g) for g in self.grid)
        if len(grid) < 2 or list(grid) != sorted(set(grid)) or grid[0] <= 0:
            raise ValueError(
                f"SurfaceConfig.grid={self.grid!r}: must be >= 2 strictly-"
                "increasing positive scales")


@dataclasses.dataclass(frozen=True)
class FeaturizeConfig:
    """Call-path feature-space construction (a field-for-field copy, so the
    ``config`` dict of a serialized ``CallPathSpace`` constructs it).

    The raw feature space is unbounded (one dimension per observed
    root-to-node call path; reference: resource-estimation/featurize.py:11-24).
    The model wants a static width, so the vector is materialized at a fixed
    ``capacity``; ``hash_features=True`` switches from a growable dictionary
    to stable hash-bucketing, so streaming corpora never change the width.
    """

    capacity: int = 0             # 0 = size to the observed space, rounded up
    round_to: int = 128           # pad capacity to a multiple
    hash_features: bool = False
    hash_seed: int = 0x5EED

    def __post_init__(self):
        if self.hash_features and self.capacity <= 0:
            raise ValueError(
                "hash_features=True requires an explicit capacity > 0 "
                "(there is no observed vocabulary to size the space from)"
            )


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    infer: InferConfig = dataclasses.field(default_factory=InferConfig)
