"""Typed configuration: the fields of ``deeprest_tpu/config.py`` that the
port reads.

``ModelConfig``, ``SurfaceConfig``, ``EtlConfig`` and ``QualityConfig``
are field-for-field copies (the
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
    takes "auto" (stages, and raises over ``device_data_max_bytes`` where
    the reference would host-feed) or "always" (stages), and ``elastic``
    only False; anything else raises.
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
class EtlConfig:
    """Host-ETL pipeline knobs (featurization + streaming ingest).

    The featurization firehose is host-side work (trace walking, hashing,
    counting) that must keep up with the device:
    ``workers`` shards offline corpus featurization across a forked
    process pool, and ``overlap`` moves the streaming trainer's
    tail→parse→featurize onto a background thread double-buffered against
    device fine-tuning, with ``queue_depth`` bounding the featurized-but-
    not-yet-ingested backlog (backpressure blocks the ETL thread, which
    in turn stops draining the tailer).
    """

    workers: int = 1              # offline featurize pool: 1 = serial, 0 = per-CPU
    queue_depth: int = 512        # buckets buffered between ETL and train threads
    overlap: bool = True          # background ETL thread in StreamingTrainer.run

    def __post_init__(self):
        if self.workers < 0:
            raise ValueError(f"EtlConfig.workers={self.workers}: must be >= 0")
        if self.queue_depth < 1:
            raise ValueError(
                f"EtlConfig.queue_depth={self.queue_depth}: must be >= 1")


@dataclasses.dataclass(frozen=True)
class QualityConfig:
    """Model-quality monitors + the drift→retrain→reload loop
    (obs/quality.py, train/stream.DriftController).

    The monitors watch the live bucket stream: feature-distribution
    drift (streaming per-call-path PSI/KS vs the training reference),
    rolling q-band coverage + pinball calibration, and the continuous
    not-justified-by-traffic anomaly check.  Every verdict stream runs
    through a hysteresis machine — separate enter/exit thresholds plus
    sustained-sweep counts — so one noisy window never flaps the
    surface.  ``auto_retrain`` is the act half: sustained drift triggers
    an out-of-cadence retrain on the retained rings, then a rolling
    reload into the serving plane (``retrain_cooldown_buckets`` bounds
    the loop's own thrash; ``auto_retrain=False`` is the manual
    override — verdicts only, a human pulls the trigger).
    """

    enabled: bool = False
    # sweep cadence (buckets between monitor passes) and the trailing
    # live window the drift score compares against the reference
    sweep_every_buckets: int = 30
    live_window: int = 120
    min_sweep_buckets: int = 8
    # Drift-reference anchor: the trailing this-many retained buckets at
    # (re)train time.  The verdict's question is "has the distribution
    # moved since the model last trained" — anchoring on the ring TAIL
    # (not the whole history) lets the verdict EXIT once a retrain has
    # adapted to the new regime, instead of forever comparing the live
    # stream against a pre/post mixture.
    reference_window: int = 240
    # hysteresis: enter/exit thresholds per stream + sustained counts
    drift_enter: float = 0.25          # traffic-mass-weighted PSI
    drift_exit: float = 0.10
    calibration_enter: float = 0.30    # undercoverage (nominal - observed)
    calibration_exit: float = 0.15
    anomaly_enter: float = 1.00        # mean normalized excess (≥ one
    anomaly_exit: float = 0.25         # full scale unit above the band)
    sustain_enter: int = 2
    sustain_exit: int = 2
    # calibration rolling window, in sweeps
    calibration_sweeps: int = 8
    # the continuous not-justified-by-traffic check's knobs (the same
    # meaning as the batch /v1/anomaly route's)
    anomaly_tolerance: float = 0.10
    anomaly_min_run: int = 5
    # Cold-start honesty: a stream's model in its first refreshes is
    # undertrained, and a bad band produces one-sided excess that is
    # indistinguishable from a real traffic-decoupled consumer.  The
    # model-CONDITIONED verdict streams (calibration, anomaly) therefore
    # arm only after this many
    # refreshes on the train plane; the serving plane arms immediately
    # (its checkpoint is trusted by definition of serving it).
    model_warmup_refreshes: int = 3
    # the act half (DriftController)
    auto_retrain: bool = True
    retrain_cooldown_buckets: int = 240
    # retraining ON anomalous data would teach the model the very
    # consumption the paper's sanity check exists to flag; default off
    retrain_during_anomaly: bool = False

    def __post_init__(self):
        for name in ("sweep_every_buckets", "live_window",
                     "min_sweep_buckets", "reference_window",
                     "sustain_enter", "sustain_exit",
                     "calibration_sweeps", "anomaly_min_run"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"QualityConfig.{name}={v!r}: must be an int >= 1")
        if self.retrain_cooldown_buckets < 0:
            raise ValueError(
                f"QualityConfig.retrain_cooldown_buckets="
                f"{self.retrain_cooldown_buckets}: must be >= 0")
        if not isinstance(self.model_warmup_refreshes, int) \
                or isinstance(self.model_warmup_refreshes, bool) \
                or self.model_warmup_refreshes < 0:
            raise ValueError(
                f"QualityConfig.model_warmup_refreshes="
                f"{self.model_warmup_refreshes!r}: must be an int >= 0")
        for enter, exit_ in (("drift_enter", "drift_exit"),
                             ("calibration_enter", "calibration_exit"),
                             ("anomaly_enter", "anomaly_exit")):
            if getattr(self, exit_) > getattr(self, enter):
                raise ValueError(
                    f"QualityConfig.{exit_} must be <= {enter} "
                    "(hysteresis needs exit at or below enter)")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    infer: InferConfig = dataclasses.field(default_factory=InferConfig)
    etl: EtlConfig = dataclasses.field(default_factory=EtlConfig)
    quality: QualityConfig = dataclasses.field(default_factory=QualityConfig)
