"""Typed configuration (``deeprest_tpu/config.py``).

Every section of the JAX package's ``Config`` is here, field for field,
with its defaults and validation messages, and ``Config`` has JAX's
``replace``, ``to_json``, ``from_dict`` and ``from_json``: a JAX config's
JSON loads here and writes back the same text.  ``rnn_backend`` is carried
for that reason only (and because a checkpoint sidecar's ``model_config``
constructs ``ModelConfig`` as it is): the port picks the recurrence from
the tensors' device (ops/gru.py), never from this field.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


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

    ``device_data``: "auto" stages the normalized base series on the
    device when they fit ``device_data_max_bytes`` and otherwise streams
    each step's windows from the host; "always" stages; "off" streams.
    Unlike the JAX trainer, "auto" stages on the CPU too (torch's CPU
    gather has no reason to avoid it).  The host-streamed feed keeps
    ``prefetch_depth`` steps' windows in flight (at least one).

    ``elastic``: survive the loss of ranks in-process (elastic remeshing,
    ``Trainer._run_epochs_elastic``): the survivors shrink the mesh's data
    axis, restore the newest cursor snapshot and carry on, so it needs
    ``snapshot_every_steps >= 1``.  ``remesh_max_attempts`` bounds the
    losses one run recovers from; ``remesh_backoff_ms`` (times the
    attempt) is slept before each rebuild.
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
    # host-fed steps whose windows are in flight ahead of the update
    prefetch_depth: int = 2
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
    remesh_max_attempts: int = 3
    remesh_backoff_ms: float = 100.0

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
        if self.device_data not in ("auto", "always", "off"):
            raise ValueError(
                f"TrainConfig.device_data={self.device_data!r}: must be "
                "'auto', 'always', or 'off'")
        a = self.remesh_max_attempts
        if not isinstance(a, int) or isinstance(a, bool) or a < 1:
            raise ValueError(
                f"TrainConfig.remesh_max_attempts={a!r}: must be an "
                "int >= 1 (the barrier must stay bounded)")
        if not isinstance(self.remesh_backoff_ms, (int, float)) \
                or isinstance(self.remesh_backoff_ms, bool) \
                or self.remesh_backoff_ms < 0:
            raise ValueError(
                f"TrainConfig.remesh_backoff_ms="
                f"{self.remesh_backoff_ms!r}: must be a number >= 0")
        if self.elastic and self.snapshot_every_steps < 1:
            raise ValueError(
                "TrainConfig.elastic=True requires snapshot_every_steps "
                ">= 1: the remesh barrier restores from cursor "
                "snapshots; without them a device loss would restart "
                "training from scratch silently")


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
class FleetConfig:
    """Fleet tier (``deeprest_tpu/config.py``; serve/fleet.py): M tenant
    applications on one serving plane through a checkpoint-keyed
    predictor pool.

    ``hbm_budget`` bounds how many tenants' weights stay device-resident
    (the LRU working set; evicted tenants spill to pinned host memory and
    restore with one host-to-device copy a tensor); ``aot`` checks the
    AOT sidecar at admission (serve/aot.py); ``top_k_tenants`` bounds
    per-tenant observability cardinality (/metrics labels, /healthz maps;
    the rest rolls up under ``__other__``); ``quality`` attaches one
    QualityMonitor per pool entry (per-tenant /v1/verdict).
    """

    enabled: bool = False
    hbm_budget: int = 4
    aot: bool = True
    top_k_tenants: int = 8
    quality: bool = True

    def __post_init__(self):
        for name in ("hbm_budget", "top_k_tenants"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"FleetConfig.{name}={v!r}: must be an int >= 1")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (obs/).  ``enabled`` gates the span recorder
    only; metrics counters are always live.  ``span_capacity`` bounds the
    in-process span ring (newest win)."""

    enabled: bool = False
    span_capacity: int = 4096

    def __post_init__(self):
        if self.span_capacity < 1:
            raise ValueError(
                f"ObsConfig.span_capacity={self.span_capacity}: must be "
                ">= 1")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device-mesh shape (parallel/mesh.py), one rank a device:
    ``data`` shards the batch (data parallelism, the gradients
    all-reduced), ``expert`` the stacked per-metric experts (each rank its
    ``E/expert``, the mixing sum all-reduced) and ``model`` the call-path
    feature dimension F of the mask and the layer-0 GRU input projections
    (tensor parallelism, the projection all-reduced), as the partition-rule
    table places them (parallel/sharding.py).  Each axis must divide what
    it shards: the batch size, E and F; a placement it does not divide
    raises naming the leaf and the axis, with the words of JAX's
    ``device_put`` ("should be divisible by N, but it is equal to ...")."""

    data: int = 1
    expert: int = 1
    model: int = 1

    @property
    def size(self) -> int:
        return self.data * self.expert * self.model

    @classmethod
    def parse(cls, spec: str) -> "MeshConfig":
        """``"D,E,M"`` → MeshConfig (the shared ``--mesh`` CLI contract
        for train, serve, predict and whatif)."""
        try:
            d, e, m = (int(x) for x in spec.split(","))
        except ValueError:
            raise ValueError(
                f"mesh spec {spec!r} is not data,expert,model") from None
        if min(d, e, m) < 1:
            raise ValueError(f"mesh spec {spec!r}: axis sizes must be >= 1")
        return cls(data=d, expert=e, model=m)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    featurize: FeaturizeConfig = dataclasses.field(
        default_factory=FeaturizeConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    etl: EtlConfig = dataclasses.field(default_factory=EtlConfig)
    infer: InferConfig = dataclasses.field(default_factory=InferConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    quality: QualityConfig = dataclasses.field(default_factory=QualityConfig)
    surface: SurfaceConfig = dataclasses.field(default_factory=SurfaceConfig)
    fleet: FleetConfig = dataclasses.field(default_factory=FleetConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "Config":
        """A config from a dict of sections (each optional); an unknown key
        raises naming the section's known keys, JSON lists become
        tuples."""
        def build(tp, section):
            known = {f.name for f in dataclasses.fields(tp)}
            kwargs = dict(section)
            unknown = set(kwargs) - known
            if unknown:
                raise ValueError(
                    f"unknown {tp.__name__} keys: {sorted(unknown)} "
                    f"(known: {sorted(known)})"
                )
            for k, v in kwargs.items():
                if isinstance(v, list):
                    kwargs[k] = tuple(v)
            return tp(**kwargs)

        return cls(**{f.name: build(f.default_factory, d.get(f.name, {}))
                      for f in dataclasses.fields(cls)})

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))
