"""Continuous retraining from a live, growing raw-data corpus
(``deeprest_tpu/train/stream.py``).

Tail the collector's JSONL as it grows (or poll live Jaeger/Prometheus, or
take pushed span batches over the wire), featurize buckets incrementally in
hash mode (fixed width), and periodically fine-tune the model from its
latest state on the device, re-checkpointing after every refresh in the
layout both packages read.

On a GPU every refresh fine-tunes through the port's ``Trainer``: the
staged base series, one eager update and one CUDA-graph capture of the
update (the staged tensors and the plan's shape change every refresh, so
the previous refresh's graph is dropped and its pool freed), then replays;
K2 and K3 carry the recurrence.  The evaluation and the drift monitor's
sweeps are forwards of the same module (K1).  Every thread but the train
thread (the overlapped ETL thread, the wire receiver's connection threads)
does host work only.

Not ported: the elastic fault barrier (``TrainConfig.elastic``, refused by
``config.py``) and the remesh deferral in ``ready()``; they come with the
multi-GPU work.

Design decisions, as in the JAX package:

- **Hash featurization only.**  Dictionary mode needs a global vocabulary
  pass and can change width; a stream has neither a "global" view nor any
  tolerance for shape changes.  `FeaturizeConfig(hash_features=True,
  capacity=F)` keeps the model input static forever.
- **Expanding min-max normalization.**  Stats are the monotone union of
  every refresh's observed range (never shrink).  Alternatives considered:
  frozen initial stats (reference semantics — breaks under drift: values
  outside the day-one range clip the model's usable dynamic range forever)
  and sliding-window stats (adapt both ways, but re-anchor the output scale
  every refresh, so two checkpoints' predictions are not comparable).  The
  monotone union keeps every checkpoint's de-normalization consistent with
  all earlier ones while still covering drifted ranges; windows are re-
  normalized with the current stats at every refresh.
- **Per-feature traffic stats.**  The offline path fits one scalar min/max
  over the whole traffic tensor (reference semantics,
  resource-estimation/qrnn.py:69-75) — fine for a one-shot corpus, where a
  hot column costs one normalization at worst.  Under the monotone-union
  rule a scalar is a ratchet: a single traffic spike on one hash column
  would permanently compress every other column's dynamic range.  Streaming
  therefore fits min/max **per feature column** (shape ``[1, F]``; the
  MinMaxStats contract is broadcast-shape-agnostic, so checkpoints,
  serving, and resume are unaffected).  A hot endpoint then saturates only
  its own column.  Columns whose observed range is degenerate get derived
  *effective* stats — their own level if constant-nonzero, the global max
  if never active — because MinMaxStats passes zero-range columns through
  raw, which would feed unnormalized serve-time traffic to the model the
  first time such a column activates.  The honest observed union is kept
  separately (and persisted in the checkpoint sidecar) so a column that
  merely goes quiet for one refresh is not misdetected as never-active
  and ratcheted up to the global scale.
- **Bounded refresh cost.**  ``refresh()`` re-windows and fine-tunes over
  the retained corpus — deliberately *not* incremental, so every refresh
  sees the newest normalization of the oldest data.  Cost is bounded by
  ``history_max``: at most ``history_max - window_size`` windows ≈
  ``finetune_epochs * history_max / batch_size`` train steps per refresh
  (batch padding in Trainer._batches).  At defaults that is ≤ 256 steps per refresh, forever.
- **Frozen metric set.**  The expert axis E is part of the model's shape.
  The metric set freezes at the first refresh; components that stop
  reporting fill with zeros, metrics that appear later are dropped (warned
  once).  Restarting the stream from its checkpoint re-adopts the frozen
  set.
- **Recency-holdout eval.**  Each refresh trains on all windows but the
  trailing ``eval_holdout`` and evaluates on those — the stream's notion of
  "unseen" is "newest", which is what capacity planning on drifting traffic
  actually faces.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Iterator

import numpy as np

from deeprest_tpu_torch.config import Config, FeaturizeConfig
from deeprest_tpu_torch.data.featurize import CallPathSpace
from deeprest_tpu_torch.data.schema import Bucket
from deeprest_tpu_torch.data.windows import (
    MinMaxStats, minmax_fit, sliding_windows,
)
from deeprest_tpu_torch.device import resolve_device
from deeprest_tpu_torch.obs import metrics as obs_metrics
from deeprest_tpu_torch.obs import spans as obs_spans
from deeprest_tpu_torch.ops.densify import sparse_minmax
from deeprest_tpu_torch.train.data import (
    DatasetBundle, SeriesRing, SparseSeriesRing, delta_mask, to_increments,
)
from deeprest_tpu_torch.train.trainer import Trainer, TrainState


class BucketTailer:
    """Incrementally parse complete JSONL lines appended to a growing file.

    Safe against torn tails: only lines terminated by a newline are parsed;
    a partially-written last line stays buffered until its newline arrives.
    The file may not exist yet at construction (collector still booting).

    Rotation is ZERO-LOSS for every generation that exists at some poll
    instant: the tailer holds the file open between polls, so a rename/
    unlink rotation leaves the old inode readable through the held fd; the
    tailer drains it to EOF (however many capped polls that takes) before
    switching.  While draining, each poll also checks the path and opens a
    handle to any NEW generation it sees, so successive rotations during a
    long drain queue up instead of vanishing (``_pending``).  (Cost: a
    rotated-away file's disk space lives until its drain finishes.)  Two
    residual lossy cases, all documented: a generation created AND rotated
    away entirely between two polls was never observable; truncate-in-place
    (same inode shrinks) overwrites its tail before the tailer can see it —
    counted in ``truncated_events``; and a producer that keeps appending to
    a rotated-away or unlinked file more than one poll interval after the
    tailer last saw data there (the switch waits one extra EOF poll as
    grace for exactly this writer-keeps-fd rotation style).
    """

    # Per-poll read cap: a cold start against a month-scale backlog (tens
    # of GB) must stream through bounded memory, not parse the whole delta
    # into one Python list.  The run loop drains the backlog across successive polls, refreshing along
    # the way.
    MAX_POLL_BYTES = 64 << 20
    # Wall-clock grace between a rotated-away generation's first observed
    # EOF and the switch away from it: a rename-rotation writer keeps its
    # fd (and may still flush a torn line's remainder) until it reopens
    # the path.
    GRACE_S = 0.25

    def __init__(self, path: str, max_poll_bytes: int | None = None):
        self.path = path
        self._f = None                  # persistent handle (see class doc)
        self._pending = []              # successor-generation fds, in order
        self._carry = b""
        self.max_poll_bytes = max_poll_bytes or self.MAX_POLL_BYTES
        # True when more data is already on disk (read cap hit, or a drained
        # rotation left a fresh file pending): poll again without sleeping.
        self.backlog = False
        # Malformed complete lines are skipped, never wedge the stream — but
        # visibly: counted here and logged, so a corrupted producer degrades
        # to a diagnosable signal instead of silent "no data".
        self.dropped = 0
        # Truncate-in-place occurrences — the only rotation style that can
        # still lose data (its loss is unquantifiable: the overwritten tail
        # was never observable).
        self.truncated_events = 0
        # Wall-clock instant the current (rotated-away or unlinked)
        # generation was first seen at EOF — the switch grace anchor (see
        # poll()).  Wall-clock, not a poll count: callers may re-poll
        # microseconds apart (run() skips its sleep after a non-empty
        # poll), which would make a counted grace effectively zero.
        self._eof_since: float | None = None

    def close(self) -> None:
        """Release every held file handle.  For shutdown: a reused tailer
        would re-read the path from the start (duplicates)."""
        if self._f is not None:
            self._f.close()
            self._f = None
        for f in self._pending:
            f.close()
        self._pending.clear()
        self._carry = b""

    def _parse(self, chunk: bytes) -> list[Bucket]:
        data = self._carry + chunk
        lines = data.split(b"\n")
        self._carry = lines.pop()  # empty when data ends with a newline
        buckets = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                buckets.append(Bucket.from_dict(json.loads(line)))
            except (ValueError, KeyError, TypeError):
                self.dropped += 1
                # First drop verbatim, then every 1000th — a half-garbage
                # backlog must not stall the poll loop on print I/O.
                if self.dropped == 1 or self.dropped % 1000 == 0:
                    print(f"stream: dropped malformed line "
                          f"(total {self.dropped}) from {self.path} "
                          f"({line[:80]!r})")
        return buckets

    def _watch_for_rotation(self) -> None:
        """Open a handle to a new path generation the moment it is seen, so
        rotations during a long drain queue up instead of vanishing."""
        try:
            st = os.stat(self.path)
        except OSError:
            return
        tail = self._pending[-1] if self._pending else self._f
        tst = os.fstat(tail.fileno())
        if (st.st_ino, st.st_dev) == (tst.st_ino, tst.st_dev):
            return
        try:
            nf = open(self.path, "rb")
        except OSError:
            return  # rotated away again before we could open; retry next poll
        nst = os.fstat(nf.fileno())
        if (nst.st_ino, nst.st_dev) == (tst.st_ino, tst.st_dev):
            nf.close()  # raced back to the generation we already hold
            return
        self._pending.append(nf)
        print(f"stream: {self.path} was rotated; current generation will "
              f"be drained first (zero loss), new generation queued "
              f"({len(self._pending)} pending)")

    def poll(self) -> list[Bucket]:
        out: list[Bucket] = []
        # Second iteration only after a generation switch, so new data is
        # returned in the same poll that finished the old generation (at
        # most 2 × max_poll_bytes per poll).
        for attempt in (0, 1):
            if self._f is None:
                if self._pending:
                    self._f = self._pending.pop(0)
                else:
                    try:
                        self._f = open(self.path, "rb")
                    except OSError:
                        # File absent (producer still booting / rotating):
                        # clear the backlog flag or run() would busy-spin
                        # instead of sleeping between polls.
                        self.backlog = False
                        return out
                self._carry = b""
            chunk = self._f.read(self.max_poll_bytes)
            if chunk:
                self._eof_since = None
                out.extend(self._parse(chunk))
            fst = os.fstat(self._f.fileno())
            pos = self._f.tell()
            if fst.st_size < pos:
                # Truncated in place (same inode shrank): the old tail is
                # unrecoverable and what it held beyond `pos` was never
                # observable.  Re-read from the top.
                self.truncated_events += 1
                print(f"stream: {self.path} TRUNCATED in place (size "
                      f"{fst.st_size} < consumed {pos}); unread old-tail "
                      f"data is lost (event {self.truncated_events}); "
                      f"re-reading from start")
                self._f.seek(0)
                self._carry = b""
                self.backlog = True
                if attempt == 0:
                    continue
                return out
            self._watch_for_rotation()
            if fst.st_size > pos:
                # Current generation not yet drained (read cap hit).
                self.backlog = True
                return out
            if not self._pending:
                # At EOF of the newest known generation: idle.  (If the
                # path rotated but the open raced, _watch retries next
                # poll; the held fd keeps the data safe meanwhile.)  If
                # the path itself is gone — unlinked with nothing
                # recreated — holding the drained fd would pin the
                # unlinked inode's disk space for the process lifetime:
                # release it after flushing the carry.  Appends a
                # still-running producer makes to the unlinked file after
                # this point are a documented residual loss.
                try:
                    os.stat(self.path)
                except OSError:
                    now = time.monotonic()
                    if self._eof_since is None:
                        self._eof_since = now
                    elif now - self._eof_since >= self.GRACE_S:
                        if self._carry:
                            out.extend(self._parse(b"\n"))
                        self._f.close()
                        self._f = None
                        self._eof_since = None
                self.backlog = False
                return out
            # Drained a rotated-away generation — but a momentary EOF is
            # not proof the producer is done: a standard rename-rotation
            # writer keeps its fd (and may still flush a torn line's
            # remainder) until it reopens the path.  Hold the fd for
            # GRACE_S of WALL CLOCK after the first EOF sighting before
            # switching; only then is an unterminated final line treated
            # as complete and flushed.  (backlog stays False meanwhile so
            # a sleeping caller isn't spun; an eager caller re-polling
            # instantly still cannot shrink the wall-clock grace.)
            now = time.monotonic()
            if self._eof_since is None:
                self._eof_since = now
            if now - self._eof_since < self.GRACE_S:
                self.backlog = False
                return out
            if self._carry:
                out.extend(self._parse(b"\n"))
            self._f.close()
            self._f = None
            self._eof_since = None
            print(f"stream: {self.path} rotation drain complete (zero "
                  f"loss); switching to the next generation "
                  f"({len(self._pending)} queued)")
            self.backlog = True
            if attempt == 0:
                continue
            return out
        return out


def expand_minmax(old: MinMaxStats | None, new: MinMaxStats) -> MinMaxStats:
    """Monotone union of observed ranges (see module docstring)."""
    if old is None:
        return new
    return MinMaxStats(
        min=np.minimum(old.min, new.min),
        max=np.maximum(old.max, new.max),
    )


@dataclasses.dataclass
class StreamConfig:
    refresh_buckets: int = 60        # fine-tune after this many new buckets
    finetune_epochs: int = 2
    history_max: int = 4096          # retained buckets (memory bound)
    eval_holdout: int = 8            # newest windows held out per refresh
    poll_interval_s: float = 0.5
    keep_checkpoints: int = 3        # newest steps retained (disk bound)


@dataclasses.dataclass
class RefreshResult:
    refresh: int
    num_buckets: int                 # retained corpus length at refresh time
    train_loss: float
    eval_loss: float
    checkpoint_path: str | None
    # What fired this refresh: "cadence" (the refresh_buckets counter),
    # "drift" (DriftController auto-trigger), or "manual"
    # (DriftController.force_retrain).
    trigger: str = "cadence"
    # Host-ETL health counters (filled by run(); zero for direct refresh()
    # calls).  etl_stall_s is the train thread's host-ETL cost since the
    # previous refresh: with overlap OFF it is time spent featurizing
    # inline; with overlap ON it is time spent blocked on the ETL queue
    # for data that did arrive (idle waits on a quiet source don't count —
    # that is the source's cadence, not ETL falling behind).
    etl_stall_s: float = 0.0
    # Buckets featurized by the ETL thread but not yet ingested when this
    # refresh started (queue depth = how far ETL ran ahead; 0 when serial).
    etl_lag_buckets: int = 0
    # Cumulative malformed lines dropped by the tailer.
    etl_dropped: int = 0
    # The port's own record of the refresh: fine-tune steps taken, CUDA
    # graphs captured (one per refresh on a GPU: the staged series grew),
    # and the seconds of its stages ("prepare" the host windowing and
    # stats, "stage" the copy to the device, "finetune" the epochs with
    # "capture" the part of them spent capturing, "eval", "checkpoint"
    # the write and pruning).
    steps: int = 0
    captures: int = 0
    seconds: dict = dataclasses.field(default_factory=dict)


class StreamingTrainer:
    """Tail → featurize → fine-tune → checkpoint, repeatedly.

    >>> st = StreamingTrainer(config, stream_cfg, ckpt_dir="/ckpts")
    >>> for result in st.run(tailer):           # forever, or until stopped
    ...     print(result.refresh, result.eval_loss)
    """

    def __init__(self, config: Config, stream: StreamConfig,
                 ckpt_dir: str | None = None,
                 feature_config: FeaturizeConfig | None = None,
                 device=None, recurrence=None):
        """``device``: where the embedded trainer runs (None means CUDA,
        which raises without a GPU; pass "cpu" for the plain PyTorch
        path).  ``recurrence`` replaces the device dispatch of the GRU
        recurrence in training, evaluation and the drift sweeps (as in
        ``Trainer``)."""
        fc = feature_config or FeaturizeConfig(
            hash_features=True, capacity=config.model.feature_dim)
        if not fc.hash_features or fc.capacity <= 0:
            raise ValueError(
                "streaming requires hash featurization with fixed capacity "
                "(see module docstring)")
        self.device = resolve_device(device)
        self.recurrence = recurrence
        self.config = config
        self.stream = stream
        self.ckpt_dir = ckpt_dir
        self.space = CallPathSpace(config=fc).freeze()
        # Retained corpus: preallocated contiguous rings (train/data.py
        # SeriesRing), not deques of per-bucket arrays — ingest featurizes
        # straight into the traffic ring's next slot (zero allocation on
        # the poll/ETL path) and refresh() windows the zero-copy contiguous
        # views in O(1) instead of re-stacking O(history) rows.
        #
        # Sparse-first mode (TrainConfig.sparse_feed — the 10k-endpoint
        # tier): the traffic half is a padded-COO SparseSeriesRing
        # instead, ingested via extract_sparse and fed to the device as
        # (cols, vals) with a single on-device densify inside each
        # update; no dense [T, F] (or [N, W, F]) traffic tensor ever
        # materializes on this path — ~F/(2K) less ring memory AND feed
        # bytes at F=10240, with refresh losses bit-identical to the
        # dense reference.  Targets stay dense (E is small).
        self.sparse = bool(config.train.sparse_feed)
        if self.sparse:
            self.traffic = SparseSeriesRing(
                stream.history_max, self.space.capacity,
                config.train.sparse_nnz_cap)
        else:
            self.traffic = SeriesRing(stream.history_max,
                                      self.space.capacity)
        self.metrics: deque[dict[str, float]] = deque(maxlen=stream.history_max)
        # Targets ring mirrors the metrics deque as float32 rows once the
        # metric set freezes (same [t, i] = v writes _targets() used to do
        # per refresh, done once per bucket instead of once per refresh).
        self._target_ring: SeriesRing | None = None
        self._name_pos: dict[str, int] | None = None
        self.metric_names: list[str] | None = None
        self.trainer: Trainer | None = None
        self.state: TrainState | None = None
        self.x_stats: MinMaxStats | None = None
        self.y_stats: MinMaxStats | None = None
        # honest observed per-column traffic ranges (x_stats are derived
        # from this each refresh — module docstring, per-feature stats)
        self.x_union: MinMaxStats | None = None
        self._warned_new_metrics: set[str] = set()
        self._pending = 0
        self._refresh_count = 0
        # Monotone ingest watermark (buckets ever committed, across
        # resumes): rides in every checkpoint/snapshot sidecar so a
        # restarted stream knows how far the corpus had advanced — the
        # retained-ring half of the preemption cursor.
        self._ingested_total = 0
        # The active stream source (set by run()) and the source-side
        # half of the watermark convention it shares with the sidecar:
        # sources exposing ingest_watermark()/resume_from() — the wire
        # receiver (data/wire.py) and LiveEndpointTailer — persist their
        # cursor next to _ingested_total and get it back on resume, so a
        # restarted stream never double-counts replayed spans.
        self._source = None
        self._resume_source_watermark: dict | None = None
        # Set on resume: the delta mask the restored params were TRAINED
        # with.  refresh() must keep using it — y_stats and params both
        # encode the target space, so silently switching a resumed stream
        # to this config's delta_resources would collapse the normalized
        # range and cumsum level-scale outputs.
        self._resumed_delta_mask: np.ndarray | None = None
        # The drift→retrain loop (DriftController via attach_quality):
        # on_bucket fires after every ingest, on_refresh after every
        # fine-tune; request_refresh() below is its trigger.
        self.quality: "DriftController | None" = None
        self._force_refresh: str | None = None
        self._maybe_resume()

    # -- ingestion ------------------------------------------------------

    def ingest(self, bucket: Bucket) -> None:
        if self.sparse:
            # The sparse ingest never touches a [capacity]-wide buffer:
            # extract_sparse returns the bucket's (cols, counts) pair and
            # the ring stores it padded to the K cap.
            row = self.space.extract_sparse(bucket.traces)
            self.traffic.append_sparse(*row)
        else:
            # extract(out=...) fills the ring's next slot in place: no
            # fresh [capacity] float32 per bucket on the poll thread.
            row = self.space.extract(bucket.traces,
                                     out=self.traffic.append_slot())
        metrics_row = {m.key: m.value for m in bucket.metrics}
        self._commit_metrics(metrics_row)
        if self.quality is not None:
            self.quality.on_bucket(row, metrics_row)

    def _featurize(self, bucket: Bucket) -> tuple:
        """Featurize off the train thread (overlap mode): the returned row
        (dense [capacity] vector, or a sparse ``(cols, vals)`` pair) is
        owned by the caller and committed later via _ingest_featurized,
        so the shared rings are only ever touched by the train thread."""
        row = (self.space.extract_sparse(bucket.traces) if self.sparse
               else self.space.extract(bucket.traces))
        return (row, {m.key: m.value for m in bucket.metrics})

    def _ingest_featurized(self, feat: tuple) -> None:
        row, metrics_row = feat
        if self.sparse:
            self.traffic.append_sparse(*row)
        else:
            self.traffic.append_slot()[:] = row
        self._commit_metrics(metrics_row)
        if self.quality is not None:
            self.quality.on_bucket(row, metrics_row)

    def _commit_metrics(self, row: dict[str, float]) -> None:
        self.metrics.append(row)
        if self._target_ring is not None:
            self._append_target_row(row)
        self._pending += 1
        self._ingested_total += 1

    def _append_target_row(self, row: dict[str, float]) -> None:
        slot = self._target_ring.append_slot()
        slot[:] = 0.0
        for k, v in row.items():
            i = self._name_pos.get(k)
            if i is None:
                if k not in self._warned_new_metrics:
                    self._warned_new_metrics.add(k)
                    print(f"stream: metric {k!r} appeared after the "
                          "metric set froze; dropping it")
                continue
            slot[i] = v

    @property
    def num_buckets(self) -> int:
        return len(self.traffic)

    def clear_history(self) -> None:
        """Drop every retained bucket (traffic, metrics, targets) while
        keeping the frozen metric set, stats, and model state — the
        history-rotation scenario the quiet-column stats policy covers."""
        self.traffic.clear()
        self.metrics.clear()
        if self._target_ring is not None:
            self._target_ring.clear()

    def _ensure_target_ring(self) -> None:
        """Build the float32 targets ring for the frozen metric set and
        backfill it from the retained metric dicts (one-time O(history);
        every later bucket appends incrementally)."""
        self._name_pos = {n: i for i, n in enumerate(self.metric_names)}
        self._target_ring = SeriesRing(self.stream.history_max,
                                       len(self.metric_names))
        for row in self.metrics:
            self._append_target_row(row)

    def _freeze_metrics(self) -> list[str]:
        if self.metric_names is None:
            union: set[str] = set()
            for row in self.metrics:
                union |= set(row)
            self.metric_names = sorted(union)
            self._ensure_target_ring()
        return self.metric_names

    def _targets(self) -> np.ndarray:
        """Zero-copy [T, E] float32 target matrix for the retained corpus.

        Incrementally maintained (_append_target_row writes the identical
        ``out[t, i] = v`` float32 conversions the historical per-refresh
        rebuild performed, so the matrix is bit-identical to a full
        recompute).  Valid until the next
        ingest (SeriesRing.view contract)."""
        self._freeze_metrics()
        return self._target_ring.view()

    # -- refresh --------------------------------------------------------

    def attach_quality(self, controller: "DriftController") -> None:
        """Wire the drift→retrain loop: ``controller.on_bucket`` fires
        after every ingest (both ETL modes — ingest happens on the train
        thread either way), ``controller.on_refresh`` after every
        fine-tune."""
        self.quality = controller

    def request_refresh(self, reason: str = "manual") -> None:
        """Queue an out-of-cadence refresh (the DriftController's
        trigger): the next readiness check fires a fine-tune regardless
        of the ``refresh_buckets`` counter, provided the corpus is big
        enough to train at all.  The reason rides in
        ``RefreshResult.trigger``."""
        self._force_refresh = reason

    def current_delta_mask(self) -> np.ndarray:
        """The delta mask the CURRENT params encode (the resumed
        checkpoint's when one exists — see refresh())."""
        if self._resumed_delta_mask is not None:
            return self._resumed_delta_mask
        return delta_mask(self._freeze_metrics(),
                          self.config.train.delta_resources)

    def ready(self) -> bool:
        w = self.config.train.window_size
        min_windows = self.stream.eval_holdout + 2
        due = (self._pending >= self.stream.refresh_buckets
               or self._force_refresh is not None)
        return due and self.num_buckets > w + min_windows

    def refresh(self) -> RefreshResult:
        """Fine-tune on the retained corpus; returns the refresh record."""
        trigger, self._force_refresh = (self._force_refresh or "cadence",
                                        None)
        sw = obs_metrics.Stopwatch()
        w = self.config.train.window_size
        # Zero-copy contiguous views of the retained corpus (SeriesRing):
        # assembly is O(1) where the deque-era np.stack + per-dict target
        # rebuild were O(history).  Both views are consumed (normalized or
        # windowed into device tensors) before refresh returns, within the
        # rings' validity window.
        raw_targets = self._targets()
        # Level-type resources train as per-bucket increments (the same
        # transform prepare_dataset applies — train/data.py).  Recomputed
        # over the full retained series each refresh, so there is no
        # cross-chunk carry to track; the deque holds raw levels.  A
        # resumed stream keeps the mask its checkpoint was trained with
        # (_maybe_resume) — the restored y_stats/params encode it.
        dmask = delta_mask(self._freeze_metrics(),
                           self.config.train.delta_resources)
        if self._resumed_delta_mask is not None:
            if not np.array_equal(dmask, self._resumed_delta_mask):
                print("stream: config delta_resources disagrees with the "
                      "resumed checkpoint's delta mask; keeping the "
                      "checkpoint's (retrain from scratch to change it)")
            dmask = self._resumed_delta_mask
        targets = to_increments(raw_targets, dmask)

        if self.sparse:
            # Sparse-first: no dense traffic tensor, windowed or
            # otherwise, ever materializes here.  Window counts follow
            # sliding_windows semantics (N = T - w) and the per-feature
            # stats come from the padded-COO rows directly —
            # sparse_minmax is bit-identical to minmax_fit over the
            # equivalent dense train-span windows (the span rows
            # [0, split + w - 1) ARE the train windows' union, the same
            # equivalence prepare_dataset relies on).
            cols_v, vals_v, nnz_v = self.traffic.view()
            n_windows = len(self.traffic) - w
            x = None
        else:
            traffic = self.traffic.view()
            x = sliding_windows(traffic, w)
            n_windows = len(x)
        y = sliding_windows(targets, w)
        holdout = min(self.stream.eval_holdout, n_windows - 1)
        split = n_windows - holdout

        # Expanding stats: union with every past refresh (monotone), fit
        # per column — traffic per feature, targets per metric (module
        # docstring: "Per-feature traffic stats").
        if self.sparse:
            new_x_stats = sparse_minmax(cols_v, vals_v, nnz_v,
                                        split + w - 1, self.space.capacity)
        else:
            new_x_stats = minmax_fit(x, split, axis=(0, 1))
        self.x_union = expand_minmax(self.x_union, new_x_stats)
        self.y_stats = expand_minmax(self.y_stats,
                                     minmax_fit(y, split, axis=(0, 1)))
        # Effective traffic stats: degenerate columns would pass serve-time
        # values through raw (MinMaxStats zero-range passthrough), so give
        # them a usable scale — their own level if constant-nonzero, the
        # global max if never active.  Derived from the honest union every
        # refresh, so a column that merely went quiet keeps its own range.
        union = self.x_union
        degenerate = np.asarray(union.range == 0.0)
        glob = np.float32(np.max(union.max))
        self.x_stats = MinMaxStats(
            min=np.where(degenerate, np.minimum(union.min, 0.0),
                         union.min).astype(np.float32),
            max=np.where(degenerate,
                         np.where(union.max > 0, union.max, glob),
                         union.max).astype(np.float32))

        y_n = self.y_stats.apply(y).astype(np.float32)
        if self.sparse:
            # RAW cols/vals ride in the bundle (zero-copy ring views,
            # consumed by stage_dataset before refresh returns);
            # normalization happens on device with the staged stats.
            bundle = DatasetBundle(
                x_train=None, y_train=y_n[:split],
                x_test=None, y_test=y_n[split:],
                x_stats=self.x_stats, y_stats=self.y_stats,
                metric_names=self._freeze_metrics(), split=split,
                window_size=w, space_dict=self.space.to_dict(),
                delta_mask=dmask, raw_targets=raw_targets,
                x_base=None,
                y_base=self.y_stats.apply(targets).astype(np.float32),
                x_cols=cols_v, x_vals=vals_v, x_nnz=nnz_v,
                sparse_capacity=self.space.capacity,
                n_train=split, n_test=n_windows - split,
            )
        else:
            x_n = self.x_stats.apply(x).astype(np.float32)
            bundle = DatasetBundle(
                x_train=x_n[:split], y_train=y_n[:split],
                x_test=x_n[split:], y_test=y_n[split:],
                x_stats=self.x_stats, y_stats=self.y_stats,
                metric_names=self._freeze_metrics(), split=split,
                window_size=w, space_dict=self.space.to_dict(),
                delta_mask=dmask, raw_targets=raw_targets,
                x_base=self.x_stats.apply(traffic).astype(np.float32),
                y_base=self.y_stats.apply(targets).astype(np.float32),
            )

        seconds = {"prepare": sw.elapsed()}
        if self.trainer is None:
            model = dataclasses.replace(
                self.config.model, feature_dim=self.space.capacity,
                num_metrics=len(bundle.metric_names))
            self.config = dataclasses.replace(self.config, model=model)
            self.trainer = self._make_trainer(bundle.metric_names)
            self._wire_snapshots()
        if self.state is None:
            self.state = self.trainer.init_state()

        tr = self.trainer
        data_rng = np.random.default_rng(
            self.config.train.seed + self._refresh_count)
        train_loss = float("nan")
        # Device-resident feed for the fine-tune epochs, re-staged each
        # refresh (the series grew).  The previous refresh's staged series
        # go first and its captured update retires: the first update of
        # this refresh runs eagerly and is captured into the retired
        # graph's memory pool, the rest replay.
        sw.restart()
        tr.release_staged(self.state)
        staged = tr.stage_dataset(bundle)
        seconds["stage"] = sw.elapsed()
        step0, captures0 = tr.global_step, tr.captures
        capture_s0 = tr.capture_seconds
        sw.restart()
        for _ in range(self.stream.finetune_epochs):
            self.state, train_loss = tr.train_epoch(
                self.state, bundle, data_rng, staged=staged)
        seconds["finetune"] = sw.elapsed()
        seconds["capture"] = tr.capture_seconds - capture_s0
        sw.restart()
        eval_loss, _ = tr.evaluate(self.state, bundle, staged=staged)
        seconds["eval"] = sw.elapsed()
        del staged

        path = None
        self._pending = 0
        self._refresh_count += 1
        sw.restart()
        if self.ckpt_dir:
            # The counter rides in the checkpoint sidecar so it is bound
            # atomically to the step it describes — a crash can never leave
            # counter and params disagreeing.
            path = self.trainer.save(
                self.ckpt_dir, self.state, bundle,
                extra_host_state={
                    "stream_refresh_count": self._refresh_count,
                    "stream_x_union": self.x_union.to_dict(),
                    "stream_ring_watermark": self._ring_watermark(),
                })
            from deeprest_tpu_torch.train.checkpoint import prune_checkpoints

            prune_checkpoints(self.ckpt_dir, self.stream.keep_checkpoints)
        seconds["checkpoint"] = sw.elapsed()
        result = RefreshResult(
            refresh=self._refresh_count, num_buckets=self.num_buckets,
            train_loss=train_loss, eval_loss=float(eval_loss),
            checkpoint_path=path, trigger=trigger,
            steps=tr.global_step - step0, captures=tr.captures - captures0,
            seconds=seconds)
        if self.quality is not None:
            # After the checkpoint is on disk: the controller re-anchors
            # the drift reference to what these params just trained on
            # and (for drift/manual triggers) hot-swaps the serving plane.
            self.quality.on_refresh(result)
        return result

    def _make_trainer(self, metric_names: list[str]) -> Trainer:
        return Trainer(self.config, self.space.capacity, metric_names,
                       device=self.device, recurrence=self.recurrence)

    # -- preemption snapshots -------------------------------------------

    def _ring_watermark(self) -> dict:
        """The retained-ring half of the preemption cursor: how far the
        corpus had advanced when this checkpoint was cut.  When the
        active source speaks the watermark convention (wire receiver,
        live tailer), its own cursor rides along under ``source`` so
        resume can hand it back via ``resume_from`` — the stream and its
        source re-anchor on the SAME instant and replays dedup instead
        of double-counting."""
        out = {
            "ingested_total": int(self._ingested_total),
            "retained_buckets": int(self.num_buckets),
            "pending_buckets": int(self._pending),
        }
        wm_fn = getattr(self._source, "ingest_watermark", None)
        if callable(wm_fn):
            sw = wm_fn()
            if isinstance(sw, dict):
                out["source"] = sw
        return out

    def _snapshot_extra(self) -> dict:
        out = {
            "stream_refresh_count": self._refresh_count,
            "stream_ring_watermark": self._ring_watermark(),
        }
        if self.x_union is not None:
            out["stream_x_union"] = self.x_union.to_dict()
        return out

    def _wire_snapshots(self) -> None:
        """Mid-refresh preemption snapshots (TrainConfig.
        snapshot_every_steps > 0): every N fine-tune steps the embedded
        trainer checkpoints atomically WITH the full stream sidecar
        (frozen metric set, stats, refresh counter, retained-ring
        watermarks via ``extra_fn``), so a stream killed mid-refresh
        resumes from params at most N steps stale instead of losing the
        whole refresh — _maybe_resume adopts a snapshot exactly like a
        refresh checkpoint.  The stream deliberately does NOT plan-replay
        the interrupted fine-tune (its refresh loop re-trains over the
        retained corpus every cycle anyway); the epoch-plan cursor
        resume is Trainer.resume_training's offline contract."""
        n = self.config.train.snapshot_every_steps
        if n and self.ckpt_dir and self.trainer is not None:
            self.trainer.enable_snapshots(self.ckpt_dir, n,
                                          extra_fn=self._snapshot_extra)

    # -- resume ---------------------------------------------------------

    def _maybe_resume(self) -> None:
        """Adopt the latest checkpoint's frozen state (metric set, stats,
        params) so a restarted stream continues rather than restarts."""
        if not self.ckpt_dir:
            return
        from deeprest_tpu_torch.train.checkpoint import (
            list_steps, load_sidecar,
        )

        # Newest step with a readable sidecar: a crash between the arrays
        # and the sidecar write leaves an incomplete step dir, which
        # must not wedge resume from the last complete one.
        step = extra = None
        for candidate in reversed(list_steps(self.ckpt_dir)):
            extra = load_sidecar(self.ckpt_dir, candidate, missing_ok=True)
            if extra is not None:
                step = candidate
                break
            print(f"stream: checkpoint step {candidate} has no sidecar "
                  "(crash mid-save?); falling back to the previous one")
        if step is None:
            return
        feature_dim = int(extra["feature_dim"])
        if feature_dim != self.space.capacity:
            raise ValueError(
                f"checkpoint feature_dim {feature_dim} != "
                f"stream capacity {self.space.capacity}")
        self.metric_names = list(extra["metric_names"])
        self._ensure_target_ring()
        self.x_stats = MinMaxStats.from_dict(extra["x_stats"])
        self.y_stats = MinMaxStats.from_dict(extra["y_stats"])
        # The delta mask the checkpoint was trained with.  Pre-delta
        # sidecars have no key: those params predict absolute levels, so
        # resume with the transform OFF rather than silently flipping the
        # target semantics under restored y_stats/params.
        dm = extra.get("delta_mask")
        if dm is not None:
            self._resumed_delta_mask = np.asarray(dm, bool)
        else:
            self._resumed_delta_mask = np.zeros(len(self.metric_names), bool)
            if delta_mask(self.metric_names,
                          self.config.train.delta_resources).any():
                print("stream: checkpoint predates the delta formulation; "
                      "resuming with absolute-level targets (retrain from "
                      "scratch to adopt delta_resources)")
        # Old checkpoints predate the honest union; effective stats are the
        # closest available stand-in (slightly sticky for dead columns).
        self.x_union = MinMaxStats.from_dict(
            extra.get("stream_x_union", extra["x_stats"]))
        model = dataclasses.replace(
            self.config.model, feature_dim=feature_dim,
            num_metrics=len(self.metric_names))
        self.config = dataclasses.replace(self.config, model=model)
        self.trainer = self._make_trainer(self.metric_names)
        self._wire_snapshots()
        # params, step, Adam's moments and count (either package's layout)
        self.state, _ = self.trainer.restore_state(self.ckpt_dir, step)
        try:
            self._refresh_count = int(extra.get("stream_refresh_count", 0))
        except (TypeError, ValueError):
            print("stream: checkpoint carries a malformed "
                  "stream_refresh_count; numbering restarts at 0")
        wm = extra.get("stream_ring_watermark")
        if isinstance(wm, dict):
            try:
                # continue the monotone ingest watermark across restarts
                self._ingested_total = int(wm.get("ingested_total", 0))
            except (TypeError, ValueError):
                pass
            sw = wm.get("source")
            if isinstance(sw, dict):
                # handed to the source in run() via resume_from()
                self._resume_source_watermark = sw
        print(f"stream: resumed from {self.ckpt_dir} "
              f"(refresh {self._refresh_count}, "
              f"{len(self.metric_names)} metrics frozen)")

    # -- the run loop -------------------------------------------------

    def run(self, tailer: BucketTailer,
            max_refreshes: int | None = None,
            should_stop: Callable[[], bool] | None = None,
            deadline_s: float | None = None) -> Iterator[RefreshResult]:
        """Poll the tailer forever (or until bounded), yielding one
        RefreshResult per fine-tune cycle.

        ``max_refreshes`` bounds refreshes performed by *this* call — a
        resumed stream's persisted lifetime counter affects numbering
        only, so re-running the same bounded command always does the same
        amount of work.

        With ``Config.etl.overlap`` (default on) the tail→parse→featurize
        work runs on a background ETL thread, double-buffered against the
        device fine-tune: while refresh() trains, the ETL thread keeps
        draining the tailer into a bounded featurized-bucket queue
        (backpressure: a full queue blocks the ETL thread, which stops
        consuming the tailer), so the train thread ingests precomputed
        rows instead of stalling on host ETL.  Refresh BOUNDARIES are
        identical to the serial path: poll batches stay atomic through
        the queue and readiness is checked once per batch, exactly as the
        serial loop does — same buckets in, same refresh results out.

        A FEATURIZED source (``tailer.featurized`` — the wire receiver,
        which featurizes on its own connection threads) yields
        ready-made ``(row, metrics_row)`` tuples; both loops commit
        those via ``_ingest_featurized`` instead of re-featurizing.  A
        source speaking the watermark convention gets the sidecar's
        persisted cursor handed back here before the first poll.
        """
        self._source = tailer
        rf = getattr(tailer, "resume_from", None)
        if callable(rf) and self._resume_source_watermark is not None:
            rf(self._resume_source_watermark)
        if getattr(self.config, "etl", None) is not None \
                and self.config.etl.overlap:
            yield from self._run_overlapped(tailer, max_refreshes,
                                            should_stop, deadline_s)
        else:
            yield from self._run_serial(tailer, max_refreshes,
                                        should_stop, deadline_s)

    def _finish_refresh(self, stall_s: float, lag: int,
                        dropped: int) -> RefreshResult:
        r = self.refresh()
        r.etl_stall_s = stall_s
        r.etl_lag_buckets = lag
        r.etl_dropped = dropped
        # ETL-health signals into the obs registry (one write per refresh
        # — never on the poll/ingest path): the scrapeable twin of the
        # RefreshResult fields the stream CLI prints.
        reg = obs_metrics.REGISTRY
        reg.counter("deeprest_stream_refreshes_total",
                    "fine-tune refreshes performed").inc()
        reg.counter("deeprest_etl_stall_seconds_total",
                    "train-thread seconds blocked on host ETL").inc(stall_s)
        reg.gauge("deeprest_etl_lag_buckets",
                  "featurized-but-not-ingested backlog at refresh").set(lag)
        reg.gauge("deeprest_etl_dropped_total",
                  "cumulative malformed lines dropped by the tailer").set(
                      dropped)
        reg.gauge("deeprest_stream_retained_buckets",
                  "buckets retained in the streaming corpus").set(
                      r.num_buckets)
        return r

    def _run_serial(self, tailer, max_refreshes, should_stop,
                    deadline_s) -> Iterator[RefreshResult]:
        t0 = time.monotonic()
        performed = 0
        stall = 0.0     # train-thread time spent featurizing since last refresh
        while True:
            if should_stop is not None and should_stop():
                return
            if deadline_s is not None and time.monotonic() - t0 > deadline_s:
                return
            got = tailer.poll()
            if got:
                sw = obs_metrics.Stopwatch()
                if getattr(tailer, "featurized", False):
                    for feat in got:
                        self._ingest_featurized(feat)
                else:
                    for bucket in got:
                        self.ingest(bucket)
                stall += sw.elapsed()
            if self.ready():
                yield self._finish_refresh(
                    stall, 0, int(getattr(tailer, "dropped", 0)))
                stall = 0.0
                performed += 1
                if max_refreshes is not None and performed >= max_refreshes:
                    return
            elif not got and not getattr(tailer, "backlog", False):
                # Sleep only when caught up — while draining a cold-start
                # backlog the next poll should run immediately.
                time.sleep(self.stream.poll_interval_s)

    def _run_overlapped(self, tailer, max_refreshes, should_stop,
                        deadline_s) -> Iterator[RefreshResult]:
        depth = self.config.etl.queue_depth
        buf = _EtlBuffer(max_buckets=depth)
        stop = threading.Event()
        # Deferred commit (data/wire.py): a source whose poll() would
        # ACK-and-watermark at drain must not do so HERE — drained rows
        # sit in buf until the train thread ingests them, and a
        # checkpoint cut in that window would persist a watermark
        # covering rows that are not in the ring (the client, already
        # ACKed, has pruned them: a kill+resume would silently lose
        # them).  Such sources expose poll_deferred()/commit(); the
        # token rides the buffer and the train thread commits
        # post-ingest.
        poll_deferred = getattr(tailer, "poll_deferred", None)
        commit = getattr(tailer, "commit", None)
        deferred = callable(poll_deferred) and callable(commit)

        def etl_loop():
            # The tailer lives on THIS thread only: its counters cross to
            # the train loop through the buffer's lock-protected snapshot
            # (note_dropped), never as bare attribute reads across threads
            # — the one sanctioned exception is commit(), which the wire
            # receiver locks internally precisely so the train thread
            # can call it.
            try:
                while not stop.is_set():
                    if deferred:
                        got, token = poll_deferred()
                    else:
                        got, token = tailer.poll(), None
                    buf.note_dropped(int(getattr(tailer, "dropped", 0)))
                    if got:
                        # One queue item per poll batch, kept atomic so the
                        # train thread's readiness checks land on the same
                        # batch boundaries as the serial loop's.  A
                        # featurized source's rows pass straight through
                        # (its own threads already did the ETL work).
                        buf.put(got if getattr(tailer, "featurized", False)
                                else [self._featurize(b) for b in got],
                                stop, token)
                    elif not getattr(tailer, "backlog", False):
                        stop.wait(self.stream.poll_interval_s)
            except BaseException as exc:  # deterministic tailer failures etc.
                buf.fail(exc)
            else:
                buf.fail(None)            # clean exit (stop requested)

        thread = threading.Thread(target=etl_loop, name="deeprest-etl",
                                  daemon=True)
        thread.start()
        t0 = time.monotonic()
        performed = 0
        stall = 0.0     # train-thread time blocked on ETL since last refresh
        try:
            while True:
                if should_stop is not None and should_stop():
                    return
                if deadline_s is not None \
                        and time.monotonic() - t0 > deadline_s:
                    return
                sw = obs_metrics.Stopwatch()
                item = buf.get(timeout=self.stream.poll_interval_s)
                if item is not None:
                    batch, token = item
                    # Only waits that produced data count as ETL stall —
                    # an idle timeout is the source's cadence, not the
                    # featurizer falling behind.
                    stall += sw.elapsed()
                    for feat in batch:
                        self._ingest_featurized(feat)
                    if token is not None:
                        # rows are in the ring: NOW the source may ACK
                        # them and advance the watermark the next
                        # checkpoint persists
                        commit(token)
                if self.ready():
                    yield self._finish_refresh(stall, buf.pending(),
                                               buf.dropped())
                    stall = 0.0
                    performed += 1
                    if max_refreshes is not None \
                            and performed >= max_refreshes:
                        return
        finally:
            stop.set()
            buf.unblock()
            thread.join(timeout=10.0)


def _accepts_reason(fn) -> bool:
    """Does ``fn`` take a ``reason`` keyword (directly or via
    ``**kwargs``)?  The DriftController's reload_fn contract predates
    reason labels; this probe lets reason-aware targets opt in without
    breaking single-arg closures already deployed."""
    if fn is None:
        return False
    import inspect

    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "reason"
               or p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params)


class DriftController:
    """The drift→retrain→hot-reload loop over one StreamingTrainer (the
    act half; obs/quality.py is the detect half).

    Wired via ``trainer.attach_quality(controller)``:

    - every ingested bucket feeds the quality monitor (O(nnz) — the
      traffic row is already featurized) and advances the sweep cadence;
    - every ``sweep_every_buckets`` buckets the monitors run over the
      trailing window (drift PSI/KS, band calibration, the continuous
      not-justified-by-traffic check) using a :class:`WindowBackend`
      whose apply is the trainer's own module run with no grad on the
      live parameter tensors (``obs.quality.model_apply``): no copy of
      the params per sweep and no capture per refresh, on the train
      thread between replays, touching none of the captured update's
      static tensors (K1 on a GPU);
    - when the drift verdict is ACTIVE (hysteresis already absorbed
      noise), ``auto_retrain`` queues an out-of-cadence refresh on the
      retained rings, bounded by ``retrain_cooldown_buckets`` and
      suppressed while an anomaly verdict is active (retraining on
      not-justified-by-traffic consumption would teach the model the
      very thing the sanity check exists to flag) — every suppression is
      counted, by reason;
    - after a drift/manual-triggered refresh lands its checkpoint,
      ``reload_fn(checkpoint_path)`` hot-swaps the serving plane (a plane
      watching the checkpoint dir via ``serve --watch`` needs no
      reload_fn at all) — reason-aware targets additionally receive
      ``reason=<trigger>``;
    - every decision is observable: obs counters by reason + spans
      around retrain triggers and reloads.

    Manual override: ``auto_retrain=False`` keeps the verdicts flowing
    while a human pulls :meth:`force_retrain`.
    """

    def __init__(self, trainer: StreamingTrainer, config=None,
                 reload_fn: Callable[[str], None] | None = None,
                 monitor=None):
        from deeprest_tpu_torch.config import QualityConfig

        self.config = config or QualityConfig(enabled=True)
        self._st = trainer
        self._reload_fn = reload_fn
        # Reason-aware reload targets (service.reload_from, a closure
        # over rolling_reload_from) get the TRIGGER as their reload
        # reason — the capacity-surface cache invalidates eagerly under
        # that label, and /metrics tells drift swaps from cadence ones.
        # Plain single-arg callables keep working unchanged.
        self._reload_takes_reason = _accepts_reason(reload_fn)
        self.monitor = monitor          # built at the first refresh
        self._apply = None              # built once, params as args
        self._since_sweep = 0
        self._bucket = 0                # buckets seen by on_bucket
        self._cooldown_until = -1
        self.stats = {"sweeps": 0, "retrains_triggered": 0,
                      "reloads": 0, "suppressed": {}}
        reg = obs_metrics.REGISTRY
        self._m_retrains = reg.counter(
            "deeprest_drift_retrains_total",
            "out-of-cadence retrains triggered by the drift loop",
            labelnames=("trigger",))
        self._m_suppressed = reg.counter(
            "deeprest_drift_retrain_suppressed_total",
            "drift-triggered retrains suppressed, by reason",
            labelnames=("reason",))
        self._m_reloads = reg.counter(
            "deeprest_drift_reloads_total",
            "serving-plane hot reloads pushed by the drift loop")
        trainer.attach_quality(self)

    # -- StreamingTrainer hooks (train thread only) ----------------------

    def on_bucket(self, row, metrics_row: dict) -> None:
        self._bucket += 1
        if self.monitor is None:
            return                      # arms at the first refresh
        if isinstance(row, tuple):
            self.monitor.observe(row[0], row[1], metrics_row)
        else:
            self.monitor.observe_dense(row, metrics_row)
        self._since_sweep += 1
        if self._since_sweep >= self.config.sweep_every_buckets:
            self._since_sweep = 0
            self._sweep()

    def on_refresh(self, result: RefreshResult) -> None:
        if self.monitor is None:
            from deeprest_tpu_torch.obs.quality import QualityMonitor

            self.monitor = QualityMonitor(self._st.metric_names,
                                          self.config)
        # Cold-start warmup for the model-conditioned verdicts: an
        # undertrained band's one-sided excess is indistinguishable from
        # a real anomaly, so calibration/anomaly machines stay disarmed
        # until the model has matured through enough refreshes.
        self.monitor.set_model_armed(
            self._st._refresh_count >= self.config.model_warmup_refreshes)
        # The fresh params trained on the retained rings — those rows ARE
        # the new no-drift reference.
        self.monitor.set_reference(self._ring_rows())
        if result.trigger in ("drift", "manual"):
            # Only a DRIFT-triggered retrain restarts the model-
            # conditioned verdict streams (calibration, anomaly): that is
            # the disambiguation move — recovery is measured against the
            # deliberately-refreshed band, and the excess that SURVIVES
            # it is real anomaly.  Cadence fine-tunes are incremental;
            # resetting on every one would wipe an anomaly streak faster
            # than sustain_enter can accumulate it (a ransomware window
            # spanning many cadence refreshes would never flag) — exactly
            # the flap the hysteresis exists to stop.
            self.monitor.on_model_refresh()
            self._cooldown_until = (self._bucket
                                    + self.config.retrain_cooldown_buckets)
            if self._reload_fn is not None and result.checkpoint_path:
                with obs_spans.RECORDER.span(
                        "drift.reload", component="deeprest-drift") as sp:
                    sp.tag(checkpoint=result.checkpoint_path,
                           trigger=result.trigger)
                    if self._reload_takes_reason:
                        self._reload_fn(result.checkpoint_path,
                                        reason=result.trigger)
                    else:
                        self._reload_fn(result.checkpoint_path)
                self.stats["reloads"] += 1
                self._m_reloads.inc()

    # -- the decide step -------------------------------------------------

    def force_retrain(self) -> None:
        """Manual trigger: next readiness check fires a refresh."""
        self._st.request_refresh("manual")

    def _sweep(self) -> None:
        if self._st.state is None:
            return
        summary = self.monitor.sweep(self._backend())
        if not summary.get("armed"):
            return
        self.stats["sweeps"] += 1
        self._decide()

    def _decide(self) -> None:
        from deeprest_tpu_torch.obs.quality import (
            VERDICT_ANOMALY, VERDICT_DRIFT,
        )

        cfg = self.config
        if not self.monitor.any_active(VERDICT_DRIFT):
            return
        reason = None
        if not cfg.auto_retrain:
            reason = "manual-override"
        elif self._bucket < self._cooldown_until:
            reason = "cooldown"
        elif (self.monitor.any_active(VERDICT_ANOMALY)
              and not cfg.retrain_during_anomaly):
            reason = "anomaly-active"
        if reason is not None:
            self.stats["suppressed"][reason] = \
                self.stats["suppressed"].get(reason, 0) + 1
            self._m_suppressed.inc(reason=reason)
            return
        if self._st._force_refresh is not None:
            return                      # a trigger is already queued
        with obs_spans.RECORDER.span("drift.retrain",
                                     component="deeprest-drift") as sp:
            sp.tag(bucket=self._bucket,
                   psi=round(self.monitor.verdicts()
                             ["feature_drift"]["psi"], 4))
            self._st.request_refresh("drift")
        self.stats["retrains_triggered"] += 1
        self._m_retrains.inc(trigger="drift")

    # -- plumbing --------------------------------------------------------

    def _ring_rows(self):
        """The drift-reference rows: the trailing ``reference_window``
        retained buckets (sparse pairs or dense row views — never a
        fresh F-wide allocation).  The tail, not the whole ring: the
        verdict asks whether the live stream differs from what the model
        most recently trained on, so a retrain that adapted to a new
        regime re-anchors the reference there and the drift verdict can
        EXIT instead of forever comparing against a pre/post mixture."""
        st = self._st
        n = len(st.traffic)
        lo = max(0, n - self.config.reference_window)
        if st.sparse:
            cols_v, vals_v, nnz_v = st.traffic.view()
            return [(cols_v[i, :nnz_v[i]], vals_v[i, :nnz_v[i]])
                    for i in range(lo, n)]
        view = st.traffic.view()
        return [view[i] for i in range(lo, n)]

    def _backend(self):
        from deeprest_tpu_torch.obs.quality import WindowBackend, model_apply

        st = self._st
        if self._apply is None:
            self._apply = model_apply(st.state.model,
                                      recurrence=st.trainer.recurrence)
        return WindowBackend(
            self._apply, st.state.params, st.x_stats, st.y_stats,
            st.metric_names, st.config.model.quantiles,
            st.config.train.window_size,
            delta_mask=st.current_delta_mask(),
            feature_dim=st.space.capacity)


class _EtlBuffer:
    """Bounded handoff between the ETL thread and the train loop.

    Items are whole poll batches (lists of featurized buckets); the bound
    is in BUCKETS — ``put`` blocks while the queued bucket count is at the
    limit (backpressure), but always admits at least one batch so a poll
    larger than the whole budget cannot deadlock.  Exceptions from the ETL
    thread are re-raised from ``get`` once the queue drains, so a
    deterministic tailer failure still surfaces to the caller.

    Each batch carries an opaque ``token`` (None for sources without
    deferred commit): a wire source's commit token, which the train
    thread hands back to ``tailer.commit`` only AFTER the batch's rows
    are in the ring — a batch discarded here (stop mid-put, kill) was
    therefore never committed and will be replayed, never lost.
    """

    def __init__(self, max_buckets: int):
        self.max_buckets = max_buckets
        self._cv = threading.Condition()
        self._batches: deque[tuple[list, object]] = deque()
        self._buckets = 0
        self._dropped = 0          # tailer's malformed-line counter snapshot
        self._exc: BaseException | None = None
        self._closed = False

    def put(self, batch: list, stop: threading.Event,
            token=None) -> None:
        with self._cv:
            while self._buckets >= self.max_buckets and not stop.is_set():
                self._cv.wait(0.05)
            if stop.is_set():
                return
            self._batches.append((batch, token))
            self._buckets += len(batch)
            self._cv.notify_all()

    def get(self, timeout: float) -> tuple[list, object] | None:
        with self._cv:
            if not self._batches and self._exc is None and not self._closed:
                self._cv.wait(timeout)
            if self._batches:
                batch, token = self._batches.popleft()
                self._buckets -= len(batch)
                self._cv.notify_all()
                return batch, token
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            return None

    def fail(self, exc: BaseException | None) -> None:
        with self._cv:
            self._exc = exc
            self._closed = True
            self._cv.notify_all()

    def note_dropped(self, total: int) -> None:
        """ETL-thread side: publish the tailer's cumulative malformed-line
        count.  The tailer object itself is owned by the ETL thread; this
        snapshot is the only form its counters cross the thread boundary
        in (lock-protected, so the train loop never reads them racily)."""
        with self._cv:
            self._dropped = total

    def dropped(self) -> int:
        with self._cv:
            return self._dropped

    def pending(self) -> int:
        with self._cv:
            return self._buckets

    def unblock(self) -> None:
        with self._cv:
            self._cv.notify_all()


__all__ = [
    "BucketTailer", "DriftController", "StreamConfig", "StreamingTrainer",
    "RefreshResult", "expand_minmax",
]
