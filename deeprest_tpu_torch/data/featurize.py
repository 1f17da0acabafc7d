"""Call-path featurization: span trees → fixed-width count vectors
(``deeprest_tpu/data/featurize.py``: dense counts, the sparse
``(cols, counts)`` rows of the 10k-endpoint feed, and the fork pool).

Semantics follow the reference's feature construction (reference:
resource-estimation/featurize.py:11-57): every root-to-node *call path*
observed in any trace becomes one feature dimension, and a bucket's feature
vector counts how many times each path occurs across the bucket's traces.
Per-component invocation counts (plus a synthetic ``general`` stream counting
whole traces) feed the component-aware baseline.

Departures from the reference, as in the JAX package:

- **Static width.**  The raw space is unbounded; the model wants a static
  input width.  Vectors are materialized at a fixed ``capacity`` (rounded up
  to a multiple of ``round_to``) so a growing vocabulary never changes array
  shapes mid-run.
- **Hash-bucketing mode.**  For streaming corpora the dictionary is replaced
  by a seeded FNV-1a hash of the call path into ``capacity`` buckets: no
  global vocabulary pass, and consistent across hosts and with the JAX
  package (the same function, the same golden vectors).
- **Streaming API.**  ``observe``/``extract`` work bucket-at-a-time.

Host-only numpy: the same corpus gives bit-identical features and
vocabulary in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from deeprest_tpu_torch.config import FeaturizeConfig
from deeprest_tpu_torch.data.schema import Bucket, Span

CallPath = tuple[str, ...]

# float32 can represent every integer count below 2**24 exactly, which is
# what makes the vectorized bincount path bit-identical to the historical
# `x[col] += 1.0` accumulation loop (see CallPathSpace.extract).
_EXACT_F32_COUNT = 1 << 24


_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_SEED_MIX = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def _stable_hash(path: CallPath, seed: int) -> int:
    """Seeded FNV-1a over the \\x1f-joined call path.

    Deliberately simple: the JAX package and its native featurizer implement
    the identical function, so hash-mode columns are consistent across
    packages, languages and hosts.
    """
    h = _FNV_OFFSET ^ ((seed * _SEED_MIX) & _MASK64)
    for b in "\x1f".join(path).encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return max(n, 1)
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


@dataclasses.dataclass
class CallPathSpace:
    """The feature space M: call path → column index.

    In dictionary mode indices are assigned in first-observed order, matching
    the reference's growth rule (reference: resource-estimation/
    featurize.py:14-15) so vocabularies are reproducible for a fixed corpus
    order.  In hash mode indices are ``stable_hash(path) % capacity`` and the
    space never needs fitting.
    """

    config: FeaturizeConfig = dataclasses.field(default_factory=FeaturizeConfig)
    index: dict[CallPath, int] = dataclasses.field(default_factory=dict)
    # Set on first extract (or explicit freeze()); afterwards the vector
    # width never changes even if the vocabulary keeps growing.
    frozen_capacity: int | None = None
    # Hash-mode memo: call path → column.  Paths repeat massively across
    # traces and the byte-wise FNV is the dominant per-span cost; one hash
    # per distinct path amortizes it away.  Only populated after freeze()
    # (the column depends on the frozen capacity); never serialized — it is
    # pure cache, rebuilt on demand.  Dictionary mode needs no memo: the
    # index IS the path→column map.
    _hash_memo: dict[CallPath, int] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    # -- construction ------------------------------------------------------

    def observe(self, buckets_or_traces: Iterable[Bucket] | Iterable[Span]) -> "CallPathSpace":
        """Grow the vocabulary from buckets (or bare traces). No-op in hash mode."""
        if self.config.hash_features:
            return self
        for item in buckets_or_traces:
            traces = item.traces if isinstance(item, Bucket) else [item]
            for trace in traces:
                for path, _ in trace.walk():
                    if path not in self.index:
                        self.index[path] = len(self.index)
        return self

    @classmethod
    def fit(cls, buckets: Iterable[Bucket], config: FeaturizeConfig | None = None) -> "CallPathSpace":
        return cls(config=config or FeaturizeConfig()).observe(buckets)

    # -- geometry ----------------------------------------------------------

    @property
    def num_observed(self) -> int:
        return len(self.index)

    @property
    def capacity(self) -> int:
        """Static feature-vector width (the model's input dimension).

        Frozen at the first extraction so a vocabulary that keeps growing
        can never change array shapes mid-run (it overflows instead).
        """
        if self.frozen_capacity is not None:
            return self.frozen_capacity
        cfg = self.config
        if cfg.capacity > 0:
            return cfg.capacity
        return _round_up(max(self.num_observed, 1), cfg.round_to)

    def freeze(self) -> "CallPathSpace":
        """Pin the current capacity as the permanent vector width."""
        if self.frozen_capacity is None:
            self.frozen_capacity = self.capacity
        return self

    def column_of(self, path: CallPath) -> int | None:
        if self.config.hash_features:
            return _stable_hash(path, self.config.hash_seed) % self.capacity
        idx = self.index.get(path)
        if idx is None or idx >= self.capacity:
            return None
        return idx

    # -- extraction --------------------------------------------------------

    def _trace_columns(self, traces: Sequence[Span]) -> np.ndarray:
        """int32 column ids, one per counted span, across ``traces``.

        The vectorized core: an explicit-stack preorder walk (no generator
        frames, no per-visit ``label`` property) that resolves each path to
        its column via the hash memo (hash mode) or the index (dictionary
        mode, overflow columns dropped).  Count order is irrelevant — the
        caller bincounts — so only the multiset of columns must match the
        reference loop's.  Requires a frozen capacity (extract freezes).
        """
        cols: list[int] = []
        append = cols.append
        if self.config.hash_features:
            memo = self._hash_memo
            memo_get = memo.get
            cap = self.capacity
            seed = self.config.hash_seed
            for trace in traces:
                stack = [((), trace)]
                pop, push = stack.pop, stack.append
                while stack:
                    prefix, node = pop()
                    path = prefix + (node.component + "_" + node.operation,)
                    c = memo_get(path)
                    if c is None:
                        c = _stable_hash(path, seed) % cap
                        memo[path] = c
                    append(c)
                    for child in node.children:
                        push((path, child))
        else:
            # The index is already the memo; unknown paths are NOT cached
            # as dropped — observe() may legally assign them a column later
            # (the reference loop honors that, so the memo must too).
            index_get = self.index.get
            cap = self.capacity
            for trace in traces:
                stack = [((), trace)]
                pop, push = stack.pop, stack.append
                while stack:
                    prefix, node = pop()
                    path = prefix + (node.component + "_" + node.operation,)
                    idx = index_get(path)
                    if idx is not None and idx < cap:
                        append(idx)
                    for child in node.children:
                        push((path, child))
        return np.asarray(cols, dtype=np.int32)

    def extract(self, traces: Sequence[Span], out: np.ndarray | None = None) -> np.ndarray:
        """Count each call path across ``traces`` into a [capacity] vector.

        Freezes the capacity on first call.  A caller-supplied ``out`` buffer
        is fully overwritten (counts are per-call, never cumulative).  Paths
        beyond a fixed ``capacity`` in dictionary mode are dropped (counted
        into nothing) — the documented overflow policy; size the capacity or
        switch to hashing to avoid it.

        Vectorized: column ids are gathered once per span (memoized per
        path) and accumulated with ``np.bincount``.  Bit-identical to the
        reference loop (``extract_reference``) for any count below 2**24 —
        counts are integers and float32 represents those exactly.
        """
        self.freeze()
        counts = np.bincount(self._trace_columns(traces),
                             minlength=self.capacity)
        if out is not None:
            out[:] = counts
            return out
        return counts.astype(np.float32)

    def extract_sparse(self, traces: Sequence[Span]
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Sparse twin of :meth:`extract`: ``(cols, counts)`` for the
        nonzero columns only, off the same memoized ``_trace_columns``
        walk.

        At the 10k-endpoint width any one bucket touches a handful of
        call paths — the dense vector is >99% zeros — so the sparse-first
        pipeline (ops/densify.densify_coo)
        carries ``(cols, counts)`` and defers densification to one
        on-device scatter.  Columns are unique and ascending
        (``np.unique``); counts are float32 integers, so scattering them
        into a zero vector is BIT-IDENTICAL to :meth:`extract` for any
        count below 2**24.  Freezes the
        capacity on first call, exactly like ``extract``.
        """
        self.freeze()
        cols, counts = np.unique(self._trace_columns(traces),
                                 return_counts=True)
        return cols.astype(np.int32), counts.astype(np.float32)

    def trace_columns_from_dict(self, trace) -> np.ndarray:
        """Preorder int32 column ids for ONE raw span-tree dict.

        The Span-free twin of :meth:`_trace_columns`: walking the parsed
        JSON dict directly skips the per-span ``Span.from_dict`` object
        construction, while producing the identical column multiset, so
        ``np.unique`` downstream makes the two paths bit-identical.
        Shares the hash memo with every other extraction path.  Freezes
        the capacity like ``extract``.
        """
        self.freeze()
        cols: list[int] = []
        append = cols.append
        if self.config.hash_features:
            memo = self._hash_memo
            memo_get = memo.get
            cap = self.capacity
            seed = self.config.hash_seed
            stack = [((), trace)]
            pop, push = stack.pop, stack.append
            while stack:
                prefix, node = pop()
                path = prefix + (str(node["component"]) + "_"
                                 + str(node["operation"]),)
                c = memo_get(path)
                if c is None:
                    c = _stable_hash(path, seed) % cap
                    memo[path] = c
                append(c)
                for child in node.get("children", ()):
                    push((path, child))
        else:
            index_get = self.index.get
            cap = self.capacity
            stack = [((), trace)]
            pop, push = stack.pop, stack.append
            while stack:
                prefix, node = pop()
                path = prefix + (str(node["component"]) + "_"
                                 + str(node["operation"]),)
                idx = index_get(path)
                if idx is not None and idx < cap:
                    append(idx)
                for child in node.get("children", ()):
                    push((path, child))
        return np.asarray(cols, dtype=np.int32)

    def sparse_from_columns(self, col_parts: Sequence[np.ndarray]
                            ) -> tuple[np.ndarray, np.ndarray]:
        """``(cols, counts)`` from precomputed per-trace column arrays.

        ``extract_sparse(traces)`` is exactly
        ``sparse_from_columns([per-trace columns])`` because
        ``_trace_columns`` is the per-trace concatenation and
        ``np.unique`` consumes an order-free multiset."""
        self.freeze()
        if col_parts:
            allcols = np.concatenate(col_parts)
        else:
            allcols = np.empty(0, dtype=np.int32)
        cols, counts = np.unique(allcols, return_counts=True)
        return cols.astype(np.int32), counts.astype(np.float32)

    def extract_reference(self, traces: Sequence[Span],
                          out: np.ndarray | None = None) -> np.ndarray:
        """The historical per-span accumulation loop, kept verbatim as the
        semantic specification of ``extract``: parity tests pin the
        vectorized path against it bit-for-bit."""
        self.freeze()
        if out is not None:
            out[:] = 0.0
            x = out
        else:
            # graftlint: disable=DN001 -- the pinned per-span accumulation REFERENCE is dense by definition; extract_sparse is the sparse-first path
            x = np.zeros((self.capacity,), dtype=np.float32)
        for trace in traces:
            for path, _ in trace.walk():
                col = self.column_of(path)
                if col is not None:
                    x[col] += 1.0
        return x

    def extract_buckets(self, buckets: Sequence[Bucket]) -> np.ndarray:
        """[num_buckets, capacity] traffic matrix."""
        self.freeze()
        # graftlint: disable=DN001 -- the offline [T, F] corpus matrix is this function's documented product (FeaturizedData.traffic); the streaming hot path uses extract_sparse + SparseSeriesRing instead
        out = np.zeros((len(buckets), self.capacity), dtype=np.float32)
        for t, bucket in enumerate(buckets):
            self.extract(bucket.traces, out=out[t])
        return out

    # -- introspection -----------------------------------------------------

    def vocabulary(self) -> list[CallPath]:
        """Observed call paths in column order (dictionary mode only)."""
        return sorted(self.index, key=self.index.__getitem__)

    def endpoints(self) -> list[str]:
        """Root-level API endpoints (length-1 call paths) observed so far."""
        return [p[0] for p in self.vocabulary() if len(p) == 1]

    # -- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-safe state: config, column-ordered vocabulary, frozen width."""
        return {
            "config": dataclasses.asdict(self.config),
            "vocabulary": [list(p) for p in self.vocabulary()],
            "frozen_capacity": self.frozen_capacity,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CallPathSpace":
        space = cls(config=FeaturizeConfig(**d["config"]))
        space.index = {tuple(p): i for i, p in enumerate(d["vocabulary"])}
        space.frozen_capacity = d["frozen_capacity"]
        return space


# --------------------------------------------------------------------------
# Invocation counts (component-aware baseline input)


def count_invocations(traces: Sequence[Span]) -> dict[str, int]:
    """Per-component span counts in a bucket, plus ``general`` = #traces.

    (reference: resource-estimation/featurize.py:43-57)
    """
    counts: dict[str, int] = {"general": 0}
    for trace in traces:
        counts["general"] += 1
        for _, node in trace.walk():
            counts[node.component] = counts.get(node.component, 0) + 1
    return counts


@dataclasses.dataclass
class FeaturizedData:
    """The model-ready triple the reference pickles as ``input.pkl``
    (reference: resource-estimation/featurize.py:104-106).  The ``.npz``
    layout is the JAX package's, so files load in either package."""

    traffic: np.ndarray                    # [T, capacity] float32 path counts
    resources: dict[str, np.ndarray]       # metric key → [T] float32
    invocations: dict[str, np.ndarray]     # component → [T] float32
    space: CallPathSpace

    @property
    def metric_names(self) -> list[str]:
        return list(self.resources)

    @property
    def space_dict(self) -> dict:
        """The space's JSON-safe state (``CallPathSpace.to_dict()``), as the
        trainer copies it into the checkpoint sidecar."""
        return self.space.to_dict()

    def targets(self) -> np.ndarray:
        """[T, num_metrics] resource matrix in metric_names order."""
        return np.stack([self.resources[k] for k in self.metric_names], axis=-1)

    def save(self, path: str) -> str:
        """One-file ``.npz`` artifact — the typed replacement for the
        reference's ``input.pkl`` (reference: featurize.py:104-106), with
        the feature space included so downstream synthesis/serving stays
        column-compatible by construction.  Returns the actual path written
        (np.savez appends ``.npz`` when missing)."""
        import json

        if not path.endswith(".npz"):
            path += ".npz"
        np.savez_compressed(
            path,
            traffic=self.traffic,
            resource_names=np.array(self.metric_names),
            resource_values=self.targets(),
            invocation_names=np.array(list(self.invocations)),
            invocation_values=np.stack(
                [self.invocations[k] for k in self.invocations], axis=-1
            ) if self.invocations else np.zeros((len(self.traffic), 0)),
            space_json=np.frombuffer(
                json.dumps(self.space.to_dict()).encode(), dtype=np.uint8
            ),
        )
        return path

    @classmethod
    def load(cls, path: str) -> "FeaturizedData":
        import json
        import os

        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"
        with np.load(path, allow_pickle=False) as z:
            space = CallPathSpace.from_dict(
                json.loads(bytes(z["space_json"]).decode())
            )
            resources = {
                str(name): z["resource_values"][:, i].astype(np.float32)
                for i, name in enumerate(z["resource_names"])
            }
            invocations = {
                str(name): z["invocation_values"][:, i].astype(np.float32)
                for i, name in enumerate(z["invocation_names"])
            }
            return cls(traffic=z["traffic"].astype(np.float32),
                       resources=resources, invocations=invocations,
                       space=space)


# --------------------------------------------------------------------------
# Process-parallel featurization (corpus-scale ingest)
#
# Two-phase observe→merge→extract over contiguous bucket shards.  Phase 1
# (dictionary mode only): each worker walks its shard and returns the
# shard-local first-observed path order; merging shards IN ORDER reproduces
# the serial first-observed column order exactly — the reference's growth
# rule (featurize.py:14-15) — because a path's first global occurrence lies
# in the earliest shard containing it, and within that shard the worker
# preserved local first-observed order.  Phase 2: workers extract their
# shard's traffic rows and invocation counts against the merged (frozen)
# space.  Counts are integers, so the merged result is bit-identical to a
# serial run.
#
# Workers are forked AFTER the corpus (and, for phase 2, the merged space)
# are bound to module globals: fork inherits them copy-on-write, so the
# corpus is never pickled to the pool — only the small per-shard results
# travel back.  A process that has set up CUDA must not fork (the child
# inherits a CUDA context it cannot use), so the pool refuses there.

_POOL_BUCKETS: Sequence[Bucket] | None = None
_POOL_SPACE: CallPathSpace | None = None


def _observe_shard(span: tuple[int, int]) -> list[CallPath]:
    lo, hi = span
    seen: set[CallPath] = set()
    order: list[CallPath] = []
    for bucket in _POOL_BUCKETS[lo:hi]:
        for trace in bucket.traces:
            for path, _ in trace.walk():
                if path not in seen:
                    seen.add(path)
                    order.append(path)
    return order


def _extract_shard(span: tuple[int, int]) -> tuple[np.ndarray, list[dict[str, int]]]:
    lo, hi = span
    chunk = _POOL_BUCKETS[lo:hi]
    traffic = _POOL_SPACE.extract_buckets(chunk)
    return traffic, [count_invocations(b.traces) for b in chunk]


def _sparse_lines_shard(lines: Sequence[bytes]) -> list[tuple]:
    """One pool worker's slice of raw bucket-JSONL lines →
    ``((cols, vals), metrics_row)`` per bucket, all through the Span-free
    dict walk.  The space rides the fork (``_POOL_SPACE``,
    copy-on-write) so only the lines travel in and the small sparse rows
    travel back; memo growth inside a worker is a private cache and
    never affects results (hash columns are pure functions)."""
    import json as _json

    space = _POOL_SPACE
    out = []
    for line in lines:
        d = _json.loads(line)
        parts = [space.trace_columns_from_dict(t)
                 for t in d.get("traces", ())]
        row = space.sparse_from_columns(parts)
        metrics = {f"{m['component']}_{m['resource']}": float(m["value"])
                   for m in d.get("metrics", ())}
        out.append((row, metrics))
    return out


def parallel_extract_sparse_lines(
    lines: Sequence[bytes], space: CallPathSpace, workers: int = 0,
    pool=None,
) -> list[tuple]:
    """Bulk sparse featurization of raw bucket-JSONL lines, sharded
    across a fork pool.

    ``pool`` may be a live ``multiprocessing`` fork pool whose workers
    were forked AFTER ``bind_pool_space(space)`` (kept for the whole run:
    forking per call would cost more than it shards).  Without one, the
    serial shard runs in this process.  Hash-mode spaces only for the pooled path: a
    dictionary-mode vocabulary may legally grow during extraction and
    workers cannot share that growth."""
    global _POOL_SPACE
    if pool is not None and space.config.hash_features and len(lines) > 1:
        w = max(1, workers)
        chunks = [lines[lo:hi] for lo, hi in _shard_spans(len(lines), w)]
        shard_results = pool.map(_sparse_lines_shard, chunks)
        return [r for shard in shard_results for r in shard]
    prev = _POOL_SPACE
    _POOL_SPACE = space
    try:
        return _sparse_lines_shard(lines)
    finally:
        _POOL_SPACE = prev


def bind_pool_space(space: CallPathSpace) -> None:
    """Bind the shared space for a long-lived fork pool (call BEFORE
    creating the pool so workers inherit it copy-on-write)."""
    global _POOL_SPACE
    space.freeze()
    _POOL_SPACE = space


def _shard_spans(n: int, workers: int) -> list[tuple[int, int]]:
    per = (n + workers - 1) // workers
    return [(lo, min(lo + per, n)) for lo in range(0, n, per)]


def resolve_workers(workers: int) -> int:
    """ETL worker-count knob semantics: 0 = one per CPU, 1 = serial."""
    if workers == 0:
        import os

        return os.cpu_count() or 1
    return max(1, workers)


def _refuse_fork_after_cuda() -> None:
    """Raise when this process has set up CUDA.  torch is consulted only
    when something already imported it: importing it here would cost every
    host-only featurize call the import, and a process that never imported
    torch cannot have set up CUDA."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError(
            "featurize_buckets(workers > 1) forks worker processes, which is "
            "unsafe once CUDA is set up in this process; featurize before "
            "touching the GPU, in another process, or with workers=1")


def _parallel_featurize(
    buckets: Sequence[Bucket], space: CallPathSpace, workers: int,
) -> tuple[np.ndarray, list[dict[str, int]]] | None:
    """Sharded observe→merge→extract; None when parallelism is unavailable
    (no fork on this platform) so the caller falls back to serial."""
    import multiprocessing

    global _POOL_BUCKETS, _POOL_SPACE
    try:
        ctx = multiprocessing.get_context("fork")
    except ValueError:
        return None
    spans = _shard_spans(len(buckets), workers)
    _POOL_BUCKETS = buckets
    try:
        if not space.config.hash_features and space.frozen_capacity is None:
            with ctx.Pool(min(workers, len(spans))) as pool:
                shard_orders = pool.map(_observe_shard, spans)
            for order in shard_orders:          # in shard order: serial-exact
                for path in order:
                    if path not in space.index:
                        space.index[path] = len(space.index)
        space.freeze()
        _POOL_SPACE = space
        with ctx.Pool(min(workers, len(spans))) as pool:
            shard_results = pool.map(_extract_shard, spans)
    finally:
        _POOL_BUCKETS = None
        _POOL_SPACE = None
    traffic = np.vstack([r[0] for r in shard_results])
    invocations = [c for r in shard_results for c in r[1]]
    return traffic, invocations


def featurize_buckets(
    buckets: Sequence[Bucket],
    config: FeaturizeConfig | None = None,
    space: CallPathSpace | None = None,
    workers: int = 1,
) -> FeaturizedData:
    """Full-corpus featurization: traffic, resources, invocation counts.

    ``workers`` shards the trace-walking work (observe + extract +
    invocation counts) across a forked process pool: 1 = serial, 0 = one
    worker per CPU.  Results are bit-identical to serial in both modes
    (see _parallel_featurize).  Metric-series assembly stays in the parent
    — it walks no traces and its validation is order-dependent.  More than
    one worker raises once CUDA is set up in this process.
    """
    config = config or FeaturizeConfig()
    if space is None:
        space = CallPathSpace(config=config)

    workers = resolve_workers(workers)
    if workers > 1:
        _refuse_fork_after_cuda()
    per_bucket_counts: list[dict[str, int]] | None = None
    traffic: np.ndarray | None = None
    # Parallelism only pays once walking dominates the fork+merge overhead.
    if workers > 1 and len(buckets) >= 4 * workers:
        parallel = _parallel_featurize(buckets, space, workers)
        if parallel is not None:
            traffic, per_bucket_counts = parallel

    if traffic is None:
        # Observe before extracting (no-op in hash mode): a caller-provided
        # fresh space would otherwise freeze at minimum capacity and silently
        # drop every path.  Already-frozen spaces are left untouched — novel
        # eval-corpus paths could never be addressed anyway, and growing the
        # index across serve-time calls would leak memory.
        if space.frozen_capacity is None:
            space.observe(buckets)
        traffic = space.extract_buckets(buckets)

    # Resource series must stay time-aligned with traffic: every bucket has to
    # carry exactly the metric keys of the union, or series would silently
    # shift against the traffic rows.
    resources: dict[str, list[float]] = {}
    expected_keys: set[str] | None = None
    for t, bucket in enumerate(buckets):
        seen: set[str] = set()
        for m in bucket.metrics:
            if m.key in seen:
                raise ValueError(f"bucket {t}: duplicate metric {m.key!r}")
            seen.add(m.key)
            resources.setdefault(m.key, []).append(m.value)
        if expected_keys is None:
            expected_keys = seen
        elif seen != expected_keys:
            missing, extra = expected_keys - seen, seen - expected_keys
            raise ValueError(
                f"bucket {t}: metric keys diverge from bucket 0 "
                f"(missing={sorted(missing)}, new={sorted(extra)}); every "
                "bucket must carry the same metrics or series misalign"
            )

    if per_bucket_counts is None:
        per_bucket_counts = [count_invocations(b.traces) for b in buckets]
    components = {c for counts in per_bucket_counts for c in counts}
    invocations: dict[str, list[float]] = {c: [] for c in components | {"general"}}
    for c in per_bucket_counts:
        for comp in invocations:
            invocations[comp].append(float(c.get(comp, 0)))

    return FeaturizedData(
        traffic=traffic,
        resources={k: np.asarray(v, dtype=np.float32) for k, v in resources.items()},
        invocations={k: np.asarray(v, dtype=np.float32) for k, v in invocations.items()},
        space=space,
    )
