"""Span firehose: push-based wire ingestion (``deeprest_tpu/data/wire.py``,
whole; frames byte-equal to the JAX package's).

A threaded socket receiver takes length-prefixed span batches from many
producers and lands them in the sparse streaming corpus, with bounded-queue
admission at the edge (drop and count, never buffer unboundedly).

Protocol
--------
Every frame is a fixed 16-byte header (``struct '!BBHIQ'``: magic 0xD7,
frame type, flags, payload length, sequence number) followed by the
payload.

Frame types::

    HELLO     c->s  JSON {"client": id}; opens the dedup window
    WELCOME   s->c  JSON {"watermark": seq}; highest seq COMMITTED for
                    this client id — the client prunes/replays against it
    BATCH     c->s  one bucket (sub-framed payload, below); seq is the
                    client's monotone batch sequence
    ACK       s->c  seq = highest committed sequence (advances when the
                    drained rows LAND IN THE RING — commit — not at
                    receipt, and not at drain: see "Commit" below)
    SLOWDOWN  s->c  JSON {"inflight": n, "limit": n} — explicit
                    backpressure; compliant clients pause
    DROPPED   s->c  JSON {"seqs": [..], "count": n} — exactly the
                    sequence numbers fast-dropped under overload (or
                    malformed); the client prunes those and ONLY those
    BYE       either direction, clean close

BATCH payload (Jaeger-shape JSON inside binary sub-framing)::

    u32 metrics_len | metrics JSON | u32 n | (u32 len | trace JSON) * n

Each trace blob is one span tree in the raw-corpus JSON shape
(``{"component", "operation", "children"}``, no timestamps), so a call
tree that repeats serializes to byte-identical blobs, and a bounded
``bytes -> column array`` memo turns a repeated tree into one dict lookup.
Cache misses decode through ``CallPathSpace.trace_columns_from_dict`` and
``sparse_from_columns``, the same hash path as the file tailer, so
wire-fed training is bit-identical to tailer-fed training.  No dense
``[., F]`` vector exists on this path.

A BATCH frame with ``FLAG_JSONL`` instead carries raw bucket-JSONL lines
(one bucket per line), the cold-start bulk shape; those may shard across
the featurizer's fork pool (``featurize.parallel_extract_sparse_lines``),
which refuses to fork once CUDA is set up in the process.

Backpressure ladder (per connection)
------------------------------------
``inflight`` = frames featurized but not yet drained by the train
thread.  Below ``queue_depth``: accept.  At ``queue_depth``: accept but
send SLOWDOWN.  At ``hard_limit`` (or a full global buffer): fast-drop
the frame — count it, notify the producer with DROPPED, never decode it.
A producer that stays in the drop band for ``evict_after`` consecutive
frames is evicted (connection closed, counted).

Commit: ACK means "in the ring", on every consumer shape
--------------------------------------------------------
The per-client watermark (what WELCOME reports, what ACK advances,
what the sidecar persists) must never run ahead of the ring, or a
kill+resume loses the gap.  ``poll()`` drains AND commits in one call —
correct whenever the caller ingests the items on the same thread before
anything can observe the watermark (the serial train loop, the
VerdictIngestor).  A consumer that hands drained items to ANOTHER thread
(the overlapped ETL loop) uses ``poll_deferred()`` → ``(items, token)``
and calls ``commit(token)`` only after the rows land.

Watermark convention (shared with data/ingest.LiveEndpointTailer)
-----------------------------------------------------------------
``ingest_watermark()`` returns a JSON-safe dict tagged by ``kind``;
``resume_from(wm)`` adopts one.  The stream persists the active source's
watermark inside the checkpoint/snapshot sidecar
(``stream_ring_watermark["source"]``) and hands it back on resume, so a
restarted stream deduplicates replayed frames (wire: per-client
committed seq) or re-anchors its poll cursor (live tailer: time cursor)
instead of double-counting spans.

Every thread here does host work only: no CUDA call happens on a
connection thread.
"""

from __future__ import annotations

import json
import select
import socket
import struct
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np

from deeprest_tpu_torch.data.schema import Bucket
from deeprest_tpu_torch.obs import metrics as obs_metrics

MAGIC = 0xD7
_HEADER = struct.Struct("!BBHIQ")   # magic, type, flags, payload len, seq
HEADER_SIZE = _HEADER.size          # 16 bytes
_U32 = struct.Struct("!I")

F_HELLO = 1
F_WELCOME = 2
F_BATCH = 3
F_ACK = 4
F_SLOWDOWN = 5
F_DROPPED = 6
F_BYE = 7

FLAG_JSONL = 0x1    # BATCH payload is raw bucket-JSONL lines (bulk)

# Same ceiling as train/stream.BucketTailer.MAX_POLL_BYTES: one frame can
# never force an unbounded allocation.
MAX_FRAME_BYTES = 64 << 20


def parse_hostport(spec: str) -> tuple[str, int]:
    """``HOST:PORT`` → tuple (the --wire-listen argument shape)."""
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"bad wire address {spec!r}: want HOST:PORT")
    return (host or "127.0.0.1", int(port))


def pack_frame(ftype: int, payload: bytes = b"", seq: int = 0,
               flags: int = 0) -> bytes:
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame payload {len(payload)} bytes exceeds "
                         f"MAX_FRAME_BYTES {MAX_FRAME_BYTES}")
    return _HEADER.pack(MAGIC, ftype, flags, len(payload), seq) + payload


def encode_bucket_payload(bucket) -> bytes:
    """One bucket → the sub-framed BATCH payload.

    Accepts a :class:`Bucket` or its raw dict.  Trace blobs are
    serialized individually (compact separators) so identical call trees
    produce identical bytes — the receiver's blob memo keys on exactly
    these bytes.
    """
    d = bucket.to_dict() if isinstance(bucket, Bucket) else bucket
    head = json.dumps(d.get("metrics", []),
                      separators=(",", ":")).encode("utf-8")
    blobs = [json.dumps(t, separators=(",", ":")).encode("utf-8")
             for t in d.get("traces", ())]
    parts = [_U32.pack(len(head)), head, _U32.pack(len(blobs))]
    for b in blobs:
        parts.append(_U32.pack(len(b)))
        parts.append(b)
    return b"".join(parts)


_FILLED, _EOF, _IDLE = 1, 0, -1


def _recv_exact(sock: socket.socket, view: memoryview, *,
                idle_ok: bool = False) -> int:
    """Fill ``view`` exactly from ``sock`` via ``recv_into`` (no
    intermediate bytes objects).  Returns ``_FILLED``, ``_EOF`` (clean
    close before any byte), or ``_IDLE`` (timeout before any byte, only
    with ``idle_ok``); raises ConnectionError on EOF mid-buffer.  A
    timeout mid-buffer keeps waiting — a closed socket breaks it."""
    got = 0
    n = len(view)
    while got < n:
        try:
            k = sock.recv_into(view[got:])
        except socket.timeout:
            if got == 0:
                if idle_ok:
                    return _IDLE
                raise
            continue
        if k == 0:
            if got == 0:
                return _EOF
            raise ConnectionError("wire: EOF mid-frame")
        got += k
    return _FILLED


# ---------------------------------------------------------------------------
# Receiver


class _Conn:
    """Per-connection accounting.  ``enqueued`` is written only by the
    handler thread and ``drained`` only by the committing (train) thread
    — two single-writer monotone counters, so ``inflight`` needs no lock
    and a stale read only ever delays backpressure by one frame.
    ``inflight`` covers enqueued-but-uncommitted frames: in overlapped
    mode that includes rows still waiting in the ETL buffer, so the
    admission window is end-to-end, not just receiver-internal."""

    __slots__ = ("sock", "addr", "client_id", "enqueued", "drained",
                 "acked_sent", "drop_streak", "dropped_pending", "alive")

    def __init__(self, sock: socket.socket, addr) -> None:
        self.sock = sock
        self.addr = addr
        self.client_id = f"{addr[0]}:{addr[1]}"
        self.enqueued = 0
        self.drained = 0
        self.acked_sent = -1
        self.drop_streak = 0
        # seqs shed (overload or malformed) but not yet announced via a
        # DROPPED frame; bounded by the notice cadence in _on_batch and
        # flushed by _flush_acks on the next idle tick
        self.dropped_pending: list[int] = []
        self.alive = True

    @property
    def inflight(self) -> int:
        return self.enqueued - self.drained


class SpanFirehoseReceiver:
    """Threaded push receiver implementing the stream-source (tailer)
    protocol: ``poll()``/``backlog``/``dropped``/``close()`` plus the
    watermark convention, so ``StreamingTrainer.run`` and the
    serve plane's VerdictIngestor consume it unchanged — and the
    deferred-commit extension (``poll_deferred()``/``commit()``) the
    overlapped ETL loop uses so the watermark only ever covers rows
    that are actually in the ring.

    With ``space`` bound the receiver featurizes on its connection
    threads (``featurized = True``: ``poll()`` yields the same
    ``(row, metrics_row)`` tuples ``StreamingTrainer._featurize``
    produces, rows sparse ``(cols, vals)`` pairs).  Without a space it
    yields :class:`Bucket` objects (``featurized = False``) — the
    verdict-ingestor mode.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 space=None, sparse: bool = True,
                 queue_depth: int = 256,
                 hard_limit: int | None = None,
                 evict_after: int | None = None,
                 max_buffered: int = 4096,
                 trace_cache_entries: int = 65536,
                 fork_workers: int = 1,
                 idle_timeout_s: float = 0.2) -> None:
        if space is not None and not sparse:
            raise ValueError(
                "wire ingestion is sparse-first by design: a dense "
                "[., F] row per frame is exactly the allocation this "
                "path avoids — run the stream with the sparse feed or "
                "use the file tailer")
        self._host, self._port = host, port
        self._space = space
        self._sparse = sparse
        self.queue_depth = max(1, queue_depth)
        self.hard_limit = hard_limit or 2 * self.queue_depth
        self.evict_after = evict_after or 4 * self.queue_depth
        self.max_buffered = max_buffered
        self._idle_s = idle_timeout_s
        # items: (conn, seq, t_featurized, payload)
        self._out: deque = deque()
        self._conns: list[_Conn] = []
        self._conns_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._listener: threading.Thread | None = None
        self._lsock: socket.socket | None = None
        self._stop = threading.Event()
        # committed seq per client id — the dedup floor WELCOME reports
        # and resume_from() restores.  Written by the committing thread
        # (poll()'s caller, or commit()'s in deferred mode), read by
        # handler threads (GIL-atomic dict ops; a stale read only delays
        # dedup of an already-counted frame by one poll).
        self._committed: dict[str, int] = {}
        # drained-but-uncommitted batches: (token, [(conn, seq, t_enq)]).
        # poll_deferred() appends, commit() pops — the window a kill may
        # strike without losing anything, because nothing in here has
        # been ACKed or counted into the watermark yet.
        self._commit_lock = threading.Lock()
        self._commit_token = 0
        self._uncommitted: deque = deque()
        # highest ENQUEUED seq per client id: dedups a reconnect replay
        # of frames that are already in the buffer but not yet drained
        # (committed alone would admit them twice)
        self._seen: dict[str, int] = {}
        # bounded trace-blob memo: bytes -> int32 column array.  Hash
        # mode only — a dictionary-mode vocabulary may still grow, which
        # would invalidate cached (dropped-path) entries.
        self._blob_memo: dict[bytes, np.ndarray] | None = None
        if space is not None and space.config.hash_features:
            self._blob_memo = {}
        self._blob_cap = max(1024, trace_cache_entries)
        # forked featurize pool for FLAG_JSONL bulk frames;
        # created lazily at start() when workers > 1 (serial fallback
        # otherwise — on a 1-core host the fork buys nothing).
        self._fork_workers = fork_workers
        self._pool = None
        # shared totals: multiple handler threads += these, so they live
        # behind _stats_lock — one uncontended acquire per FRAME (never
        # per span/trace: decode accumulates locally and flushes once).
        # Registry export stays delta-flushed from poll().
        self._stats_lock = threading.Lock()
        self.spans_total = 0
        self.batches_total = 0
        self.dropped_total = 0
        self.backpressure_total = 0
        self.duplicates_total = 0
        self.evictions_total = 0
        self.malformed_total = 0
        self.memo_hits = 0
        self.memo_misses = 0
        self._obs_flushed = {"spans": 0, "batches": 0, "dropped": 0,
                             "backpressure": 0}
        self._lat = deque(maxlen=8192)   # drain-time ingest→ring latency
        self._hist = obs_metrics.REGISTRY.histogram(
            "deeprest_wire_ingest_seconds",
            "wire frame featurized → drained into the ring",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "SpanFirehoseReceiver":
        ls = socket.create_server((self._host, self._port))
        ls.settimeout(self._idle_s)
        self._lsock = ls
        self._host, self._port = ls.getsockname()[:2]
        if self._space is not None:
            self._space.freeze()
        workers = max(1, self._fork_workers)
        if (workers > 1 and self._space is not None
                and self._space.config.hash_features):
            import multiprocessing

            from deeprest_tpu_torch.data.featurize import (
                _refuse_fork_after_cuda, bind_pool_space,
            )

            _refuse_fork_after_cuda()
            try:
                ctx = multiprocessing.get_context("fork")
                bind_pool_space(self._space)
                with self._stats_lock:
                    self._pool = ctx.Pool(workers)
            except ValueError:
                with self._stats_lock:
                    self._pool = None   # no fork on this platform: serial
        self._listener = threading.Thread(
            target=self._accept_loop, args=(ls,),
            name="deeprest-wire-accept", daemon=True)
        self._listener.start()
        return self

    @property
    def address(self) -> tuple[str, int]:
        return (self._host, self._port)

    @property
    def featurized(self) -> bool:
        return self._space is not None

    def close(self) -> None:
        self._stop.set()
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        if self._listener is not None:
            self._listener.join(timeout=5.0)
        with self._conns_lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=5.0)
        with self._stats_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()
            pool.join()
        self._flush_obs()

    # -- accept / per-connection handler -------------------------------

    def _accept_loop(self, lsock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return                       # listener closed
            sock.settimeout(self._idle_s)
            conn = _Conn(sock, addr)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name=f"deeprest-wire-{addr[1]}",
                                 daemon=True)
            with self._conns_lock:
                self._conns.append(conn)
                # prune finished handlers so a long-lived plane's thread
                # ledger stays O(open connections), not O(ever connected)
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
            t.start()
            obs_metrics.REGISTRY.gauge(
                "deeprest_wire_connections",
                "open wire ingest connections").set(self.connections)

    @property
    def connections(self) -> int:
        with self._conns_lock:
            return sum(1 for c in self._conns if c.alive)

    def _serve_conn(self, conn: _Conn) -> None:
        sock = conn.sock
        hdr = bytearray(HEADER_SIZE)
        hdr_view = memoryview(hdr)
        buf = bytearray(1 << 16)
        try:
            while not self._stop.is_set() and conn.alive:
                st = _recv_exact(sock, hdr_view, idle_ok=True)
                if st == _IDLE:
                    self._flush_acks(conn)
                    continue
                if st == _EOF:
                    return
                magic, ftype, flags, length, seq = _HEADER.unpack(hdr)
                if magic != MAGIC or length > MAX_FRAME_BYTES:
                    with self._stats_lock:
                        self.malformed_total += 1
                    return                   # desynced stream: drop conn
                if length > len(buf):
                    buf = bytearray(length)
                payload = memoryview(buf)[:length]
                if length and _recv_exact(sock, payload) != _FILLED:
                    return
                if ftype == F_BATCH:
                    self._on_batch(conn, flags, seq, payload)
                    self._flush_acks(conn)
                elif ftype == F_HELLO:
                    self._on_hello(conn, payload)
                elif ftype == F_BYE:
                    self._flush_acks(conn)
                    return
                # unknown frame types are skipped (forward compatibility)
        except (ConnectionError, OSError):
            pass                             # producer vanished: clean up
        finally:
            self._retire(conn)

    def _on_hello(self, conn: _Conn, payload: memoryview) -> None:
        try:
            meta = json.loads(bytes(payload)) if len(payload) else {}
            cid = str(meta.get("client") or conn.client_id)
        except (ValueError, TypeError):
            with self._stats_lock:
                self.malformed_total += 1
            cid = conn.client_id
        conn.client_id = cid
        wm = self._committed.get(cid, 0)
        self._send(conn, pack_frame(
            F_WELCOME, json.dumps({"watermark": wm}).encode("utf-8")))

    def _on_batch(self, conn: _Conn, flags: int, seq: int,
                  payload: memoryview) -> None:
        cid = conn.client_id
        if seq <= max(self._committed.get(cid, 0), self._seen.get(cid, 0)):
            # replay of a frame that is already committed OR already in
            # the buffer (client reconnected before our ACK landed):
            # dedup, never double-count
            with self._stats_lock:
                self.duplicates_total += 1
            return
        inflight = conn.inflight
        if inflight >= self.hard_limit or len(self._out) >= self.max_buffered:
            # Admission: shed with accounting, notify producer.
            # The DROPPED notice names the EXACT seqs shed — a range
            # would also cover accepted-but-unACKed frames below it,
            # and a client pruning those loses them on a receiver kill.
            with self._stats_lock:
                self.dropped_total += 1
            conn.drop_streak += 1
            conn.dropped_pending.append(seq)
            if conn.drop_streak == 1 or conn.drop_streak % 64 == 0:
                self._flush_dropped(conn)
            if conn.drop_streak >= self.evict_after:
                self._evict(conn)
            return
        if inflight >= self.queue_depth and (
                inflight == self.queue_depth or conn.enqueued % 64 == 0):
            with self._stats_lock:
                self.backpressure_total += 1
            self._send(conn, pack_frame(F_SLOWDOWN, json.dumps(
                {"inflight": inflight,
                 "limit": self.queue_depth}).encode("utf-8")))
        try:
            item, nspans = (self._decode_jsonl(payload)
                            if flags & FLAG_JSONL
                            else self._decode_bucket(payload))
        except (ValueError, KeyError, TypeError, struct.error):
            # counted ONCE: the dropped/stats aggregates already add
            # malformed_total, so bumping dropped_total too would count
            # this frame twice in the accounting identity.  The seq is
            # still announced as shed so the client can prune it.
            with self._stats_lock:
                self.malformed_total += 1
            conn.dropped_pending.append(seq)
            self._flush_dropped(conn)
            return
        with self._stats_lock:
            self.batches_total += 1
            self.spans_total += nspans
        conn.drop_streak = 0
        if seq > self._seen.get(cid, 0):
            self._seen[cid] = seq
        # a bulk (FLAG_JSONL) frame's buckets ride as ONE list item under
        # ONE sequence number — drained atomically, so a kill can never
        # half-apply it
        self._out.append((conn, seq, time.monotonic(), item))
        conn.enqueued += 1

    def _decode_bucket(self, payload: memoryview):
        """Sub-framed BATCH payload → one poll item.  The per-trace blob
        memo is the wire fast path: a repeated call tree costs a bytes
        hash + dict hit instead of json parse + walk + per-path FNV."""
        (mlen,) = _U32.unpack_from(payload, 0)
        off = 4 + mlen
        metrics = json.loads(bytes(payload[4:off]))
        (ntr,) = _U32.unpack_from(payload, off)
        off += 4
        space = self._space
        memo = self._blob_memo
        nspans = 0
        if space is None:
            # bucket mode (VerdictIngestor): decode to schema objects
            traces = []
            for _ in range(ntr):
                (blen,) = _U32.unpack_from(payload, off)
                off += 4
                d = json.loads(bytes(payload[off:off + blen]))
                off += blen
                traces.append(d)
            bucket = Bucket.from_dict({"metrics": metrics,
                                       "traces": traces})
            nspans = sum(1 for t in bucket.traces for _ in t.walk())
            return bucket, nspans
        parts = []
        hits = misses = 0      # flushed once per frame, never per trace
        for _ in range(ntr):
            (blen,) = _U32.unpack_from(payload, off)
            off += 4
            blob = bytes(payload[off:off + blen])
            off += blen
            cols = memo.get(blob) if memo is not None else None
            if cols is None:
                misses += 1
                cols = space.trace_columns_from_dict(json.loads(blob))
                if memo is not None:
                    if len(memo) >= self._blob_cap:
                        memo.clear()     # bounded: full reset beats LRU
                    memo[blob] = cols
            else:
                hits += 1
            nspans += len(cols)
            parts.append(cols)
        with self._stats_lock:
            self.memo_hits += hits
            self.memo_misses += misses
        row = space.sparse_from_columns(parts)
        metrics_row = {f"{m['component']}_{m['resource']}": float(m["value"])
                       for m in metrics}
        return (row, metrics_row), nspans

    def _decode_jsonl(self, payload: memoryview):
        """FLAG_JSONL bulk frame: bucket-JSONL lines sharded across the
        forked featurize pool (serial fallback in-process)."""
        lines = [ln for ln in bytes(payload).split(b"\n") if ln]
        if self._space is None:
            buckets = [Bucket.from_dict(json.loads(ln)) for ln in lines]
            nspans = sum(1 for b in buckets
                         for t in b.traces for _ in t.walk())
            return buckets, nspans
        from deeprest_tpu_torch.data.featurize import parallel_extract_sparse_lines

        with self._stats_lock:
            pool = self._pool
        feats = parallel_extract_sparse_lines(
            lines, self._space, workers=max(1, self._fork_workers),
            pool=pool)
        nspans = int(sum(f[0][1].sum() for f in feats))
        return feats, nspans

    def _flush_acks(self, conn: _Conn) -> None:
        """Push the committed watermark (and any unannounced shed seqs)
        back to the producer.  Commit advances when the drained rows
        LAND IN THE RING (poll() for same-thread consumers, commit() in
        deferred mode) — an ACK is a promise the spans reached the
        ring, not just a socket or an ETL queue."""
        wm = self._committed.get(conn.client_id, 0)
        if wm > conn.acked_sent:
            conn.acked_sent = wm
            self._send(conn, pack_frame(F_ACK, seq=wm))
        if conn.dropped_pending:
            self._flush_dropped(conn)

    def _flush_dropped(self, conn: _Conn) -> None:
        """Announce the exact shed seqs accumulated since the last
        notice (bounded by the notice cadence, ≤ 64 between sends)."""
        seqs, conn.dropped_pending = conn.dropped_pending, []
        self._send(conn, pack_frame(F_DROPPED, json.dumps(
            {"seqs": seqs,
             "count": conn.drop_streak}).encode("utf-8")))

    def _send(self, conn: _Conn, frame: bytes) -> None:
        try:
            conn.sock.sendall(frame)
        except (OSError, ValueError):
            conn.alive = False

    def _evict(self, conn: _Conn) -> None:
        with self._stats_lock:
            self.evictions_total += 1
        conn.alive = False
        try:
            conn.sock.close()
        except OSError:
            pass

    def _retire(self, conn: _Conn) -> None:
        conn.alive = False
        try:
            conn.sock.close()
        except OSError:
            pass
        obs_metrics.REGISTRY.gauge(
            "deeprest_wire_connections",
            "open wire ingest connections").set(self.connections)

    # -- stream-source (tailer) protocol --------------------------------

    @property
    def backlog(self) -> bool:
        return len(self._out) > 0

    @property
    def dropped(self) -> int:
        """Tailer-protocol drop counter (RefreshResult's etl.dropped):
        overload drops + malformed frames."""
        with self._stats_lock:
            return self.dropped_total + self.malformed_total

    def poll(self, max_items: int | None = None) -> list:
        """Drain featurized items (or Buckets) AND commit them.

        Committing means: the per-client watermark advances, so an
        ACKed frame is by definition in the ring and a frame lost in a
        crash is by definition unACKed and will be replayed on
        reconnect — no span is ever silently half-applied.  That
        equivalence only holds if the caller ingests the returned items
        on this same thread before the watermark can be observed (a
        checkpoint cut, a WELCOME): the serial train loop and the
        VerdictIngestor do.  A consumer that queues the items for
        ANOTHER thread to ingest must use :meth:`poll_deferred` +
        :meth:`commit` instead, or a kill between drain and ingest
        loses the queued frames (ACKed and watermarked, never rung).
        """
        out, token = self.poll_deferred(max_items)
        self.commit(token)
        return out

    def poll_deferred(self, max_items: int | None = None
                      ) -> tuple[list, int]:
        """Drain WITHOUT committing: returns ``(items, token)``.  The
        drained frames stay un-ACKed and outside the watermark until
        ``commit(token)`` — call it only once the items are in the
        ring.  Uncommitted frames survive a kill by replay: the client
        still holds them pending, and a resumed watermark excludes
        them, so the reconnect WELCOME solicits exactly the gap."""
        out = []
        drained = []
        pop = self._out.popleft
        while self._out and (max_items is None or len(out) < max_items):
            try:
                conn, seq, t_enq, item = pop()
            except IndexError:       # pragma: no cover - racing close()
                break
            drained.append((conn, seq, t_enq))
            if isinstance(item, list):      # bulk frame: atomic unit
                out.extend(item)
            else:
                out.append(item)
        with self._commit_lock:
            self._commit_token += 1
            token = self._commit_token
            if drained:
                self._uncommitted.append((token, drained))
        return out, token

    def commit(self, token: int) -> None:
        """Advance per-client watermarks/ACK state for every batch
        drained at or before ``token`` — the drained rows are now in
        the ring.  Ingest→ring latency is observed here, so the
        histogram covers the full path including any queue wait."""
        batches = []
        with self._commit_lock:
            while self._uncommitted and self._uncommitted[0][0] <= token:
                batches.append(self._uncommitted.popleft()[1])
        if batches:
            now = time.monotonic()
            lats = []
            for drained in batches:
                for conn, seq, t_enq in drained:
                    conn.drained += 1
                    if seq > self._committed.get(conn.client_id, 0):
                        self._committed[conn.client_id] = seq
                    lats.append(now - t_enq)
            with self._stats_lock:
                self._lat.extend(lats)
            for lat in lats:
                self._hist.observe(lat)
        self._flush_obs()

    def _flush_obs(self) -> None:
        """Delta-flush local counters into the obs registry — called at
        poll cadence so the per-frame hot loop never takes the registry
        lock."""
        reg = obs_metrics.REGISTRY
        with self._stats_lock:
            cur = {"spans": self.spans_total,
                   "batches": self.batches_total,
                   "dropped": self.dropped_total + self.malformed_total,
                   "backpressure": self.backpressure_total}
        flushed = self._obs_flushed
        help_ = {"spans": "spans accepted over the wire",
                 "batches": "bucket batches accepted over the wire",
                 "dropped": "wire frames dropped (overload + malformed)",
                 "backpressure": "SLOWDOWN frames sent to producers"}
        for key, val in cur.items():
            delta = val - flushed[key]
            if delta:
                reg.counter(f"deeprest_wire_{key}_total",
                            help_[key]).inc(delta)
                flushed[key] = val
        reg.gauge("deeprest_wire_connections",
                  "open wire ingest connections").set(self.connections)

    # -- watermark convention (shared with LiveEndpointTailer) ----------

    def ingest_watermark(self) -> dict:
        return {"kind": "wire_seq", "clients": dict(self._committed)}

    def resume_from(self, wm: dict) -> None:
        if not isinstance(wm, dict) or wm.get("kind") != "wire_seq":
            return
        for cid, seq in (wm.get("clients") or {}).items():
            try:
                seq = int(seq)
            except (TypeError, ValueError):
                continue
            if seq > self._committed.get(str(cid), 0):
                self._committed[str(cid)] = seq

    # -- observability ---------------------------------------------------

    def stats(self) -> dict:
        """The /healthz + RefreshResult-printout view: same shapes as the
        ``deeprest_wire_*`` registry series."""
        # deliberately OUTSIDE _stats_lock: _out is the lock-free
        # hot-path deque (single ingest writer, GIL-atomic len) and
        # connections acquires _conns_lock — neither belongs inside this
        # critical section (nesting _conns_lock under _stats_lock is a
        # lock-order hazard for free)
        pending = len(self._out)
        conns = self.connections
        with self._stats_lock:
            # snapshot under the lock commit() appends under — sorted()
            # iterating a deque another thread extends raises
            # RuntimeError, which would take /healthz down with it
            lat = sorted(self._lat)
            p99 = (lat[min(len(lat) - 1, int(0.99 * len(lat)))]
                   if lat else None)
            return {
                "spans": self.spans_total,
                "batches": self.batches_total,
                "dropped": self.dropped_total + self.malformed_total,
                "backpressure": self.backpressure_total,
                "duplicates": self.duplicates_total,
                "evictions": self.evictions_total,
                "connections": conns,
                "pending": pending,
                "memo_hit_rate": (self.memo_hits
                                  / max(1, self.memo_hits
                                        + self.memo_misses)),
                "p99_ingest_s": p99,
            }


# ---------------------------------------------------------------------------
# Client


class WireClient:
    """Blocking push client with reconnect + replay.

    Unacked frames stay in a bounded pending window; on reconnect the
    receiver's WELCOME watermark prunes the committed prefix and the
    rest is replayed, so a receiver kill mid-stream loses nothing and a
    stream resume double-counts nothing.  SLOWDOWN frames pause the
    sender (``slowdown_pause_s``); DROPPED frames prune exactly the
    seqs the receiver shed (backpressure accounting, not silent loss —
    accepted frames stay pending until an ACK covers them).  If the
    receiver stops ACKing entirely, the window is still bounded: an
    ACK wait that times out sheds the oldest pending frames, counted
    in ``timeout_shed``.
    """

    def __init__(self, address, client_id: str = "wire-client", *,
                 timeout_s: float = 10.0, pending_limit: int = 1024,
                 slowdown_pause_s: float = 0.02,
                 reconnect: bool = True, max_retries: int = 30,
                 retry_backoff_s: float = 0.1) -> None:
        if isinstance(address, str):
            address = parse_hostport(address)
        self.address = tuple(address)
        self.client_id = client_id
        self.timeout_s = timeout_s
        self.pending_limit = pending_limit
        self.slowdown_pause_s = slowdown_pause_s
        self.reconnect = reconnect
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self._sock: socket.socket | None = None
        self._seq = 0
        self._pending: dict[int, tuple[int, bytes]] = {}   # seq -> frame
        self.acked = 0
        self.slowdowns = 0
        self.server_dropped = 0
        self.timeout_shed = 0
        self.reconnects = 0
        self.sent_batches = 0
        self._hdr = bytearray(HEADER_SIZE)

    # -- connection -----------------------------------------------------

    def connect(self) -> "WireClient":
        sock = socket.create_connection(self.address,
                                        timeout=self.timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = sock
            sock.sendall(pack_frame(F_HELLO, json.dumps(
                {"client": self.client_id}).encode("utf-8")))
            ftype, _, _, payload = self._read_frame()
            if ftype != F_WELCOME:
                raise ConnectionError(
                    f"wire: expected WELCOME, got {ftype}")
            wm = int(json.loads(payload or b"{}").get("watermark", 0))
            self.acked = max(self.acked, wm)
            self._seq = max(self._seq, wm)
            self._prune(wm)
            # replay everything the receiver has not committed
            for seq in sorted(self._pending):
                flags, pl = self._pending[seq]
                self._sock.sendall(pack_frame(F_BATCH, pl, seq=seq,
                                              flags=flags))
        except BaseException:
            self._sock = None
            try:
                sock.close()
            except OSError:
                pass
            raise
        return self

    def _reconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        last: Exception | None = None
        for attempt in range(self.max_retries):
            try:
                self.connect()
                self.reconnects += 1
                return
            except (OSError, ConnectionError) as exc:
                last = exc
                time.sleep(self.retry_backoff_s * min(8, 1 + attempt))
        raise ConnectionError(
            f"wire: could not reconnect to {self.address}") from last

    # -- send path ------------------------------------------------------

    def send_bucket(self, bucket) -> int:
        """Push one bucket; returns its sequence number."""
        return self._send_batch(encode_bucket_payload(bucket), flags=0)

    def send_jsonl(self, lines: Sequence[bytes]) -> int:
        """Push raw bucket-JSONL lines as ONE bulk frame (cold-start
        replay of an existing corpus file; no client-side re-encode)."""
        return self._send_batch(b"\n".join(lines), flags=FLAG_JSONL)

    def _send_batch(self, payload: bytes, flags: int) -> int:
        if self._sock is None:
            self.connect()
        self._seq += 1
        seq = self._seq
        self._pending[seq] = (flags, payload)
        frame = pack_frame(F_BATCH, payload, seq=seq, flags=flags)
        try:
            self._sock.sendall(frame)
        except (OSError, ConnectionError):
            if not self.reconnect:
                raise
            self._reconnect()                # replays pending, incl. seq
        self.sent_batches += 1
        try:
            self._drain_server(block=False)
        except (OSError, ConnectionError):
            # the server died between our send and its ACK: the frame is
            # safe in the pending window — reconnect replays it
            if not self.reconnect:
                raise
            self._reconnect()
        if len(self._pending) > self.pending_limit:
            # respect the receiver's pace: wait for ACKs before queueing
            # more (the client-side half of the backpressure contract)
            if not self._await_acks(deadline_s=self.timeout_s):
                # stalled-but-connected receiver: no ACKs are coming, so
                # waiting again next send just adds a timeout per frame
                # while the window grows without bound.  Bound it
                # ourselves — shed the OLDEST unacked frames down to the
                # same target _await_acks aims for, with accounting
                # (the client-side mirror of the server's DROPPED
                # semantics: counted shed, never silent growth).
                target = self.pending_limit // 2
                for s in sorted(self._pending)[:len(self._pending)
                                               - target]:
                    del self._pending[s]
                    self.timeout_shed += 1
        return seq

    def flush(self, timeout_s: float | None = None) -> bool:
        """Block until every sent frame is acked or shed."""
        return self._await_acks(
            deadline_s=self.timeout_s if timeout_s is None else timeout_s,
            until_empty=True)

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            self.flush()
            self._sock.sendall(pack_frame(F_BYE))
        except (OSError, ConnectionError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None

    # -- server->client frames ------------------------------------------

    def _read_frame(self):
        view = memoryview(self._hdr)
        if _recv_exact(self._sock, view) != _FILLED:
            raise ConnectionError("wire: server closed")
        magic, ftype, flags, length, seq = _HEADER.unpack(self._hdr)
        if magic != MAGIC or length > MAX_FRAME_BYTES:
            raise ConnectionError("wire: bad server frame")
        payload = b""
        if length:
            pbuf = bytearray(length)
            if _recv_exact(self._sock, memoryview(pbuf)) != _FILLED:
                raise ConnectionError("wire: EOF mid-frame")
            payload = bytes(pbuf)
        return ftype, flags, seq, payload

    def _handle(self, ftype: int, seq: int, payload: bytes) -> None:
        if ftype == F_ACK:
            self.acked = max(self.acked, seq)
            self._prune(self.acked)
        elif ftype == F_SLOWDOWN:
            self.slowdowns += 1
            time.sleep(self.slowdown_pause_s)
        elif ftype == F_DROPPED:
            # prune EXACTLY the seqs the server shed: anything else in
            # the window may be accepted-but-uncommitted, and pruning it
            # here would strand it unreplayable if the receiver dies
            # before committing
            try:
                seqs = [int(s) for s in
                        json.loads(payload or b"{}").get("seqs", ())]
            except (ValueError, TypeError):
                seqs = []
            self.server_dropped += len(seqs)
            for s in seqs:                   # shed, acknowledged as shed
                self._pending.pop(s, None)
        elif ftype == F_BYE:
            raise ConnectionError("wire: server said BYE")

    def _prune(self, through: int) -> None:
        for seq in [s for s in self._pending if s <= through]:
            del self._pending[seq]

    def _drain_server(self, block: bool) -> None:
        while self._sock is not None:
            r, _, _ = select.select([self._sock], [], [],
                                    0.05 if block else 0.0)
            if not r:
                return
            ftype, _, seq, payload = self._read_frame()
            self._handle(ftype, seq, payload)
            if not block:
                return

    def _await_acks(self, deadline_s: float,
                    until_empty: bool = False) -> bool:
        deadline = time.monotonic() + deadline_s
        target = self.pending_limit // 2
        while self._pending and (until_empty
                                 or len(self._pending) > target):
            if time.monotonic() > deadline:
                return False
            try:
                self._drain_server(block=True)
            except (OSError, ConnectionError):
                if not self.reconnect:
                    raise
                self._reconnect()
        return True


def push_corpus(address, buckets, *, client_id: str = "wire-push",
                client: WireClient | None = None,
                close: bool = True) -> int:
    """Push an iterable of buckets to a firehose receiver; returns the
    number pushed.  The obs exporter's self-ingestion path and the
    verdict pipeline both ride this."""
    c = client or WireClient(address, client_id=client_id)
    n = 0
    try:
        for b in buckets:
            c.send_bucket(b)
            n += 1
        c.flush()
    finally:
        if close and client is None:
            c.close()
    return n


__all__ = [
    "MAGIC", "HEADER_SIZE", "MAX_FRAME_BYTES", "FLAG_JSONL",
    "F_HELLO", "F_WELCOME", "F_BATCH", "F_ACK", "F_SLOWDOWN",
    "F_DROPPED", "F_BYE",
    "parse_hostport", "pack_frame", "encode_bucket_payload",
    "SpanFirehoseReceiver", "WireClient", "push_corpus",
]
