"""Serving over a mesh of more than one rank (``serve --mesh D,E,M``): rank
0 fronts the HTTP plane and mirrors each device call to the other ranks,
which replay it in step.

JAX's single controller drives every device of a serving mesh from one
process, so its HTTP plane needs nothing of the kind.  The port runs one
rank a device, and the programs of a sharded ``Predictor`` hold
collectives (the answer's all-gather over the expert axis, the partial
sums over the model axis) that meet only when every rank runs the same
program on the same inputs in the same order.

- Every served device call goes through one of two host→device entries:
  ``RungServing._run_rung`` (the shape ladder's dense and sparse apply)
  and ``FusedRolledEngine._predict_many_inner`` (the fused engine's
  pages).  Each holds its predictor's ``graphs.lock`` across the call.
  With a :class:`MeshFront` attached (rank 0), each entry announces its
  call inside that lock, before its first copy-in, and holds the front's
  own lock until the call is done, so calls from the HTTP handler
  threads, the batcher's flush thread, the what-if path, the capacity
  surfaces' warm threads and the verdict ingestor's sweeps reach every
  rank in the one order the front's lock gave them on rank 0, whichever
  predictor made them.
- :func:`follow` (every other rank) receives each call and enters the
  same function with the same inputs, so the page plan, the rungs and the
  carry are the same on every rank.  It discards the answer.
- The wire: a header of :data:`HEADER` int64 fields (op, flags, the
  predictor's generation, three dims) broadcast from rank 0 over the
  job's group, then each array as a
  broadcast of its own: CPU tensors under gloo, device tensors under NCCL.
  A fused call sends its series' lengths and the series concatenated on
  the row axis; each rank plans the same windows from the lengths
  (``serve/fused.py::plan_windows``).  Nothing is pickled.
- Idling: a follower waits for the next call inside a broadcast, which
  fails after the job's group timeout (``parallel/distributed.py``,
  ``JOB_TIMEOUT_S``).  So rank 0 sends a ``HEARTBEAT`` whenever no call
  has gone out for a quarter of that timeout.
- A lost rank: a mirrored call or a heartbeat whose collective fails with
  a peer gone (``parallel.elastic.is_device_loss``) fails the front for
  good.  That call and every later one raise :class:`MeshFrontLost`, an
  HTTP 503, and :attr:`MeshFront.lost` is set.  The CLI then stops the
  server and names the lost ranks (:meth:`MeshFront.lost_ranks`: a
  teardown, then the job's census).  Rank 0 never answers from its own
  shard alone.
- ``STOP`` (:meth:`MeshFront.stop`) ends every follower's loop.
- The ``params_digest`` of a sharded predictor is a collective.  Every
  rank computes it before the socket listens and it is cached, so no
  ``/healthz`` starts one.
- Reloads (``serve --mesh --watch``): rank 0's ``CheckpointReloader``
  lists the directory alone and hands a new step to :meth:`MeshFront.
  reload`, which names a new generation and runs the reload as mirrored
  ops, each under the front's lock and the lock released between them, so
  requests go on meanwhile: ``RELOAD`` (every rank loads the step on the
  served mesh with the same ``load``, the quant mode and serving knobs of
  the plane, and the ranks agree: :func:`load_agreed`), one ``WARM`` per
  unit of its warm-up (``Predictor.warm_units``), and ``READY`` (its
  digest, and the ranks' agreement that every unit ran: :func:`settle`).
  A step that failed on any rank leaves every rank on the old one.  The
  service's swap announces ``SWAP``, which names the served generation;
  every call carries the generation of the predictor that makes it, so a
  request that took the old predictor before the swap is replayed on the
  old one by every rank.  At each ``RELOAD`` every rank drops the
  generations older than the served one (a newer one loaded and not yet
  swapped in stays), and rank 0 refuses (503) a call from a dropped one.
  A replica plane's rolling reload has drained every replica of the older
  generations before its ``SWAP``, which therefore drops them at once
  (the flag :data:`DROP`).  Generations in ``keep`` are never dropped: a
  fleet's default tenant stays the generation the pool admitted, as JAX's
  pool keeps the predictor it admitted.  Every ``SWAP`` ends with a MAX
  all-reduce of how many generations each rank holds and the oldest it
  holds, which rank 0 reports under ``/healthz``'s ``mesh.generations``.
- The replica and fleet plane (``serve --mesh`` with ``--replicas``,
  ``--fleet``, ``--autoscale``): the ops ``GATHER`` (the whole params of
  the mesh predictor, for a one-device clone on another device:
  ``Predictor.whole_params``), ``SPILL`` and ``RESTORE`` (the fleet's
  default tenant moving its shards to the host and back:
  ``Predictor.spill``, ``Predictor.restore``) are collectives or moves
  every rank makes in step, each under the front's lock on the
  generation it names.  One-device stacks (clones, fleet tenants,
  process workers) have no front and announce nothing.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from deeprest_tpu_torch.parallel.distributed import (
    agree, census, current_job, host_wire_device, teardown,
)
from deeprest_tpu_torch.parallel.elastic import CENSUS_WAIT_S, is_device_loss
from deeprest_tpu_torch.serve.fused import plan_windows
from deeprest_tpu_torch.serve.server import ServingError

# The ops of the wire, and the flags of a fused call.
(APPLY, SPARSE_APPLY, FUSED, HEARTBEAT, STOP, RELOAD, WARM, READY,
 SWAP, GATHER, SPILL, RESTORE) = range(12)
_RUNG_OPS = {"apply": APPLY, "sparse_apply": SPARSE_APPLY}
INTEGRATE, SPARSE = 1, 2
DROP = 1                   # SWAP's flag: drop the older generations now
_MIRRORED_OPS = {"gather": GATHER, "spill": SPILL, "restore": RESTORE}
# op, flags, generation, dims[3]
HEADER = 6
# the arrays a call sends, by whether its windows are padded COO
_DTYPES = {False: (np.float32,), True: (np.int32, np.float32)}


class MeshFrontLost(ServingError):
    """A rank of the serving mesh is gone (or the front was stopped): the
    plane cannot answer, since the answer needs every rank.  HTTP 503."""

    def __init__(self, message: str):
        super().__init__(message, status=503)


class _Wire:
    """Broadcasts from rank 0 over the mesh's job group: CPU tensors under
    gloo, the rank's device tensors under NCCL."""

    def __init__(self, mesh):
        self.group = mesh.group
        self.device = host_wire_device(mesh)

    def send(self, arr: np.ndarray, dtype=np.int64) -> None:
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype))
        dist.broadcast(t.to(self.device), 0, group=self.group)

    def recv(self, shape: tuple, dtype=np.int64) -> np.ndarray:
        t = torch.from_numpy(np.empty(shape, dtype)).to(self.device)
        dist.broadcast(t, 0, group=self.group)
        return t.cpu().numpy()


def _header(op: int, flags: int = 0, gen: int = 0, dims=()) -> np.ndarray:
    h = np.zeros(HEADER, np.int64)
    h[0], h[1], h[2] = op, flags, gen
    h[3:3 + len(dims)] = dims
    return h


def load_agreed(mesh, load, step: int):
    """Every rank's ``RELOAD``: ``load(step)`` (a ``Predictor`` on
    ``mesh``), then the ranks' agreement.  Returns the predictor when
    every rank got there; raises this rank's error, or a
    ``FileNotFoundError`` where the failure was another rank's, on every
    rank otherwise.  A lost peer raises at once."""
    fresh, error = None, None
    try:
        fresh = load(step)
    except Exception as exc:
        if is_device_loss(exc):
            raise
        fresh, error = None, exc
    if agree(mesh, error is None):
        return fresh
    raise error or FileNotFoundError(
        f"checkpoint step {step} failed to load on another rank of the "
        "serving mesh")


def live_spread(mesh, live) -> tuple[int, int]:
    """Every rank's end of a ``SWAP``: (the most generations a rank
    holds, the oldest generation a rank holds), a MAX all-reduce over
    the job of each rank's ``live`` generations."""
    t = torch.tensor([len(live), -min(live)], dtype=torch.int64,
                     device=host_wire_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t[0]), -int(t[1])


def settle(mesh, fresh, ok: bool) -> bool:
    """Every rank's ``READY``: the end of ``fresh``'s warm-up
    (``Predictor.warmed``) and its digest (a collective), then whether
    every rank got there with ``ok`` (its ``WARM`` units all ran).  A lost
    peer raises."""
    try:
        fresh.warmed()
        fresh.params_digest()
    except Exception as exc:
        if is_device_loss(exc):
            raise
        ok = False
    return agree(mesh, ok)


class _Generation:
    """The front as one predictor sees it: its calls carry the
    generation ``gen`` of the predictor, whose checkpoint step is
    ``step`` (what ``attach_front`` holds)."""

    def __init__(self, front: "MeshFront", gen: int, step):
        self.front, self.gen, self.step = front, gen, step

    def rung(self, program: str, arrays: dict):
        return self.front.rung(program, arrays, self.gen)

    def fused(self, arrays: list, integrate: bool, sparse: bool):
        return self.front.fused(arrays, integrate, sparse, self.gen)

    def swapped(self, drop: bool = False) -> None:
        """The service now serves this generation: announce ``SWAP``
        (with ``drop``, every replica was drained of the older ones)."""
        self.front.swapped(self.gen, drop)

    def mirrored(self, what: str, body):
        """``body()``, this rank's side of the op ``what`` ("gather",
        "spill" or "restore") on this generation, which every rank
        makes."""
        return self.front.mirrored(_MIRRORED_OPS[what], self.gen, body)

    def stats(self) -> dict:
        """``/healthz``'s ``mesh`` key: the front's stats and this
        generation and its checkpoint step (what the service that holds
        this predictor serves)."""
        return {**self.front.stats(), "step": self.step,
                "generation": self.gen}


class MeshFront:
    """Rank 0's side: announces each device call of ``predictor`` (a
    ``Predictor`` on a mesh of more than one rank, warmed and digested) to
    the job, and attaches itself to it as generation 0.  ``load(step)``
    (the one every follower holds) builds a predictor of a newer step on
    the same mesh for :meth:`reload`.  A heartbeat thread keeps the
    followers' wait inside the group timeout: it beats when no call has
    gone out for a quarter of it.  The generations in ``keep`` (the same
    on every rank) are never dropped."""

    def __init__(self, predictor, load=None, keep=()):
        mesh = predictor.mesh
        if mesh is None or mesh.size < 2:
            raise ValueError("a mesh front needs a predictor on a mesh of "
                             "more than one rank")
        self.mesh = mesh
        self._load = load
        self._wire = _Wire(mesh)
        # held from each call's header to the end of its body, so the
        # wire's order is the order of every predictor's calls
        self._lock = threading.RLock()
        self.world = mesh.size
        self.lost = threading.Event()
        self._error: str | None = None
        self.calls = 0
        self.heartbeats = 0
        self.reloads = {"ok": 0, "failed": 0}
        self._served = 0             # the generation the service serves
        self._live = {0}             # the generations every rank holds
        self._keep = frozenset(keep)
        self._spread = (1, 0)        # SWAP's all-reduce: most, oldest
        self._next_gen = 1
        self._heartbeat_s = current_job().timeout.total_seconds() / 4
        self._last = time.monotonic()
        self._quit = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True,
                                        name="mesh-front-heartbeat")
        predictor.attach_front(_Generation(self, 0, predictor.step))
        self._thread.start()

    @property
    def error(self) -> str | None:
        """Why the front fails its calls (a lost rank, or stopped)."""
        # graftlint: disable=TH004 -- read after lost is set, which _fail_locked sets after this write; a lock here could wait on a call stuck on the dead rank
        return self._error

    def stats(self) -> dict:
        """The world, the calls and heartbeats sent, the reloads loaded
        and refused, and the error the front fails its calls with (None
        while it serves)."""
        with self._lock:
            return {"world": self.world, "calls": self.calls,
                    "heartbeats": self.heartbeats,
                    "reloads": dict(self.reloads),
                    "generations": {"live": sorted(self._live),
                                    "most_on_a_rank": self._spread[0],
                                    "oldest_on_a_rank": self._spread[1]},
                    "error": self._error}

    # -- rank 0's calls (the caller holds the predictor's graphs lock) ---

    def rung(self, program: str, arrays: dict, gen: int = 0):
        """The context of one ladder rung of ``program`` ("apply" or
        "sparse_apply") on ``arrays`` (:meth:`call`)."""
        op = _RUNG_OPS[program]
        a = list(arrays.values())
        return self.call(op, zip(a, _DTYPES[op == SPARSE_APPLY]),
                         dims=a[0].shape, gen=gen)

    def fused(self, arrays: list, integrate: bool, sparse: bool,
              gen: int = 0):
        """The context of one fused call on ``arrays`` (a tuple of ``[T_i,
        ...]`` arrays a series: ``(x,)``, or ``(cols, vals)`` when
        ``sparse``), sent as the lengths and each array concatenated."""
        lengths = np.array([len(a[0]) for a in arrays], np.int64)
        cat = [np.concatenate([a[i] for a in arrays])
               for i in range(len(arrays[0]))]
        flags = (INTEGRATE if integrate else 0) | (SPARSE if sparse else 0)
        return self.call(FUSED, [(lengths, np.int64),
                                 *zip(cat, _DTYPES[sparse])],
                         flags=flags, dims=(len(arrays), *cat[0].shape),
                         gen=gen)

    @contextlib.contextmanager
    def call(self, op: int, arrays, flags: int = 0, dims=(), gen: int = 0):
        """Under the front's lock: send the header and ``arrays``
        (``(array, dtype)`` pairs), then run the caller's body (the same
        call on this rank) on generation ``gen``.  A failure of either
        whose cause is a lost peer fails the front and raises
        :class:`MeshFrontLost`; a generation the ranks dropped raises a
        503 before anything is sent."""
        with self._lock:
            if self._error is not None:
                raise MeshFrontLost(self._error)
            if gen not in self._live:
                raise ServingError(
                    "the served checkpoint step changed during this "
                    "request; retry it", status=503)
            try:
                self._send_locked(_header(op, flags, gen, dims), arrays)
                self.calls += 1
                yield
            except Exception as exc:
                if not is_device_loss(exc):
                    raise
                raise self._fail_locked(exc) from exc

    # -- reloads (rank 0's reloader thread; every rank in step) ----------

    def reload(self, step: int):
        """Load checkpoint ``step`` on every rank: ``RELOAD``, a ``WARM``
        per warm-up unit and ``READY``, each a mirrored op under the
        front's lock, which is released between them.  Returns the warmed,
        digested predictor, attached to this front as a new generation
        (the service swaps it in; :meth:`swapped`); raises on every
        rank's behalf when any rank failed, the served generation left in
        place."""
        if self._load is None:
            raise RuntimeError("this mesh front was built without a load: "
                               "it cannot reload")
        with self._lock:
            gen, self._next_gen = self._next_gen, self._next_gen + 1
            self._live = _kept(self._live, self._served, self._keep)
            try:
                fresh = self._op(_header(RELOAD, gen=gen, dims=(step,)),
                                 load_agreed, self.mesh, self._load, step)
            except MeshFrontLost:
                raise
            except Exception:
                self.reloads["failed"] += 1
                raise
            self._live.add(gen)
        error = None
        for i, unit in enumerate(fresh.warm_units()):
            try:
                self._op(_header(WARM, gen=gen, dims=(i,)), unit)
            except MeshFrontLost:
                raise
            except Exception as exc:
                error = exc
                break
        with self._lock:
            if not self._op(_header(READY, gen=gen), settle, self.mesh,
                            fresh, error is None):
                self._live.discard(gen)
                self.reloads["failed"] += 1
                raise error or RuntimeError(
                    f"checkpoint step {step} failed to warm on another "
                    "rank of the serving mesh")
            self.reloads["ok"] += 1
        fresh.attach_front(_Generation(self, gen, fresh.step))
        return fresh

    def swapped(self, gen: int, drop: bool = False) -> None:
        """Announce ``SWAP`` to generation ``gen``: the service now serves
        it (or a newer one, whose swap came first).  With ``drop`` (a
        replica plane's rolling reload, which drained every replica of
        the older generations first) every rank drops them now."""
        with self._lock:
            if self._error is None:
                self._served = max(self._served, gen)
                if drop:
                    self._live = _kept(self._live, self._served, self._keep)
                self._spread = self._op(
                    _header(SWAP, DROP if drop else 0, gen), live_spread,
                    self.mesh, self._live)

    def mirrored(self, op: int, gen: int, body):
        """Under the front's lock: send ``op`` on generation ``gen``
        (``GATHER``, ``SPILL`` or ``RESTORE``), then run ``body()``, this
        rank's side of it, and return its result."""
        with self._lock:
            if gen not in self._live:
                raise ServingError(
                    f"generation {gen} of the serving mesh was dropped",
                    status=503)
            return self._op(_header(op, gen=gen), body)

    def _op(self, header: np.ndarray, body=None, *args):
        """Under the front's lock: send ``header``, then run ``body(*args)``
        (this rank's side of the op) and return its result.  A failure of
        either whose cause is a lost peer fails the front and raises
        :class:`MeshFrontLost`."""
        with self._lock:
            if self._error is not None:
                raise MeshFrontLost(self._error)
            try:
                self._send_locked(header)
                return None if body is None else body(*args)
            except Exception as exc:
                if not is_device_loss(exc):
                    raise
                raise self._fail_locked(exc) from exc

    def _send_locked(self, header: np.ndarray, arrays=()) -> None:
        """Send ``header`` and ``arrays``; the caller holds the lock."""
        self._wire.send(header)
        for a, dtype in arrays:
            self._wire.send(a, dtype)
        # graftlint: disable=TH001 -- every caller (call, _op, _beat, stop) holds self._lock around this call
        self._last = time.monotonic()

    def _fail_locked(self, exc: BaseException) -> MeshFrontLost:
        """Fail the front for ``exc``; the caller holds the lock."""
        cause = f"{type(exc).__name__}: {str(exc)[:200]}"
        # graftlint: disable=TH001 -- every caller holds self._lock; the lock-free reader (error) runs after lost.set() below
        self._error = f"a rank of the serving mesh is gone ({cause})"
        self.lost.set()
        return MeshFrontLost(self._error)

    def _beat(self) -> None:
        while not self._quit.wait(self._heartbeat_s):
            with self._lock:
                if (self._error is not None or self._quit.is_set()
                        or time.monotonic() - self._last
                        < self._heartbeat_s):
                    continue
                try:
                    self._send_locked(_header(HEARTBEAT))
                    self.heartbeats += 1
                except Exception as exc:
                    # a heartbeat that cannot reach every rank leaves the
                    # plane unable to answer, whatever the cause
                    self._fail_locked(exc)
                    return

    # -- ending ---------------------------------------------------------

    def stop(self) -> None:
        """Stop the heartbeat and send ``STOP``: every follower's loop
        returns.  Later calls raise :class:`MeshFrontLost`."""
        self._quit.set()
        self._thread.join()
        with self._lock:
            if self._error is None:
                self._error = "the serving mesh was stopped"
                self._send_locked(_header(STOP))

    def lost_ranks(self) -> list[int]:
        """After :attr:`lost`: tear this rank's groups down, so a follower
        blocked on one of them fails at once, and take the job's census
        (every survivor checks in).  Returns the ranks that did not."""
        self._quit.set()
        self._thread.join()
        with self._lock:
            teardown()
        survivors = census(True, CENSUS_WAIT_S)
        return [r for r in range(self.world) if r not in survivors]


def _kept(live, served: int, keep):
    """``live`` (generations, or a dict keyed by them) without those older
    than ``served`` that ``keep`` does not hold."""
    kept = [g for g in live if g >= served or g in keep]
    return ({g: live[g] for g in kept} if isinstance(live, dict)
            else set(kept))


def follow(predictor, load=None, keep=()) -> None:
    """A follower's loop (ranks 1 and up): receive each call rank 0
    announces and make it on the predictor of its generation (at first
    ``predictor``, this rank's ``Predictor`` on the same mesh, warmed and
    digested as rank 0's) with the same inputs, until ``STOP``.  A
    ``RELOAD`` loads its step with ``load`` (rank 0's) in step with every
    rank, each ``WARM`` runs a unit of its warm-up and ``READY`` settles
    it; a ``SWAP`` names the served generation (and with :data:`DROP`
    drops the older ones but ``keep``, rank 0's).  ``GATHER``, ``SPILL``
    and ``RESTORE`` gather, spill and restore this rank's shards of their
    generation.  A call that raised on rank 0 raises the same here and is
    passed over, as does a reload every rank refused; a lost peer raises
    out of the loop."""
    mesh = predictor.mesh
    wire = _Wire(mesh)
    keep = frozenset(keep)
    live, served = {0: predictor}, 0
    spilled = {}                 # a SPILL's host copies, by generation
    cold = set()                 # reloads with a warm-up unit that raised
    calls = 0
    while True:
        op, flags, gen, *dims = wire.recv((HEADER,)).tolist()
        if op == STOP:
            return
        if op == HEARTBEAT:
            continue
        if op == SWAP:
            served = max(served, gen)
            if flags & DROP:
                live = _kept(live, served, keep)
            live_spread(mesh, live)
            continue
        if op == GATHER:
            live[gen].whole_params()
            continue
        if op == SPILL:
            spilled[gen] = live[gen].spill()
            continue
        if op == RESTORE:
            live[gen].restore(spilled.pop(gen))
            continue
        if op == RELOAD:
            live = _kept(live, served, keep)
            if load is None:
                raise ValueError("mesh front: RELOAD from rank 0, but this "
                                 "follower was given no load")
            try:
                live[gen] = load_agreed(mesh, load, dims[0])
            except Exception as exc:
                if is_device_loss(exc):
                    raise
                _refused(f"of step {dims[0]}", f"{type(exc).__name__}: {exc}")
            continue
        if op == WARM:
            try:
                live[gen].warm_units()[dims[0]]()
            except Exception as exc:
                if is_device_loss(exc):
                    raise
                cold.add(gen)
            continue
        if op == READY:
            if not settle(mesh, live[gen], gen not in cold):
                del live[gen]
                _refused(f"to generation {gen}",
                         "its warm-up or digest failed on a rank")
            cold.discard(gen)
            continue
        target = live[gen]
        if op in (APPLY, SPARSE_APPLY):
            entry = (target._apply_numpy if op == APPLY
                     else target._apply_sparse_numpy)
            run = functools.partial(entry, *(
                wire.recv(tuple(dims), dt)
                for dt in _DTYPES[op == SPARSE_APPLY]))
        elif op == FUSED:
            run = _fused_call(target, wire, flags, dims)
        else:
            raise ValueError(f"mesh front: unknown op {op} from rank 0")
        try:
            run()
        except Exception as exc:
            if is_device_loss(exc):
                raise
            print(f"mesh follower: call {calls} raised "
                  f"{type(exc).__name__}: {exc} (as on rank 0, whose "
                  "caller got it)", file=sys.stderr, flush=True)
        calls += 1


def _refused(what: str, why: str) -> None:
    print(f"mesh follower: reload {what} refused on every rank ({why})",
          file=sys.stderr, flush=True)


def _fused_call(predictor, wire: _Wire, flags: int, dims):
    """Receive a fused call's lengths and series; returns the call."""
    n_series, rows, width = dims
    sparse = bool(flags & SPARSE)
    lengths = wire.recv((n_series,)).tolist()
    cat = [wire.recv((rows, width), dt) for dt in _DTYPES[sparse]]
    bounds = np.cumsum([0, *lengths])
    arrays = [tuple(a[lo:hi] for a in cat)
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    metas = plan_windows(lengths, predictor.window_size)
    return functools.partial(predictor.fused._predict_many_inner, arrays,
                             metas, bool(flags & INTEGRATE), sparse=sparse)
