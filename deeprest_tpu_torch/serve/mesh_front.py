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
  call inside that lock, before its first copy-in, so calls from the HTTP
  handler threads, the batcher's flush thread and the what-if path reach
  every rank in the one order the lock gave them on rank 0.
- :func:`follow` (every other rank) receives each call and enters the
  same function with the same inputs, so the page plan, the rungs and the
  carry are the same on every rank.  It discards the answer.
- The wire: a header of :data:`HEADER` int64 fields (op, flags, three
  dims) broadcast from rank 0 over the job's group, then each array as a
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
    census, current_job, teardown,
)
from deeprest_tpu_torch.parallel.elastic import CENSUS_WAIT_S, is_device_loss
from deeprest_tpu_torch.serve.fused import plan_windows
from deeprest_tpu_torch.serve.server import ServingError

# The ops of the wire, and the flags of a fused call.
APPLY, SPARSE_APPLY, FUSED, HEARTBEAT, STOP = range(5)
_RUNG_OPS = {"apply": APPLY, "sparse_apply": SPARSE_APPLY}
INTEGRATE, SPARSE = 1, 2
# op, flags, dims[3]
HEADER = 5
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
        self.device = (mesh.device if mesh.backend == "nccl"
                       else torch.device("cpu"))

    def send(self, arr: np.ndarray, dtype=np.int64) -> None:
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype))
        dist.broadcast(t.to(self.device), 0, group=self.group)

    def recv(self, shape: tuple, dtype=np.int64) -> np.ndarray:
        t = torch.from_numpy(np.empty(shape, dtype)).to(self.device)
        dist.broadcast(t, 0, group=self.group)
        return t.cpu().numpy()


def _header(op: int, flags: int = 0, dims=()) -> np.ndarray:
    h = np.zeros(HEADER, np.int64)
    h[0], h[1] = op, flags
    h[2:2 + len(dims)] = dims
    return h


class MeshFront:
    """Rank 0's side: announces each device call of ``predictor`` (a
    ``Predictor`` on a mesh of more than one rank, warmed and digested) to
    the job, and attaches itself to it.  A heartbeat thread keeps the
    followers' wait inside the group timeout: it beats when no call has
    gone out for a quarter of it."""

    def __init__(self, predictor):
        mesh = predictor.mesh
        if mesh is None or mesh.size < 2:
            raise ValueError("a mesh front needs a predictor on a mesh of "
                             "more than one rank")
        self._wire = _Wire(mesh)
        self._lock = predictor.graphs.lock
        self.world = mesh.size
        self.lost = threading.Event()
        self._error: str | None = None
        self.calls = 0
        self.heartbeats = 0
        self._heartbeat_s = current_job().timeout.total_seconds() / 4
        self._last = time.monotonic()
        self._quit = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True,
                                        name="mesh-front-heartbeat")
        predictor.attach_front(self)
        self._thread.start()

    @property
    def error(self) -> str | None:
        """Why the front fails its calls (a lost rank, or stopped)."""
        return self._error

    def stats(self) -> dict:
        """``/healthz``'s ``mesh`` key: the world, the calls and heartbeats
        sent, and the error the front fails its calls with (None while it
        serves)."""
        return {"world": self.world, "calls": self.calls,
                "heartbeats": self.heartbeats, "error": self._error}

    # -- rank 0's calls (the caller holds the predictor's graphs lock) ---

    def rung(self, program: str, arrays: dict):
        """The context of one ladder rung of ``program`` ("apply" or
        "sparse_apply") on ``arrays`` (:meth:`call`)."""
        op = _RUNG_OPS[program]
        a = list(arrays.values())
        return self.call(op, zip(a, _DTYPES[op == SPARSE_APPLY]),
                         dims=a[0].shape)

    def fused(self, arrays: list, integrate: bool, sparse: bool):
        """The context of one fused call on ``arrays`` (a tuple of ``[T_i,
        ...]`` arrays a series: ``(x,)``, or ``(cols, vals)`` when
        ``sparse``), sent as the lengths and each array concatenated."""
        lengths = np.array([len(a[0]) for a in arrays], np.int64)
        cat = [np.concatenate([a[i] for a in arrays])
               for i in range(len(arrays[0]))]
        flags = (INTEGRATE if integrate else 0) | (SPARSE if sparse else 0)
        return self.call(FUSED, [(lengths, np.int64),
                                 *zip(cat, _DTYPES[sparse])],
                         flags=flags, dims=(len(arrays), *cat[0].shape))

    @contextlib.contextmanager
    def call(self, op: int, arrays, flags: int = 0, dims=()):
        """Send the header and ``arrays`` (``(array, dtype)`` pairs), then
        run the caller's body (the same call on this rank).  A failure of
        either whose cause is a lost peer fails the front and raises
        :class:`MeshFrontLost`."""
        if self._error is not None:
            raise MeshFrontLost(self._error)
        try:
            self._send(_header(op, flags, dims), arrays)
            self.calls += 1
            yield
        except Exception as exc:
            if not is_device_loss(exc):
                raise
            raise self._fail(exc) from exc

    def _send(self, header: np.ndarray, arrays=()) -> None:
        self._wire.send(header)
        for a, dtype in arrays:
            self._wire.send(a, dtype)
        self._last = time.monotonic()

    def _fail(self, exc: BaseException) -> MeshFrontLost:
        cause = f"{type(exc).__name__}: {str(exc)[:200]}"
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
                    self._send(_header(HEARTBEAT))
                    self.heartbeats += 1
                except Exception as exc:
                    # a heartbeat that cannot reach every rank leaves the
                    # plane unable to answer, whatever the cause
                    self._fail(exc)
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
                self._send(_header(STOP))

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


def follow(predictor) -> None:
    """A follower's loop (ranks 1 and up): receive each call rank 0
    announces and make it on ``predictor`` (this rank's ``Predictor`` on
    the same mesh, warmed and digested as rank 0's) with the same inputs,
    until ``STOP``.  A call that raised on rank 0 raises the same here and
    is passed over; a lost peer raises out of the loop."""
    wire = _Wire(predictor.mesh)
    calls = 0
    while True:
        op, flags, *dims = wire.recv((HEADER,)).tolist()
        if op == STOP:
            return
        if op == HEARTBEAT:
            continue
        if op in (APPLY, SPARSE_APPLY):
            entry = (predictor._apply_numpy if op == APPLY
                     else predictor._apply_sparse_numpy)
            run = functools.partial(entry, *(
                wire.recv(tuple(dims), dt)
                for dt in _DTYPES[op == SPARSE_APPLY]))
        elif op == FUSED:
            run = _fused_call(predictor, wire, flags, dims)
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
