"""The epoch plan on the device and the CUDA-graph capture of one optimizer
update.

The JAX trainer has no module for this: ``jax.jit`` with a donated state
compiles a superstep of S train steps into one dispatch
(``deeprest_tpu/train/trainer.py``, ``train_superstep``).  The port's
counterpart captures one optimizer update as a CUDA graph and replays it
once per update of a superstep, so the host does no per-step work but the
replay:

- :class:`EpochPlan` holds the epoch's shuffled batch plan in static device
  buffers, ``starts`` and ``weights`` ``[U, G, B]`` (U updates of G
  microbatches of B windows; a data-parallel rank's B is its slice of the
  global batch), the global batch's weight sums ``den`` ``[U, G]`` (the
  loss's denominator), staged once per epoch, a device ``cursor`` (the
  next update) and the ``[U, G]`` per-microbatch losses of the epoch.  An
  update reads its ``[G, B]`` starts and weights and its ``[G]`` sums at
  the cursor, writes its losses there and advances the cursor, all on the
  device, so the same code runs eagerly (the CPU,
  ``steps_per_superstep=1``) and inside a graph.
- :class:`HostFeed` is the host-streamed feed's counterpart of the staged
  series: static device buffers that hold the windows of the update about
  to run, filled before each update from a ring of pinned host slots (the
  JAX package's ``parallel/distributed.py::prefetch_to_device``), so an
  update reads its inputs at fixed addresses, eager or replayed.
- :func:`capture_update` records one update on a side stream into a
  ``CapturedGraph`` (``deeprest_tpu_torch/graphs.py``, shared with the
  serving plane's rung graphs).  The caller runs the update eagerly first (the
  run's real first update, which builds the kernels and the optimizer's
  state), keeps the gradients allocated (they live in the graph's pool
  across replays), builds Adam with ``capturable=True`` and registers its
  dropout generator.  A failed capture raises ``GraphCaptureError``
  naming the source line of the failing op; it never falls back to the
  eager loop.  A replay adds the graph's kernel launches to their counts
  (the launch ledger).  On a mesh the captured update holds the mesh's
  collectives too (the gradient bucket's all-reduce over the data group,
  and the model's over the expert and model groups,
  ``parallel/collectives.py``): NCCL's capture with the update; gloo's
  cannot, and the trainer refuses a captured superstep under gloo.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from deeprest_tpu_torch.graphs import CapturedGraph, capture


class EpochPlan:
    """Static buffers of one epoch's plan, ``U`` updates of ``G``
    microbatches of ``B`` windows (this rank's), on ``device``."""

    def __init__(self, updates: int, groups: int, batch: int,
                 device: torch.device):
        self.starts = torch.zeros((updates, groups, batch), dtype=torch.long,
                                  device=device)
        self.weights = torch.zeros((updates, groups, batch),
                                   dtype=torch.float32, device=device)
        self.den = torch.zeros((updates, groups), dtype=torch.float32,
                               device=device)
        self.losses = torch.zeros((updates, groups), dtype=torch.float32,
                                  device=device)
        self.cursor = torch.zeros((1,), dtype=torch.long, device=device)
        self.staged = None      # the (x_base, y_base) the updates gather from

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.starts.shape)

    def stage(self, starts: np.ndarray, weights: np.ndarray,
              den: np.ndarray, first_update: int) -> None:
        """Copy an epoch's ``[U·G, B]`` plan and its ``[U·G]`` global
        weight sums in (one host-to-device copy each) and point the cursor
        at ``first_update``."""
        self.starts.copy_(torch.from_numpy(
            np.asarray(starts, np.int64).reshape(self.shape)))
        self.weights.copy_(torch.from_numpy(
            np.asarray(weights, np.float32).reshape(self.shape)))
        self.den.copy_(torch.from_numpy(
            np.asarray(den, np.float32).reshape(self.shape[:2])))
        self.cursor.fill_(first_update)

    def take(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The ``[G, B]`` starts and weights and the ``[G]`` global weight
        sums of the update at the cursor."""
        return (self.starts.index_select(0, self.cursor)[0],
                self.weights.index_select(0, self.cursor)[0],
                self.den.index_select(0, self.cursor)[0])

    def put(self, losses: torch.Tensor) -> None:
        """Record the update's ``[G]`` losses at the cursor and advance
        it."""
        self.losses.index_copy_(0, self.cursor, losses[None])
        self.cursor.add_(1)

    def microbatch_losses(self, lo: int, hi: int) -> np.ndarray:
        """A copy of the losses of plan microbatches ``lo:hi`` (one device
        readback; the buffer is the next epoch's)."""
        return self.losses.reshape(-1)[lo:hi].cpu().numpy().copy()


class HostFeed:
    """The windows of one update, streamed from the host.

    ``x`` ``[1, B, W, F]`` in the compute dtype and ``y`` ``[1, B, W, E]``
    f32 are static device buffers the update reads (the trainer's
    ``_gather`` returns them whatever the start indices); a data-parallel
    rank's B is its slice of the global batch, and it is fed only its own
    rows.  :meth:`put`
    fills them with the windows ``x_windows[sel]`` and ``y_windows[sel]``.

    On a CUDA device it goes through a ring of ``depth`` slots: the host
    gathers the windows straight into a pinned slot (one host copy), a copy
    stream moves it to the slot's device buffer behind the event that says
    the compute stream has taken that buffer's previous windows, and the
    compute stream waits for the copy, then copies (and casts) the slot into
    the static buffers; at 3 TB/s that copy takes microseconds.  The host
    waits only before it overwrites a pinned slot, for that slot's copy
    ``depth`` updates back, so it runs up to ``depth`` updates ahead of the
    card and never synchronizes it.  On the CPU :meth:`put` copies into the
    static buffers directly.  :meth:`close` drops the ring (the static
    buffers stay, a captured update reads them)."""

    def __init__(self, batch: int, window: int, features: int,
                 metrics: int, dtype: torch.dtype, device: torch.device,
                 depth: int = 2):
        self.device = device
        self.depth = max(1, int(depth))
        self.x = torch.zeros((1, batch, window, features), dtype=dtype,
                             device=device)
        self.y = torch.zeros((1, batch, window, metrics),
                             dtype=torch.float32, device=device)
        self._ring = None
        self._next = 0

    @property
    def shape(self) -> tuple:
        """``(B, W, F, E, dtype)``."""
        return (*self.x.shape[1:], self.y.shape[-1], self.x.dtype)

    def _make_ring(self) -> list:
        b, w, f = self.x.shape[1:]
        e = self.y.shape[-1]
        ring = []
        for _ in range(self.depth):
            host_x = torch.empty((b, w, f), dtype=torch.float32,
                                 pin_memory=True)
            host_y = torch.empty((b, w, e), dtype=torch.float32,
                                 pin_memory=True)
            ring.append({
                "host": (host_x, host_y),
                "views": (host_x.numpy(), host_y.numpy()),
                "dev": (torch.empty_like(host_x, device=self.device),
                        torch.empty_like(host_y, device=self.device)),
                "copied": torch.cuda.Event(), "taken": torch.cuda.Event(),
                "used": False})
        self._copy_stream = torch.cuda.Stream(device=self.device)
        return ring

    def put(self, x_windows: np.ndarray, y_windows: np.ndarray,
            sel: np.ndarray) -> None:
        """The windows ``sel`` of ``x_windows`` ``[N, W, F]`` and
        ``y_windows`` ``[N, W, E]`` (numpy, e.g. strided views of the base
        series) into the static buffers, ordered before the next update
        on the current stream."""
        if self.device.type != "cuda":
            self.x[0].copy_(torch.from_numpy(x_windows[sel]))
            self.y[0].copy_(torch.from_numpy(y_windows[sel]))
            return
        if self._ring is None:
            self._ring = self._make_ring()
        slot = self._ring[self._next]
        self._next = (self._next + 1) % self.depth
        if slot["used"]:
            slot["copied"].synchronize()     # its last copy has left it
        hx, hy = slot["views"]
        for i, s in enumerate(sel):          # one copy, into pinned memory
            hx[i] = x_windows[s]
            hy[i] = y_windows[s]
        dx, dy = slot["dev"]
        copy = self._copy_stream
        copy.wait_event(slot["taken"])       # the update took its last windows
        with torch.cuda.stream(copy):
            dx.copy_(slot["host"][0], non_blocking=True)
            dy.copy_(slot["host"][1], non_blocking=True)
        slot["copied"].record(copy)
        current = torch.cuda.current_stream(self.device)
        current.wait_event(slot["copied"])
        self.x[0].copy_(dx)
        self.y[0].copy_(dy)
        slot["taken"].record(current)
        slot["used"] = True

    def close(self) -> None:
        """Let the ring go once its copies have landed (the caching
        allocators keep the blocks for the next epoch's ring)."""
        if self._ring is not None:
            for slot in self._ring:
                if slot["used"]:
                    slot["copied"].synchronize()
            self._ring = None
            self._next = 0


def capture_update(body: Callable[[], None], device: torch.device,
                   generators: Iterable[torch.Generator] = (),
                   pool=None, stream: torch.cuda.Stream | None = None
                   ) -> CapturedGraph:
    """Capture ``body`` (one optimizer update, already run eagerly once)
    into a CUDA graph on ``stream`` (a new side stream of ``device`` when
    None), in memory ``pool`` (a retired graph's, which must never replay
    again; the graph's own when None); see ``deeprest_tpu_torch/graphs.py``.
    Raises ``GraphCaptureError`` if the capture fails."""
    graph, _ = capture(body, device, "one optimizer update", generators,
                       pool=pool, stream=stream)
    return graph
