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
  microbatches of B windows), staged once per epoch, a device ``cursor``
  (the next update) and the ``[U, G]`` per-microbatch losses of the
  epoch.  An update reads its ``[G, B]`` starts and weights at the cursor,
  writes its losses there and advances the cursor, all on the device, so
  the same code runs eagerly (the CPU, ``steps_per_superstep=1``) and
  inside a graph.
- :func:`capture_update` records one update on a side stream into a
  ``CapturedGraph`` (``deeprest_tpu_torch/graphs.py``, shared with the
  serving plane's rung graphs).  The caller runs the update eagerly first (the
  run's real first update, which builds the kernels and the optimizer's
  state), keeps the gradients allocated (they live in the graph's pool
  across replays), builds Adam with ``capturable=True`` and registers its
  dropout generator.  A failed capture raises ``GraphCaptureError``
  naming the source line of the failing op; it never falls back to the
  eager loop.  A replay adds the graph's kernel launches to their counts
  (the launch ledger).
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from deeprest_tpu_torch.graphs import CapturedGraph, capture


class EpochPlan:
    """Static buffers of one epoch's plan, ``U`` updates of ``G``
    microbatches of ``B`` windows, on ``device``."""

    def __init__(self, updates: int, groups: int, batch: int,
                 device: torch.device):
        self.starts = torch.zeros((updates, groups, batch), dtype=torch.long,
                                  device=device)
        self.weights = torch.zeros((updates, groups, batch),
                                   dtype=torch.float32, device=device)
        self.losses = torch.zeros((updates, groups), dtype=torch.float32,
                                  device=device)
        self.cursor = torch.zeros((1,), dtype=torch.long, device=device)
        self.staged = None      # the (x_base, y_base) the updates gather from

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.starts.shape)

    def stage(self, starts: np.ndarray, weights: np.ndarray,
              first_update: int) -> None:
        """Copy an epoch's ``[U·G, B]`` plan in (one host-to-device copy
        each) and point the cursor at ``first_update``."""
        self.starts.copy_(torch.from_numpy(
            np.asarray(starts, np.int64).reshape(self.shape)))
        self.weights.copy_(torch.from_numpy(
            np.asarray(weights, np.float32).reshape(self.shape)))
        self.cursor.fill_(first_update)

    def take(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The ``[G, B]`` starts and weights of the update at the cursor."""
        return (self.starts.index_select(0, self.cursor)[0],
                self.weights.index_select(0, self.cursor)[0])

    def put(self, losses: torch.Tensor) -> None:
        """Record the update's ``[G]`` losses at the cursor and advance
        it."""
        self.losses.index_copy_(0, self.cursor, losses[None])
        self.cursor.add_(1)

    def microbatch_losses(self, lo: int, hi: int) -> np.ndarray:
        """A copy of the losses of plan microbatches ``lo:hi`` (one device
        readback; the buffer is the next epoch's)."""
        return self.losses.reshape(-1)[lo:hi].cpu().numpy().copy()


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
