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
  :class:`CapturedUpdate`.  The caller runs the update eagerly first (the
  run's real first update, which builds the kernels and the optimizer's
  state), keeps the gradients allocated (they live in the graph's pool
  across replays), builds Adam with ``capturable=True`` and registers its
  dropout generator.  A failed capture raises :class:`GraphCaptureError`
  naming the source line of the failing op; it never falls back to the
  eager loop.
- The launch ledger: a kernel wrapper counts its launch on the host when it
  is called, which under capture is once, not once per replay.  So a
  capture records how many launches of each kernel the graph holds, takes
  them back off the counts, and :meth:`CapturedUpdate.replay` adds them
  per replay.
"""

from __future__ import annotations

import os
import traceback
from typing import Callable, Iterable

import numpy as np
import torch


class GraphCaptureError(RuntimeError):
    """The capture of an optimizer update failed."""


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


class CapturedUpdate:
    """A captured optimizer update and the kernel launches it holds."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: dict):
        self.graph = graph
        self.launches = launches        # kernel -> launches per replay

    def replay(self) -> None:
        self.graph.replay()
        for kernel, count in self.launches.items():
            kernel.launches += count


def _failing_op(exc: BaseException) -> str:
    """``file:line (function: source)`` of the innermost frame of the
    port's code in ``exc``'s traceback (of any frame if none is the
    port's)."""
    frames = traceback.extract_tb(exc.__traceback__)
    ours = [f for f in frames if "deeprest_tpu_torch" in f.filename]
    frame = (ours or frames)[-1] if frames else None
    if frame is None:
        return "an unknown op"
    return (f"{os.path.basename(frame.filename)}:{frame.lineno} "
            f"({frame.name}: {(frame.line or '').strip()})")


def capture_update(body: Callable[[], None], device: torch.device,
                   kernels: Iterable,
                   generators: Iterable[torch.Generator] = ()
                   ) -> CapturedUpdate:
    """Capture ``body`` (one optimizer update, already run eagerly once)
    into a CUDA graph on a side stream of ``device``.  ``generators`` are
    registered with the graph, so a replay draws from each one's offset
    at replay time and advances it as an eager call would.  ``kernels``
    are the counted kernel wrappers whose launches the ledger moves from
    capture to replay.  Raises :class:`GraphCaptureError` if the capture
    fails."""
    kernels = list(kernels)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = {k: k.launches for k in kernels}
    torch.cuda.synchronize(device)
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    failed = None
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                body()
            except Exception as exc:  # reported below, after the capture ends
                failed = exc
            finally:
                try:
                    graph.capture_end()
                except Exception as exc:
                    failed = failed or exc
    finally:
        held = {k: k.launches - before[k] for k in kernels}
        for k in kernels:
            k.launches = before[k]
    torch.cuda.current_stream(device).wait_stream(stream)
    if failed is not None:
        raise GraphCaptureError(
            f"CUDA-graph capture of one optimizer update failed at "
            f"{_failing_op(failed)}: {type(failed).__name__}: {failed}"
        ) from failed
    return CapturedUpdate(graph, {k: n for k, n in held.items() if n})
