"""The capture of one CUDA graph and its kernel-launch ledger, shared by
the trainer's optimizer update (``train/graphs.py``) and the serving
plane's rung programs (``serve/graphs.py``).

- :func:`capture` records a body into a CUDA graph on a side stream.  A
  failed capture raises :class:`GraphCaptureError` naming the source line
  of the failing op; no caller falls back to eager.
- Every capture uses ``capture_error_mode="thread_local"`` and waits for
  the current stream only, never the whole device: a serving thread may be
  launching or replaying on another stream while a hot reload captures,
  and that must neither break the capture nor stall it.
- Python's cyclic garbage collector is off while a graph captures: a
  collection there could free an unrelated object's pinned host or device
  memory (a fleet tenant's spilled weights, say), and the allocator's
  event calls on this thread would invalidate the capture (CUDA error
  901 at the next launch).
- The launch ledger: a kernel wrapper called on a stream that captures
  (inside ``ops.cuda_gru.held_launches``) launches nothing, so its call is
  tallied instead of counted; the tally is the graph's ledger, and
  :meth:`CapturedGraph.replay` adds it per replay.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import traceback
from typing import Any, Callable, Iterable

import torch

from deeprest_tpu_torch.ops.cuda_gru import LAUNCH_LOCK, held_launches


class GraphCaptureError(RuntimeError):
    """The capture of a CUDA graph failed."""


class CapturedGraph:
    """A captured CUDA graph and the kernel launches it holds."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: dict):
        self.graph = graph
        self.launches = launches        # kernel -> launches per replay

    def replay(self) -> None:
        self.graph.replay()
        with LAUNCH_LOCK:
            for kernel, count in self.launches.items():
                kernel.launches += count


def _failing_op(exc: BaseException) -> str:
    """``file:line (function: source)`` of the innermost frame of the
    port's code in ``exc``'s traceback, this module's own frames (the
    capture around the body) left out; of any frame if none is the
    port's."""
    frames = traceback.extract_tb(exc.__traceback__)
    here = os.path.abspath(__file__)
    ours = [f for f in frames if "deeprest_tpu_torch" in f.filename
            and os.path.abspath(f.filename) != here]
    frame = (ours or frames)[-1] if frames else None
    if frame is None:
        return "an unknown op"
    return (f"{os.path.basename(frame.filename)}:{frame.lineno} "
            f"({frame.name}: {(frame.line or '').strip()})")


_PAUSE_LOCK = threading.Lock()
_paused = [0, False]            # captures under way, collector was on


@contextlib.contextmanager
def _collector_paused():
    """The cyclic garbage collector off for the block (and for every
    capture overlapping it, from any thread); on again after the last."""
    with _PAUSE_LOCK:
        if _paused[0] == 0:
            _paused[1] = gc.isenabled()
            gc.disable()
        _paused[0] += 1
    try:
        yield
    finally:
        with _PAUSE_LOCK:
            _paused[0] -= 1
            if _paused[0] == 0 and _paused[1]:
                gc.enable()


def capture(body: Callable[[], Any], device: torch.device, what: str,
            generators: Iterable[torch.Generator] = (),
            pool=None, stream: torch.cuda.Stream | None = None
            ) -> tuple[CapturedGraph, Any]:
    """Capture ``body`` into a CUDA graph on ``stream`` (a new side stream
    of ``device`` when None), in memory ``pool`` (the graph's own when
    None); returns the :class:`CapturedGraph` and what ``body`` returned.
    ``generators`` are registered with the graph, so a replay draws from
    each one's offset at replay time.  Raises :class:`GraphCaptureError`,
    naming ``what`` and the source line of the failing op."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    current = torch.cuda.current_stream(device)
    current.synchronize()
    if stream is None:
        stream = torch.cuda.Stream(device=device)
    stream.wait_stream(current)
    failed = result = None
    with _collector_paused(), held_launches(stream) as held, \
            torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            result = body()
        except Exception as exc:  # reported below, after the capture ends
            failed = exc
        finally:
            try:
                graph.capture_end()
            except Exception as exc:
                failed = failed or exc
    current.wait_stream(stream)
    if failed is not None:
        raise GraphCaptureError(
            f"CUDA-graph capture of {what} failed at "
            f"{_failing_op(failed)}: {type(failed).__name__}: {failed}"
        ) from failed
    return CapturedGraph(graph, dict(held)), result
