"""On-demand ``torch.profiler`` capture windows and the step-time breakdown
(``deeprest_tpu/obs/profiler.py``).

Two tools:

- :func:`capture`: a bounded ``torch.profiler`` window over the CPU and,
  when there is one, the GPU, one at a time (a second concurrent request
  gets :class:`ProfilerBusy`).  The serving plane mounts it at ``POST
  /v1/profile`` and ``python -m deeprest_tpu_torch profile`` drives it
  over the wire: the handler keeps serving traffic on the other threads
  while the window is open, so the trace shows the plane under its real
  load.  The window writes a Chrome trace (``chrome://tracing``,
  Perfetto) under ``out_dir``.  Opening the first window imports
  ``torch._dynamo`` (seconds, and far longer while request threads hold
  the GIL), so a server calls :func:`preload` before it serves.
- :func:`measure_step_breakdown`: where a train step's wall time goes:
  host feed (the numpy batch staged to the device), dispatch (the step
  call returning to Python) and device wait (the last dispatch edge to an
  updated-parameter readback completing).  Each timed phase closes with
  a ``torch.cuda.synchronize()`` (on a GPU) and a host readback, and the
  trial ledger asserts every phase did.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

_capture_lock = threading.Lock()


class ProfilerBusy(RuntimeError):
    """A capture window is already open (one at a time, by design)."""


def preload() -> None:
    """Import what a capture window needs (``torch.profiler`` pulls in
    ``torch._dynamo``) now, in the calling thread: a server calls it
    before it starts any thread, so the first window under load does not
    pay it.  (Not on a thread of its own: importing ``torch._dynamo``
    while another thread imports ``torch.export`` fails on a partly
    initialized module.)"""
    import torch._dynamo  # noqa: F401


def capture(out_dir: str, seconds: float,
            max_seconds: float = 120.0) -> dict:
    """Open a ``torch.profiler`` window for ``seconds`` (CPU activities,
    and CUDA ones when a GPU is present) and block until it closes.
    Returns ``{"trace_dir", "seconds", "trace", "all_threads"}``:
    ``trace`` is the Chrome trace file written under ``trace_dir``, and
    ``all_threads`` says whether every thread's host ops were recorded.

    Bounded (``max_seconds``) because the handler thread blocks for the
    window; concurrent captures fail fast with :class:`ProfilerBusy`
    instead of interleaving two traces.
    """
    seconds = float(seconds)
    if not (0 < seconds <= max_seconds):
        raise ValueError(
            f"capture seconds {seconds} must be in (0, {max_seconds}]")
    if not _capture_lock.acquire(blocking=False):
        raise ProfilerBusy("a profiler capture window is already open")
    try:
        import torch

        os.makedirs(out_dir, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # The window records the OTHER threads' ops (the handlers serving
        # the load), which torch.profiler skips unless told; a torch that
        # lacks the switch still records every device kernel.
        try:
            from torch._C._profiler import _ExperimentalConfig

            config = _ExperimentalConfig(profile_all_threads=True)
            all_threads = True
        except (ImportError, TypeError):
            config, all_threads = None, False
        with torch.profiler.profile(activities=activities,
                                    experimental_config=config) as prof:
            time.sleep(seconds)
        trace = os.path.join(os.path.abspath(out_dir),
                             f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(trace)
    finally:
        _capture_lock.release()
    return {"trace_dir": os.path.abspath(out_dir), "seconds": seconds,
            "trace": trace, "all_threads": all_threads}


def measure_step_breakdown(trainer, x, y, w, steps: int = 10,
                           warmup: int = 2) -> dict:
    """Per-step wall-time breakdown of ``trainer.train_step`` on batches
    fed from the host: ``x [B, W, F]``, ``y [B, W, E]`` and sample weights
    ``w [B]`` (numpy), staged as a base series whose B windows are the
    batch's rows.

    Phases, each closed by a synchronize and a host readback:

    - ``host_feed``: staging the numpy batch onto the device ``steps``
      times (a readback of the last staged buffer closes it).
    - ``dispatch``: the step calls returning to Python (the host's cost
      per step even when the device is the bottleneck).
    - ``device_wait``: from the last dispatch returning to the readback of
      an updated parameter element (device work not hidden behind
      dispatch).

    The trial ledger asserts every timed phase ended in a readback.
    """
    import torch

    device = trainer.device
    dtype = getattr(torch, trainer.model_config.compute_dtype)
    b, win = x.shape[0], x.shape[1]
    starts = np.arange(b, dtype=np.int64) * win
    ledger = {"started": 0, "synced": 0}

    def sync(tensor) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        v = float(tensor.reshape(-1)[0])
        if not np.isfinite(v):
            raise RuntimeError(f"non-finite readback in breakdown trial "
                               f"({v})")
        ledger["synced"] += 1

    def stage():
        xb = torch.from_numpy(np.ascontiguousarray(
            x.reshape(b * win, -1), np.float32)).to(device, dtype)
        yb = torch.from_numpy(np.ascontiguousarray(
            y.reshape(b * win, -1), np.float32)).to(device)
        return xb, yb

    state = trainer.init_state()
    param = next(iter(state.model.parameters()))
    staged = stage()
    for _ in range(max(1, warmup)):
        trainer.train_step(state, staged, starts, w)
    ledger["started"] += 1          # warmup closes with a readback too
    sync(param.detach())

    ledger["started"] += 1
    t0 = time.perf_counter()
    batches = [stage() for _ in range(steps)]
    sync(batches[-1][0])
    host_feed_s = time.perf_counter() - t0

    ledger["started"] += 1
    t1 = time.perf_counter()
    for batch in batches:
        trainer.train_step(state, batch, starts, w)
    t2 = time.perf_counter()        # all steps dispatched
    sync(param.detach())            # the trial's closing readback
    t3 = time.perf_counter()

    if not ledger["started"] == ledger["synced"] == 3:
        raise RuntimeError(f"breakdown trial without a readback: {ledger}")
    per = 1e3 / steps
    return {
        "steps": steps,
        "device": str(device),
        "host_feed_ms_per_step": round(host_feed_s * per, 4),
        "dispatch_ms_per_step": round((t2 - t1) * per, 4),
        "device_wait_ms_per_step": round((t3 - t2) * per, 4),
        "total_ms_per_step": round((host_feed_s + (t3 - t1)) * per, 4),
        "ledger": dict(ledger),
    }


__all__ = ["capture", "measure_step_breakdown", "ProfilerBusy"]
