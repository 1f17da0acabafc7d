"""One captured CUDA graph per serving rung, and the pinned host buffers
that feed and drain them.

The JAX plane promises "zero compiles after warmup": its jit caches hold
one executable per ladder rung (``deeprest_tpu/serve/predictor.py``,
``jit_cache_size``).  The port's counterpart is :class:`RungGraphs`: one
CUDA graph per ``(program, rung)`` key (the shape ladder's model apply,
and the fused engine's page program for each ``integrate`` flag in use),
each with static input buffers, captured after one eager call on a side
stream and replayed for every later batch of that rung.

- Captures happen when a key is first run.  ``Predictor.warm`` runs every
  key once, so a server that warms before it listens (and a hot reload
  that warms the fresh predictor before the swap) captures nothing while
  serving; :meth:`RungGraphs.stats` counts ``captures_after_warmup``.
- A failed capture raises ``GraphCaptureError``; there is no eager
  fallback.  Captures go through ``deeprest_tpu_torch/graphs.py``, in
  ``thread_local`` error mode, so request threads launching on other
  streams do not break a reload's capture.
- A graph's inputs and outputs are static buffers, so a replay overwrites
  the last one's.  :attr:`RungGraphs.lock` is held from the staging copy
  until the caller has copied the outputs out (a device clone, or a copy
  into a pinned host buffer that is enqueued before the next replay).
  All graphs of one ``RungGraphs`` share one memory pool, which is safe
  because their replays are serialized by that lock and every output is
  copied out before another graph runs.
- The launch ledger: a capture tallies the kernel launches it records
  (K1, ``gru_fwd``) and each replay adds them, so ``GRU_FWD.launches``
  counts what ran.
- On the CPU, or with graphs off (``enabled=False``, the eager engine the
  chip check holds the graphs against), a run calls the program eagerly
  on device copies of its inputs; ``stats()`` then counts the keys
  dispatched.
- A predictor on a mesh runs the mesh's collectives inside each program
  (the model's over the expert and model groups, the answer's all-gather
  over the expert group): under NCCL they are captured with the rung;
  gloo's cannot be, so such a predictor is built with graphs off
  (``Predictor`` raises otherwise), and every rank replays or runs the
  same rungs in the same order.
- The fleet tier (serve/fleet.py): a graph reads the tensors its program
  closed over at capture, so tenants share one plane's graphs through a
  :class:`BoundSlot`, the plane's own weights and stats.  ``run(...,
  owner=tenant)`` first copies the tenant's tensors into the slot unless
  it already holds them, under :attr:`RungGraphs.lock` and on the stream
  the replay runs on; every serving program goes through ``run``, so no
  path can skip the bind.  The CPU path runs the plane's program on the
  slot the same way.

:class:`PinnedStaging` double-buffers the host side of a batch in pinned
memory: two slots used in turn, each refilled only after the event
recorded behind its last ``non_blocking`` copy has passed.  :class:`PinnedReadback` reads device
results back through one growable pinned buffer (both the ladder's
``materialize`` and the fused engine's pages).
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from deeprest_tpu_torch.graphs import CapturedGraph, capture
from deeprest_tpu_torch.obs import metrics as obs_metrics

Key = tuple[str, int]


class _Graph:
    __slots__ = ("captured", "inputs", "outputs")

    def __init__(self, captured: CapturedGraph, inputs, outputs):
        self.captured = captured      # the graph and its launch ledger
        self.inputs = inputs
        self.outputs = outputs


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class BoundSlot:
    """The tensors a shared plane's programs read: the plane's own weights
    and stats, at the addresses its graphs were captured against, and the
    tenant whose values they hold.

    ``tensors`` maps the names of ``bound_state()`` (serve/predictor.py) to
    the plane's tensors; ``plane`` is the predictor they belong to, which
    serves no tenant (a run of its own binds nothing)."""

    def __init__(self, tensors: dict, plane):
        self.tensors = dict(tensors)
        self.plane = plane
        self.owner = plane
        self.binds = 0
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in self.tensors.values())

    def bind(self, owner) -> None:
        """Copy ``owner.bound_state()`` into the slot unless the slot holds
        it already.  The caller holds the graphs' lock and is on the stream
        its replay runs on, so the copies land before the replay reads
        them; a spilled owner's pinned host tensors copy in the same way."""
        if owner is self.owner or owner is self.plane:
            return
        state = owner.bound_state()
        for name, dst in self.tensors.items():
            dst.copy_(state[name], non_blocking=True)
        self.owner = owner
        self.binds += 1


class RungGraphs:
    """The captured graphs of one predictor, keyed by ``(program, rung)``.

    :meth:`run` is the only entry: it runs ``fn(*args)`` as ``key``'s
    program and returns its outputs, which stay valid until the next run;
    the caller holds :attr:`lock` across the run and the copy-out.
    """

    def __init__(self, device, enabled: bool = True):
        self.device = torch.device(device)
        self.captured = bool(enabled) and self.device.type == "cuda"
        self.lock = threading.RLock()
        self._graphs: dict[Key, _Graph] = {}
        self._dispatched: set[Key] = set()
        self._captures = 0
        self._replays = 0
        self._after_warmup = 0
        self._warm = False
        self._pool = None
        self._stream = None
        self._eager_s = 0.0
        self._capture_s = 0.0
        self.slot: BoundSlot | None = None      # set when tenants share

    def run(self, key: Key, fn: Callable, args: tuple, staged=None,
            owner=None) -> tuple:
        """``fn(*args)`` as ``key``'s program.  ``args`` are host (pinned)
        or device tensors; they are copied into the graph's static inputs
        with ``non_blocking=True``, then ``staged.record()`` (when given)
        marks the point after which the host buffers may be refilled.
        With a :attr:`slot`, ``owner``'s weights and stats are bound into
        it first."""
        with self.lock:
            if self.slot is not None and owner is not None:
                self.slot.bind(owner)
            self._dispatched.add(key)
            if not self.captured:
                dev = tuple(a.to(self.device, non_blocking=True)
                            for a in args)
                if staged is not None:
                    staged.record()
                return _as_tuple(fn(*dev))
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._capture_locked(key, fn, args)
            for dst, src in zip(entry.inputs, args):
                dst.copy_(src, non_blocking=True)
            if staged is not None:
                staged.record()
            entry.captured.replay()
            self._replays += 1
            return entry.outputs

    def _capture_locked(self, key: Key, fn: Callable,
                        args: tuple) -> _Graph:
        """Capture ``key``'s graph; the caller (:meth:`run`) holds
        :attr:`lock`."""
        inputs = tuple(torch.empty_like(a, device=self.device) for a in args)
        for dst, src in zip(inputs, args):
            dst.copy_(src, non_blocking=True)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        sw = obs_metrics.Stopwatch()
        with torch.cuda.stream(self._stream):
            fn(*inputs)          # eager: loads the kernels, warms the GEMMs
        self._stream.synchronize()
        eager_s = sw.elapsed()
        sw.restart()
        current.wait_stream(self._stream)
        graph, outputs = capture(
            lambda: fn(*inputs), self.device,
            f"serving program {key[0]} at rung {key[1]}", pool=self._pool,
            stream=self._stream)
        self._eager_s += eager_s
        self._capture_s += sw.elapsed()
        if self._pool is None:
            self._pool = graph.graph.pool()
        entry = _Graph(graph, inputs, _as_tuple(outputs))
        self._graphs[key] = entry
        self._captures += 1
        if self._warm:
            self._after_warmup += 1
        return entry

    def mark_warm(self) -> None:
        """Every later capture counts in ``captures_after_warmup``."""
        with self.lock:
            self._warm = True

    def size(self, program: str = "") -> int:
        """Captured graphs whose program starts with ``program`` (on the
        CPU, or with graphs off: keys dispatched)."""
        with self.lock:
            keys = self._graphs if self.captured else self._dispatched
            return sum(1 for p, _ in keys if p.startswith(program))

    def stats(self) -> dict:
        with self.lock:
            return {"captured": self.captured,
                    "captures": self._captures, "replays": self._replays,
                    "rungs": [f"{p}:{r}" for p, r in sorted(self._dispatched)],
                    "captures_after_warmup": self._after_warmup,
                    "seconds": {"eager": self._eager_s,
                                "capture": self._capture_s}}


class _Slot:
    """One set of host buffers of :class:`PinnedStaging`."""

    def __init__(self, buffers: dict, cuda: bool):
        self.buffers = buffers
        self._cuda = cuda
        self._event = None

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.buffers[name]

    def record(self) -> None:
        """Mark the copies enqueued so far out of this slot."""
        if self._cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()
            self._event = None


class PinnedStaging:
    """Two sets of named host buffers (pinned on CUDA) used in turn,
    allocated at the first :meth:`take`, which returns the next slot once
    the copies recorded out of it have landed.  Not thread-safe: callers
    hold their engine's lock."""

    def __init__(self, device, specs: dict):
        self._cuda = torch.device(device).type == "cuda"
        self._specs = dict(specs)
        self._slots = None             # allocated at the first take()
        self._next = 0

    def take(self) -> _Slot:
        if self._slots is None:
            self._slots = [
                _Slot({name: torch.zeros(shape, dtype=dtype,
                                         pin_memory=self._cuda)
                       for name, (shape, dtype) in self._specs.items()},
                      self._cuda)
                for _ in range(2)]
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        slot.wait()
        return slot


class PinnedReadback:
    """Device→host reads through one growable host buffer per dtype,
    pinned on CUDA.  :attr:`lock` guards the buffers."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self.lock = threading.Lock()
        self._buffers: dict[torch.dtype, torch.Tensor] = {}

    def buffer(self, shape: tuple, dtype=torch.float32) -> torch.Tensor:
        """A host tensor of ``shape`` over the buffer (grown as needed);
        the caller holds :attr:`lock` until it has read it."""
        numel = int(np.prod(shape))
        buf = self._buffers.get(dtype)
        if buf is None or buf.numel() < numel:
            with torch.inference_mode(False):     # in-place use in and out
                buf = torch.empty((numel,), dtype=dtype,
                                  pin_memory=self._cuda)
            self._buffers[dtype] = buf
        return buf[:numel].view(shape)

    def landed(self) -> None:
        """Wait for the device→host copies enqueued on the current
        stream."""
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
            event.synchronize()

    def rows(self, parts) -> np.ndarray:
        """``[(tensor [R, ...], n), ...]`` → the first ``n`` rows of each,
        concatenated, as a fresh numpy array."""
        first = parts[0][0]
        with self.lock:
            total = sum(n for _, n in parts)
            host = self.buffer((total, *first.shape[1:]), first.dtype)
            lo = 0
            for y, n in parts:
                host[lo:lo + n].copy_(y[:n], non_blocking=True)
                lo += n
            self.landed()
            return host.numpy().copy()
