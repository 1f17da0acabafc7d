"""Elastic remeshing primitives on ``torch.distributed``
(``deeprest_tpu/parallel/elastic.py``): the DETECT leg of the trainer's
fault barrier.

JAX runs one controller over many devices, so a lost device is an entry
dropped from a list.  The port runs one process (a rank) a device, so a
lost device is a dead or failed peer process, and the survivors must
notice the loss through a failed collective, agree on who is left, tear
down their process groups and join a smaller job
(``parallel/distributed.py``: :func:`~deeprest_tpu_torch.parallel.
distributed.census`, ``teardown``, ``rejoin``), then rebuild everything
derived from the mesh (``Trainer.remesh``).

- :class:`DeviceLossError`: the typed synthetic loss the deterministic
  :class:`FaultInjector` raises at step K, so the whole
  detect→rebuild→restore→resume path runs without a device to lose.
  Every rank holds the same injector and raises after the same dispatch;
  the ranks its tail drop removes are the lost ones, which leave ``fit``
  with this error and never join the new job.
- :func:`is_device_loss`: the exception family the barrier owns.
  Conservative, as JAX's: a gloo or NCCL error whose message says a peer
  is gone, a network error between ranks, or a CUDA error that means the
  device itself is lost.  A shape error, an out-of-memory error, the
  recurrence planner's ``ValueError`` or a kernel build failure is not:
  a remesh would only replay it.
- :func:`enumerate_healthy`: the counterpart of JAX's device probe.  Each
  rank probes its own device (one scalar copy to it and a synchronize),
  then checks in on the job's store under the generation being formed;
  the survivors are the ranks that checked in within
  :data:`CENSUS_WAIT_S`, in rank order, one value every survivor reads
  from the store.

The REBUILD leg (shrink the data axis first, keep expert and model) is
:func:`parallel.mesh.shrink_mesh_config`; the RESTORE leg is the
per-shard restore onto any mesh (``train/checkpoint.py``); the barrier
composing them is ``Trainer._run_epochs_elastic``.
"""

from __future__ import annotations

import re
from typing import Mapping, Sequence

import torch
import torch.distributed as dist

from deeprest_tpu_torch.parallel.distributed import (
    JobStoreLostError, census, current_job,
)

__all__ = [
    "CENSUS_WAIT_S",
    "DeviceLossError",
    "RemeshExhaustedError",
    "FaultInjector",
    "is_device_loss",
    "enumerate_healthy",
]

# How long a survivor waits for the other ranks of its generation to check
# in before the census is taken.  A rank that detects the loss late (it
# was busy on the host, or blocked on a survivor that has since torn its
# groups down) must still make it: the teardown closes every connection a
# blocked peer waits on, so all survivors arrive within a fraction of a
# second of one another.  With every rank checked in the census closes at
# once; a dead rank costs the whole wait.
CENSUS_WAIT_S = 5.0


class DeviceLossError(RuntimeError):
    """Synthetic device loss (the :class:`FaultInjector`'s signal), and the
    error a rank the loss removed leaves ``fit`` with.

    ``lost`` is how many devices the event takes down."""

    def __init__(self, message: str, lost: int = 1):
        super().__init__(message)
        self.lost = int(lost)


class RemeshExhaustedError(RuntimeError):
    """Device losses outran ``TrainConfig.remesh_max_attempts``: the
    bounded barrier surfaces the last loss instead of respinning."""


# A peer that is gone, as gloo, NCCL and the c10d store word it, and a CUDA
# device that is itself lost.  Deliberately narrow: every other runtime
# error (a bad shape, an out-of-memory, a failed kernel build) would loop
# through restore and retry until the attempt budget ran out.
_DEVICE_LOSS_RE = re.compile(
    r"(?i)(connection\s+(reset|closed)\s+by\s+peer|broken\s+pipe"
    r"|timed\s+out\s+waiting\s+\d+\s*ms\s+for\s+(recv|send)"
    r"|remote\s+process\s+exited|ncclRemoteError"
    r"|communicator\s+(was\s+)?aborted"
    r"|watchdog\s+caught\s+collective\s+operation\s+timeout"
    r"|uncorrectable\s+ECC|fallen\s+off\s+the\s+bus"
    r"|device\(s\)\s+is/are\s+busy\s+or\s+unavailable|device\s+unavailable"
    r"|cudaErrorDevicesUnavailable|cudaErrorECCUncorrectable)")


def is_device_loss(exc: BaseException) -> bool:
    """Is this exception the device-loss family the fault barrier owns?

    True for :class:`DeviceLossError`, for ``torch.distributed``'s
    ``DistNetworkError`` (the connection between ranks failed), and for a
    ``DistBackendError`` or gloo/NCCL/CUDA ``RuntimeError`` whose message
    says a peer is gone (a closed or reset connection, a remote process
    that exited, an aborted communicator, a collective's timeout) or that
    the device is lost (an uncorrectable ECC error, a card fallen off the
    bus, a device unavailable).  False for everything else, an
    out-of-memory error and the job store's loss included."""
    if isinstance(exc, DeviceLossError):
        return True
    if isinstance(exc, (torch.OutOfMemoryError, JobStoreLostError)):
        return False
    if isinstance(exc, dist.DistNetworkError):
        return True
    if isinstance(exc, RuntimeError):
        return bool(_DEVICE_LOSS_RE.search(str(exc)))
    return False


def probe_device(device) -> bool:
    """Whether ``device`` still takes work: one scalar copy to it and, on
    a GPU, a synchronize."""
    device = torch.device(device)
    try:
        torch.zeros((), dtype=torch.int32).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except Exception:
        # the probe failing IS the verdict this function exists to give
        return False
    return True


def enumerate_healthy(device) -> list[int]:
    """The ranks of the job's current generation that still take work, in
    rank order.

    This rank probes its own ``device`` (:func:`probe_device`) and, if it
    answers, checks in on the job's store; the census closes when every
    rank has checked in or :data:`CENSUS_WAIT_S` has passed, and the first
    survivor
    to close it writes the list every survivor then reads
    (``parallel.distributed.census``), so two survivors never see two
    lists.  Without a job: ``[0]`` when the device answers, else ``[]``.
    """
    alive = probe_device(device)
    if current_job() is None:
        return [0] if alive else []
    return census(alive, CENSUS_WAIT_S)


class FaultInjector:
    """Deterministic synthetic device loss at global step K.

    ``lose_at`` maps GLOBAL train-step numbers to how many devices that
    event takes down (dropped from the TAIL of the current rank list, so
    the surviving prefix keeps its coordinates, as a fresh job on the
    shrunk mesh would lay them).  The trainer calls :meth:`note_steps`
    after every train dispatch, BEFORE any bookkeeping: a superstep whose
    chunk covers a scheduled step fails as a whole, and the barrier
    restores the newest durable snapshot.

    Each event fires exactly once (keyed by global step), so the replay
    of the same steps after the restore does not raise it again."""

    def __init__(self, lose_at: Mapping[int, int]):
        self._lose_at = {int(k): int(v) for k, v in dict(lose_at).items()}
        for step, n in self._lose_at.items():
            if step < 1 or n < 1:
                raise ValueError(
                    f"FaultInjector lose_at[{step}]={n}: steps and "
                    "device counts must be >= 1")
        # devices lost by events not yet consumed by healthy()
        self._pending_lost = 0
        self.events: list[tuple[int, int]] = []

    def note_steps(self, global_step_before: int, n: int) -> None:
        """A dispatch just covered global steps (before, before+n]."""
        lo, hi = int(global_step_before), int(global_step_before) + int(n)
        hit = sorted(s for s in self._lose_at if lo < s <= hi)
        if not hit:
            return
        lost = sum(self._lose_at.pop(s) for s in hit)
        self._pending_lost += lost
        self.events.append((hit[0], lost))
        raise DeviceLossError(
            f"synthetic device loss at step {hit[0]}: {lost} device(s) "
            f"dropped (dispatch covered steps {lo + 1}..{hi})", lost=lost)

    def healthy(self, devices: Sequence) -> list:
        """The surviving subset of ``devices`` (ranks, in the port) after
        the pending loss events, tail-dropped, order kept; consuming
        resets the pending count so sequential losses compose."""
        lost, self._pending_lost = self._pending_lost, 0
        keep = max(0, len(devices) - lost)
        return list(devices)[:keep]
