"""Multi-process bring-up and the data axis's feeds
(``deeprest_tpu/parallel/distributed.py``) on ``torch.distributed``.

- Every process runs the same program and calls
  :func:`initialize_distributed` first: it joins the job its arguments or
  ``torchrun``'s ``env://`` variables describe, and is a no-op returning
  False when nothing is configured, so one code path serves one process
  and many.
- One rank drives one device.  Every rank draws the same global batch
  plan (the shuffle is seeded), keeps the :func:`process_batch_slice` of
  the batch axis its DATA coordinate names (:func:`feed_global_batch`,
  :func:`stage_plan`; the ranks of one data coordinate, which differ in
  their expert and model coordinates, hold the same rows) and holds the
  same replicated series (:func:`feed_replicated`,
  :func:`stage_sparse_base`).  The trainer all-reduces (SUM) the
  gradients over the data group once per update; :func:`gather_to_host`
  all-gathers over a group.
- JAX's ``prefetch_to_device`` has its counterpart in
  ``train/graphs.py::HostFeed``, the host-streamed feed's ring of pinned
  slots on a copy stream.
- The job keeps a handle on its store (:class:`Job`, :func:`current_job`),
  so the survivors of a loss can form a smaller job in the same processes
  (elastic remeshing, ``parallel/elastic.py``): :func:`teardown` destroys
  every process group of the current generation, :func:`census` agrees on
  the survivors through the store, and :func:`rejoin` renumbers each
  survivor to its index among them and joins a group of the new size with
  the same backend, under a per-generation prefix of the one store.  The
  store lives in the process of rank 0 of the first generation: when that
  rank is lost the store goes with it, and the survivors raise
  :class:`JobStoreLostError` instead of waiting.  Every group has a bounded
  timeout (:data:`JOB_TIMEOUT_S`), so a peer that hangs surfaces as an
  exception rather than as gloo's 30-minute default.
- :func:`agree` turns the ranks' local outcomes into one verdict and
  :func:`broadcast_json` hands rank 0's host value to every rank (a
  served mesh's checkpoint step and parity budget).
"""

from __future__ import annotations

import dataclasses
import datetime
import gc
import importlib
import json
import os
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from deeprest_tpu_torch.config import MeshConfig
from deeprest_tpu_torch.parallel.mesh import (
    AXES, Mesh, make_mesh, rank_device, sever_meshes,
)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
# The timeout of every process group of a job: a collective (or the
# rendezvous of a new group) whose peer is gone raises after this long.
# Long enough for rank 0's host work between collectives (the baselines
# the train command computes on rank 0 alone, a checkpoint's manifest).
JOB_TIMEOUT_S = 600.0


class JobStoreLostError(RuntimeError):
    """The job's store is unreachable: the rank that hosted it (rank 0 of
    the first generation) is gone, and with it the means to agree on the
    survivors, so the job cannot shrink in-process."""


@dataclasses.dataclass
class Job:
    """This process's view of its job: the ``store`` every generation
    rendezvouses on, the ``backend`` and group ``timeout``, this process's
    ``rank`` in the current generation, the generation's ``world`` size and
    its number (0 for the job as it started; each rejoin adds one)."""

    store: Any
    backend: str
    timeout: datetime.timedelta
    rank: int
    world: int
    generation: int = 0


_JOB: Job | None = None


def _generation_store(store, generation: int):
    return dist.PrefixStore(f"gen{generation}/", store)


def current_job() -> Job | None:
    """The joined job (None without one).  A job joined other than by
    :func:`initialize_distributed` is adopted on first use, with the
    default group's store."""
    global _JOB
    if _JOB is None and dist.is_available() and dist.is_initialized():
        from torch.distributed import distributed_c10d as c10d

        _JOB = Job(store=c10d._get_default_store(),
                   backend=dist.get_backend(),
                   timeout=datetime.timedelta(seconds=JOB_TIMEOUT_S),
                   rank=dist.get_rank(), world=dist.get_world_size())
    return _JOB


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           device=None) -> bool:
    """Join the multi-process job if one is configured; returns whether it
    was.

    Configuration comes from the arguments or the ``env://`` variables
    ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``).  With none of them this is a no-op
    returning False.  The backend is NCCL for a CUDA ``device`` (None
    means "cuda") and gloo for the CPU; ``backend`` overrides it (gloo
    takes CUDA tensors too, and lets two ranks share one card).  A CUDA
    rank's current device becomes its local rank's card.  Every group of
    the job times out after :data:`JOB_TIMEOUT_S`.  Joining an already
    joined job returns True."""
    env = os.environ
    if dist.is_initialized():
        return True
    if init_method is None and world_size is None and rank is None \
            and not any(env.get(k) for k in _ENV):
        return False
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(env.get("RANK", 0))
    init_method = init_method or "env://"
    dev = rank_device(device, int(env.get("LOCAL_RANK", rank)))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=JOB_TIMEOUT_S)
    # torch._dynamo's import keeps every process group alive at that moment
    # for good (the optimizer imports it): imported first, it holds none of
    # the job's, so a teardown frees them and closes their connections
    importlib.import_module("torch._dynamo")
    # the store first (rank 0 hosts it, or torchrun's agent), kept for the
    # rejoins of elastic remeshing; each generation's groups live under a
    # prefix of it
    store, rank, world_size = next(dist.rendezvous(
        init_method, rank=rank, world_size=world_size, timeout=timeout))
    dist.init_process_group(backend=backend,
                            store=_generation_store(store, 0),
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    global _JOB
    _JOB = Job(store=store, backend=backend, timeout=timeout, rank=rank,
               world=world_size)
    return True


def teardown() -> None:
    """Destroy every process group of the current generation (an NCCL
    one is aborted: a communicator whose peer died may not finish its
    collectives) and sever every mesh and module built on them
    (``parallel/mesh.py::sever_meshes``); a collection then frees the
    groups, whose connections close, so a peer blocked on one of them
    fails at once.  A no-op without a joined group."""
    sever_meshes()
    if dist.is_available() and dist.is_initialized():
        from torch.distributed import distributed_c10d as c10d

        abort = getattr(c10d, "_abort_process_group", None)
        if dist.get_backend() == "nccl" and abort is not None:
            abort()
        else:
            dist.destroy_process_group()
    gc.collect()


def _census_key(generation: int, what: str) -> str:
    return f"elastic/gen{generation}/{what}"


def census(alive: bool, wait_s: float) -> list[int]:
    """The ranks of the current generation that survive, agreed on
    through the job's store for the generation being formed.

    This rank checks in when ``alive``; the census closes when every rank
    has checked in or ``wait_s`` has passed.  The first rank to close it
    writes the list of those that checked in (compare-and-set on one key),
    and every rank returns that one list, so survivors that closed at
    different moments never form two jobs: a rank that checked in after
    the list was written is not on it.  A store that no longer answers
    raises :class:`JobStoreLostError`."""
    job = current_job()
    gen = job.generation + 1
    store = job.store
    try:
        if alive:
            store.set(_census_key(gen, f"alive/{job.rank}"), b"1")
            store.add(_census_key(gen, "count"), 1)
        deadline = time.monotonic() + wait_s
        while (store.add(_census_key(gen, "count"), 0) < job.world
               and time.monotonic() < deadline):
            time.sleep(0.01)
        seen = [r for r in range(job.world)
                if store.check([_census_key(gen, f"alive/{r}")])]
        agreed = store.compare_set(_census_key(gen, "survivors"), "",
                                   json.dumps(seen))
    except RuntimeError as exc:
        raise JobStoreLostError(
            f"the job's store stopped answering during the census of "
            f"generation {gen} ({type(exc).__name__}: {exc}); it lives in "
            "the process of rank 0 of the first generation, so a job that "
            "lost that rank cannot shrink in-process") from exc
    return [int(r) for r in json.loads(bytes(agreed).decode())]


def rejoin(survivors: list[int], generation: int) -> int:
    """Form generation ``generation`` of the job over ``survivors`` (ranks
    of the current generation, ascending): tear down the current groups if
    that has not happened, renumber this rank to its index in
    ``survivors`` and join a group of ``len(survivors)`` ranks with the
    same backend and timeout.  Returns the new rank; a rank not among the
    survivors raises ``ValueError``."""
    job = current_job()
    if job is None:
        raise RuntimeError("rejoin: no job was joined")
    if job.rank not in survivors:
        raise ValueError(f"rejoin: rank {job.rank} is not among the "
                         f"survivors {survivors}")
    teardown()
    rank = list(survivors).index(job.rank)
    try:
        dist.init_process_group(
            backend=job.backend,
            store=_generation_store(job.store, generation),
            world_size=len(survivors), rank=rank, timeout=job.timeout)
    except (dist.DistNetworkError, dist.DistStoreError) as exc:
        raise JobStoreLostError(
            f"the job's store stopped answering while generation "
            f"{generation} formed ({exc})") from exc
    job.rank, job.world, job.generation = rank, len(survivors), generation
    return rank


def leave_job() -> None:
    """Leave the job: destroy the current generation's groups (if this
    rank is still in one) and forget the job."""
    global _JOB
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _JOB = None


def global_mesh(config: MeshConfig | None = None, device=None) -> Mesh:
    """The (data, expert, model) mesh over the job: :func:`make_mesh`
    (the default config puts every rank on the data axis)."""
    return make_mesh(config, device=device)


def process_batch_slice(global_batch: int,
                        process_index: int | None = None,
                        process_count: int | None = None) -> slice:
    """This process's contiguous slice of the global batch axis.

    The global batch must divide evenly: a ragged split would give the
    ranks different static shapes."""
    joined = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if joined else 0
    if process_count is None:
        process_count = dist.get_world_size() if joined else 1
    if global_batch % process_count != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def data_slice(mesh: Mesh, arr: np.ndarray, ax: int) -> np.ndarray:
    """This rank's rows of ``arr``'s axis ``ax`` (the data-sharded one);
    an axis the data axis does not divide raises with the fix."""
    n = int(arr.shape[ax])
    data_size = int(mesh.shape["data"])
    if n % data_size != 0:
        raise ValueError(
            f"batch axis {ax} of shape {tuple(arr.shape)} has {n} rows, "
            f"not divisible by the mesh data axis ({data_size} shards); "
            "pad the batch to a multiple with zero-weight rows (the "
            "trainer's _batches wrap-padding) or pick a batch size "
            "divisible by MeshConfig.data")
    sel = (slice(None),) * ax + (process_batch_slice(
        n, mesh.coords["data"], data_size),)
    return np.ascontiguousarray(arr[sel])


def _on_device(mesh: Mesh, arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def feed_global_batch(mesh: Mesh, global_batch: np.ndarray,
                      axes: tuple[str | None, ...] | None = None
                      ) -> torch.Tensor:
    """This rank's slice of the host-side GLOBAL batch, on its device.

    Every rank passes the same ``global_batch`` (the seeded selection
    keeps them equal) and keeps its :func:`process_batch_slice` of the
    ``data`` axis (the leading one by default)."""
    global_batch = np.asarray(global_batch)
    if axes is None:
        axes = ("data",) + (None,) * (global_batch.ndim - 1)
    return _on_device(mesh, data_slice(mesh, global_batch,
                                       axes.index("data")))


def feed_replicated(mesh: Mesh, arr: np.ndarray) -> torch.Tensor:
    """The same array on every rank's device (evaluation and prediction
    inputs: every rank holds the same windows)."""
    return _on_device(mesh, np.asarray(arr))


def feed_global_coo(mesh: Mesh, cols: np.ndarray, vals: np.ndarray,
                    axes: tuple[str | None, ...] | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded-COO twin of :func:`feed_global_batch`: a sparse
    ``(cols[..., K], vals[..., K])`` window batch, both halves sliced on
    the same rows."""
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if cols.shape != vals.shape:
        raise ValueError(
            f"padded-COO halves disagree: cols {cols.shape} vs "
            f"vals {vals.shape}")
    return (feed_global_batch(mesh, cols, axes),
            feed_global_batch(mesh, vals, axes))


def stage_sparse_base(mesh: Mesh, cols: np.ndarray, vals: np.ndarray,
                      mn: np.ndarray, rg: np.ndarray, capacity: int):
    """A padded-COO base series and its normalization stats on every
    rank's device (``ops.densify.SparseBase``); each step's feed is then
    just start indices."""
    from deeprest_tpu_torch.ops.densify import SparseBase

    return SparseBase(
        cols=feed_replicated(mesh, np.asarray(cols, np.int32)),
        vals=feed_replicated(mesh, np.asarray(vals, np.float32)),
        mn=feed_replicated(mesh, np.asarray(mn, np.float32)),
        rg=feed_replicated(mesh, np.asarray(rg, np.float32)),
        capacity=int(capacity))


def stage_plan(mesh: Mesh, starts: np.ndarray, weights: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An epoch's ``[C, S, B]`` batch plan cut for this rank: its slice of
    the TRAILING (batch) axis of ``starts`` and ``weights``, and the
    global batch's weight sums ``[C, S]`` (the pinball loss's
    denominator: a rank sees only its own weights, and the zero-weight
    rows that pad a ragged batch all land on the last ranks).  Host
    arrays; the trainer's ``EpochPlan`` stages them in one copy each."""
    starts = np.asarray(starts)
    weights = np.asarray(weights, np.float32)
    ax = starts.ndim - 1
    return (data_slice(mesh, starts, ax), data_slice(mesh, weights, ax),
            weights.sum(axis=-1, dtype=np.float32))


def gather_to_host(mesh: Mesh, tensor: torch.Tensor,
                   axis: str | None = None, dim: int = 0) -> np.ndarray:
    """Every rank's ``tensor`` concatenated along ``dim``, as numpy on
    every rank: over the job (``axis`` None) or over one axis's group
    (``"data"``, ``"expert"``, ``"model"``), in rank order; the tensor
    itself without a group."""
    from deeprest_tpu_torch.parallel.collectives import gather_along

    group = mesh.group if axis is None else getattr(mesh, f"{axis}_group")
    with torch.no_grad():
        return gather_along(tensor, dim, group).detach().cpu().numpy()


def host_wire_device(mesh: Mesh) -> torch.device:
    """Where a host value crosses the job's group: the rank's device under
    NCCL, the CPU under gloo."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def agree(mesh: Mesh, ok: bool) -> bool:
    """Whether ``ok`` holds on every rank of the mesh's job (a MIN
    all-reduce); ``ok`` itself without a group.  Every rank must call it:
    the ranks' local outcomes (a checkpoint read, a reload) become one
    verdict before any rank goes on to a collective that needs them all."""
    if mesh.group is None:
        return bool(ok)
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32,
                        device=host_wire_device(mesh))
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def broadcast_json(mesh: Mesh, obj: Any = None) -> Any:
    """Rank 0's ``obj`` (JSON-serializable) on every rank of the mesh's
    job: its UTF-8 length, then its bytes.  ``obj`` itself without a
    group.  Every rank must call it; only rank 0's ``obj`` is read."""
    if mesh.group is None:
        return obj
    dev = host_wire_device(mesh)
    blob = (json.dumps(obj, sort_keys=True).encode()
            if mesh.rank == 0 else b"")
    size = torch.tensor([len(blob)], dtype=torch.int64, device=dev)
    dist.broadcast(size, 0, group=mesh.group)
    data = (torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
            if mesh.rank == 0 else
            torch.empty(int(size.item()), dtype=torch.uint8, device=dev))
    if data.numel():
        dist.broadcast(data, 0, group=mesh.group)
    return json.loads(bytes(data.cpu().numpy()).decode())


__all__ = [
    "AXES",
    "JOB_TIMEOUT_S",
    "Job",
    "JobStoreLostError",
    "current_job",
    "census",
    "rejoin",
    "teardown",
    "leave_job",
    "initialize_distributed",
    "global_mesh",
    "process_batch_slice",
    "feed_global_batch",
    "feed_global_coo",
    "feed_replicated",
    "stage_sparse_base",
    "stage_plan",
    "gather_to_host",
    "host_wire_device",
    "agree",
    "broadcast_json",
]
