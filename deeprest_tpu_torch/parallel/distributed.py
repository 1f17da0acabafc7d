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
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from deeprest_tpu_torch.config import MeshConfig
from deeprest_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh, rank_device

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


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
    rank's current device becomes its local rank's card.  Joining an
    already joined job returns True."""
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
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


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


__all__ = [
    "AXES",
    "initialize_distributed",
    "global_mesh",
    "process_batch_slice",
    "feed_global_batch",
    "feed_global_coo",
    "feed_replicated",
    "stage_sparse_base",
    "stage_plan",
    "gather_to_host",
]
