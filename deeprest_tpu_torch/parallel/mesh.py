"""The logical device mesh (``deeprest_tpu/parallel/mesh.py``) on
``torch.distributed``.

JAX lays one ``jax.sharding.Mesh`` with the axes ``(data, expert,
model)`` over every device of the job and lets GSPMD insert the
collectives.  The port runs one process (a rank) per device, so its
:class:`Mesh` is a small record of what a rank needs: the mesh's shape,
the rank and its coordinates, the rank's device, the job's process group
and one process group an axis.

Rank ``r`` sits at ``(d, e, m)`` in JAX's C order, ``r = (d·E + e)·M +
m`` (``np.asarray(devices).reshape(data, expert, model)``).  The data
group holds the ranks that share ``(e, m)``, the expert group those that
share ``(d, m)``, the model group those that share ``(d, e)``.  The
trainer gives each data coordinate its slice of the global batch and
all-reduces the gradients over the data group (train/trainer.py); the
partition-rule table (``parallel/sharding.py``) gives each rank its box of
every leaf, and the model runs the collectives GSPMD would have inserted
over the expert and model groups (``parallel/collectives.py``).

Elastic remeshing shrinks the mesh over the ranks that survive a loss
(:func:`shrink_mesh_config`: the data axis first, expert and model kept,
:class:`NoValidMeshError` when even ``data=1`` does not fit).  The
teardown before the smaller job forms (``parallel/distributed.py``) severs
every mesh :func:`make_mesh` built, and every module built on one, from
its process groups (:func:`sever_meshes`): a stale one then raises at its
first collective
instead of running one on a group of the old job, and the old groups'
connections close at once, so a peer blocked on one of them fails over
too.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Any

import torch
import torch.distributed as dist

from deeprest_tpu_torch.config import MeshConfig
from deeprest_tpu_torch.device import resolve_device

AXES = ("data", "expert", "model")
GROUP_FIELDS = ("group", "data_group", "expert_group", "model_group")


class NoValidMeshError(RuntimeError):
    """No mesh shape fits the surviving devices (elastic remeshing): the
    expert and model axes carry the parameter partitioning, so when
    ``expert * model`` devices no longer exist there is nothing to rebuild
    onto.  The trainer's fault barrier raises this typed error instead of
    respinning."""


def shrink_mesh_config(config: MeshConfig, healthy_count: int) -> MeshConfig:
    """The largest valid mesh on ``healthy_count`` devices: shrink the
    DATA axis first, keep expert and model.

    The new data extent is the largest **divisor** of the old one that
    fits, so a batch the old data axis divides stays divisible (8→4→2→1,
    never 8→7).  Raises :class:`NoValidMeshError` when even ``data=1``
    does not fit (fewer than ``expert * model`` healthy devices)."""
    if healthy_count < 1:
        raise NoValidMeshError(
            f"no healthy devices remain (mesh was "
            f"{config.data}x{config.expert}x{config.model})")
    em = config.expert * config.model
    if em > healthy_count:
        raise NoValidMeshError(
            f"only {healthy_count} healthy device(s) remain but the "
            f"expert*model plane needs {em} "
            f"({config.expert}x{config.model}); the expert/model axes "
            "carry the parameter partitioning and cannot shrink in-run")
    budget = healthy_count // em
    d = next(d for d in range(min(config.data, budget), 0, -1)
             if config.data % d == 0)
    return MeshConfig(data=d, expert=config.expert, model=config.model)


class _SeveredGroup:
    """Stands in for a process group a remesh tore down: any use raises."""

    def __getattr__(self, name):
        raise RuntimeError(
            "this mesh's process groups were torn down by an elastic "
            "remesh; use the trainer's rebuilt mesh")

    def __repr__(self) -> str:
        return "<severed process group>"


SEVERED = _SeveredGroup()
# what holds the current job's process groups (every mesh make_mesh built
# in a job, the modules built on them), until the next teardown
_HOLDERS: list[weakref.ref] = []


def hold_groups(holder) -> None:
    """Register ``holder``, whose :data:`GROUP_FIELDS` attributes hold
    process groups of the current job, with :func:`sever_meshes`."""
    _HOLDERS[:] = [ref for ref in _HOLDERS if ref() is not None]
    _HOLDERS.append(weakref.ref(holder))


def sever_meshes() -> None:
    """Replace every process group the registered holders keep (meshes
    :func:`make_mesh` built, the modules built on them) with
    :data:`SEVERED`: the remesh's teardown, after which nothing may reach
    the old job's groups, and nothing may keep them alive."""
    for ref in _HOLDERS:
        holder = ref()
        if holder is None:
            continue
        for name in GROUP_FIELDS:
            if getattr(holder, name, None) is not None:
                object.__setattr__(holder, name, SEVERED)
    _HOLDERS.clear()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its ``config`` (the shape), its
    ``rank`` in the job, the ``device`` it drives, the job's process
    ``group`` (a job of one rank included, or None without a job, where
    nothing is reduced) and the process group of each axis the rank's
    collectives run on: ``data_group`` (the job's group when the data axis
    spans it, so a job of one rank still all-reduces its gradients),
    ``expert_group`` and ``model_group`` (None for an axis of one rank).
    The stand-in for ``jax.sharding.Mesh``."""

    config: MeshConfig
    rank: int
    device: torch.device
    group: Any = None
    data_group: Any = None
    expert_group: Any = None
    model_group: Any = None

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.config.data, "expert": self.config.expert,
                "model": self.config.model}

    @property
    def size(self) -> int:
        return self.config.size

    @property
    def coords(self) -> dict[str, int]:
        """The rank's coordinates ``{"data": d, "expert": e, "model": m}``
        in JAX's C order."""
        return dict(zip(AXES, rank_coords(self.config, self.rank)))

    @property
    def backend(self) -> str | None:
        """The process group's backend ("nccl" or "gloo"), None without a
        group."""
        return None if self.group is None else dist.get_backend(self.group)


def mesh_config_of(mesh: Mesh) -> MeshConfig:
    """The :class:`MeshConfig` a live mesh was built from."""
    return MeshConfig(data=int(mesh.shape["data"]),
                      expert=int(mesh.shape["expert"]),
                      model=int(mesh.shape["model"]))


def rank_coords(config: MeshConfig, rank: int) -> tuple[int, int, int]:
    """``(d, e, m)`` of ``rank`` on a mesh of ``config``'s shape, with
    ``rank = (d·E + e)·M + m``."""
    em = config.expert * config.model
    return rank // em, (rank // config.model) % config.expert, \
        rank % config.model


def axis_ranks(config: MeshConfig, axis: str) -> list[list[int]]:
    """The ranks of every group of ``axis``: the ranks that share the
    other two coordinates, each list in coordinate order along ``axis``."""
    groups: dict[tuple, list[int]] = {}
    for r in range(config.size):
        d, e, m = rank_coords(config, r)
        key = {"data": (e, m), "expert": (d, m), "model": (d, e)}[axis]
        groups.setdefault(key, []).append(r)
    return [groups[k] for k in sorted(groups)]


def _axis_groups(config: MeshConfig, rank: int, world_group) -> dict:
    """This rank's process group of each axis: None without a job and
    for an expert or model axis of one rank (nothing to reduce); the job's
    group for an axis that spans the job (the data axis of a one-rank job
    included: its gradient all-reduce, the identity, stays in the update);
    else a new group.  ``dist.new_group`` is collective: every rank
    creates every group, in the same order."""
    out = {}
    for axis in AXES:
        extent = int(getattr(config, axis))
        if world_group is None or (extent == 1 and axis != "data"):
            out[axis] = None
        elif extent == config.size:
            out[axis] = world_group
        elif extent == 1:
            out[axis] = None
        else:
            mine = None
            for ranks in axis_ranks(config, axis):
                g = dist.new_group(ranks=ranks)
                if rank in ranks:
                    mine = g
            out[axis] = mine
    return out


def _job() -> tuple[int, int, Any]:
    """``(world size, rank, group)`` of the joined job; ``(1, 0, None)``
    when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def rank_device(device=None, local_rank: int | None = None) -> torch.device:
    """The device this rank drives: ``device`` (None means "cuda"); in a
    joined job (or given ``local_rank``) a CUDA device without an index
    takes the local rank's card (``LOCAL_RANK``, else the rank), modulo the
    cards there are: two ranks may share one card under gloo."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        _, rank, group = _job()
        if group is None:
            return dev
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def make_mesh(config: MeshConfig | None = None, device=None) -> Mesh:
    """This rank's (data, expert, model) mesh, with its axis groups.

    Defaults to every rank of the job on the data axis when no config is
    given; a 1x1x1 config is the one-process mesh, so the trainer runs one
    code path everywhere.  One rank drives one device, so the mesh must
    span the job: a config of another size raises.  In a job every rank
    must call this with the same config (the axis groups are made
    collectively)."""
    world, rank, group = _job()
    if config is None:
        config = MeshConfig(data=world)
    if config.size > world:
        raise ValueError(
            f"mesh {config.data}x{config.expert}x{config.model} needs "
            f"{config.size} devices, only {world} available"
        )
    if config.size < world:
        raise ValueError(
            f"mesh {config.data}x{config.expert}x{config.model} spans "
            f"{config.size} of the job's {world} ranks; one rank drives one "
            "device, so the mesh must span the world")
    groups = _axis_groups(config, rank, group)
    mesh = Mesh(config=config, rank=rank, device=rank_device(device),
                group=group, data_group=groups["data"],
                expert_group=groups["expert"], model_group=groups["model"])
    if group is not None:
        hold_groups(mesh)
    return mesh
