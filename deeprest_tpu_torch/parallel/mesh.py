"""The logical device mesh (``deeprest_tpu/parallel/mesh.py``) on
``torch.distributed``.

JAX lays one ``jax.sharding.Mesh`` with the axes ``(data, expert,
model)`` over every device of the job and lets GSPMD insert the
collectives.  The port runs one process (a rank) per device, so its
:class:`Mesh` is a small record of what a rank needs: the mesh's shape,
the rank, the rank's device and the process group its collectives run on.
The data axis spans every rank of the job: the trainer gives each rank its
slice of the global batch and all-reduces the gradients
(train/trainer.py).  The expert and model axes wait for ROADMAP item 6b.
Elastic remeshing (``shrink_mesh_config``, ``NoValidMeshError``) waits
for item 6c.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from deeprest_tpu_torch.config import MeshConfig
from deeprest_tpu_torch.device import resolve_device

AXES = ("data", "expert", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the mesh: its ``config`` (the shape), the
    ``rank`` on the data axis, the ``device`` the rank drives and the
    process ``group`` of its collectives: the joined job's, a job of one
    rank included (its all-reduce is the identity), or None without a
    job, where nothing is reduced.  The stand-in for
    ``jax.sharding.Mesh``."""

    config: MeshConfig
    rank: int
    device: torch.device
    group: Any = None

    axis_names = AXES

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.config.data, "expert": self.config.expert,
                "model": self.config.model}

    @property
    def size(self) -> int:
        return self.config.size

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
    """This rank's (data, expert, model) mesh.

    Defaults to every rank of the job on the data axis when no config is
    given; a 1x1x1 config is the one-process mesh, so the trainer runs one
    code path everywhere.  One rank drives one device, so the mesh must
    span the job: a config of another size raises, as do expert or model
    axes above 1 (ROADMAP item 6b)."""
    world, rank, group = _job()
    if config is None:
        config = MeshConfig(data=world)
    if config.expert > 1 or config.model > 1:
        raise ValueError(
            f"mesh {config.data}x{config.expert}x{config.model}: the port "
            "runs the data axis only; the expert and model axes are "
            "ROADMAP item 6b")
    if config.size > world:
        raise ValueError(
            f"mesh {config.data}x{config.expert}x{config.model} needs "
            f"{config.size} devices, only {world} available"
        )
    if config.size < world:
        raise ValueError(
            f"mesh {config.data}x{config.expert}x{config.model} spans "
            f"{config.size} of the job's {world} ranks; one rank drives one "
            "device, so the data axis must equal the world size")
    return Mesh(config=config, rank=rank, device=rank_device(device),
                group=group)
