"""The mesh's data axis on ``torch.distributed`` (``deeprest_tpu/parallel``):
one rank a device, each rank's slice of the global batch, the gradients
all-reduced.  The expert and model axes (``sharding.py``) are ROADMAP item
6b; elastic remeshing (``elastic.py``) is item 6c."""

from deeprest_tpu_torch.parallel.distributed import (
    feed_global_batch,
    feed_global_coo,
    feed_replicated,
    gather_to_host,
    global_mesh,
    initialize_distributed,
    process_batch_slice,
    stage_plan,
    stage_sparse_base,
)
from deeprest_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    make_mesh,
    mesh_config_of,
)

__all__ = [
    "AXES",
    "Mesh",
    "make_mesh",
    "mesh_config_of",
    "feed_global_batch",
    "feed_global_coo",
    "feed_replicated",
    "gather_to_host",
    "global_mesh",
    "initialize_distributed",
    "process_batch_slice",
    "stage_plan",
    "stage_sparse_base",
]
