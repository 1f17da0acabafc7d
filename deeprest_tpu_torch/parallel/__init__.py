"""The device mesh on ``torch.distributed`` (``deeprest_tpu/parallel``):
one rank a device on a ``data×expert×model`` mesh, each data coordinate
its slice of the global batch, each rank its box of every leaf by the
partition-rule table, and the collectives GSPMD would insert written out
as autograd operators, and elastic remeshing (``elastic.py``): the fault
barrier's loss detection, the census of the surviving ranks and the
smaller job they form in-process."""

from deeprest_tpu_torch.parallel.collectives import (
    copy_replicated,
    gather_along,
    max_replicated,
    reduce_replicated,
    sum_partials,
)
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
from deeprest_tpu_torch.parallel.elastic import (
    DeviceLossError,
    FaultInjector,
    RemeshExhaustedError,
    enumerate_healthy,
    is_device_loss,
)
from deeprest_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    NoValidMeshError,
    make_mesh,
    mesh_config_of,
    shrink_mesh_config,
)
from deeprest_tpu_torch.parallel.sharding import (
    PARTITION_RULES,
    match_partition_rules,
    param_specs,
    rank_box,
    shard_params,
    state_specs,
)

__all__ = [
    "AXES",
    "Mesh",
    "make_mesh",
    "mesh_config_of",
    "shrink_mesh_config",
    "NoValidMeshError",
    "DeviceLossError",
    "FaultInjector",
    "RemeshExhaustedError",
    "enumerate_healthy",
    "is_device_loss",
    "PARTITION_RULES",
    "match_partition_rules",
    "param_specs",
    "rank_box",
    "shard_params",
    "state_specs",
    "copy_replicated",
    "gather_along",
    "max_replicated",
    "reduce_replicated",
    "sum_partials",
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
