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

# The JAX package's names with no counterpart of that name on
# torch.distributed, by the port's object (under deeprest_tpu_torch) that
# does their job: the four build a ``NamedSharding`` (a placement GSPMD
# reads), where a rank here holds its box of every leaf or batch, and the
# host-to-device prefetch is the trainer's pinned ring.  Reading one raises
# AttributeError naming its counterpart.
JAX_COUNTERPARTS = {
    "state_sharding": "parallel.state_specs",
    "param_sharding": "parallel.param_specs",
    "batch_sharding": "parallel.process_batch_slice",
    "shard_batch": "parallel.feed_global_batch",
    "prefetch_to_device": "train.graphs.HostFeed",
}

# The public members of the JAX package's classes that are JAX's or flax's
# own and have no member of that name on the port's class, by
# "subpackage.Class.member", each with the object (under
# deeprest_tpu_torch, or torch's own) that does its job.
JAX_MEMBER_COUNTERPARTS = {
    # init_state takes params or a seed: a flax init's sample input is
    # not needed to make the params' shapes
    "train.Trainer.sample_input": "train.Trainer.init_state",
    # the port's TrainState is mutable: its step is assigned and its
    # params are written in place through its module
    "train.TrainState.replace": "models.QuantileGRU.load_params",
    # the optax state: Adam over the module's parameters
    "train.TrainState.opt_state": "train.TrainState.optimizer",
    # JAX's fold_in(rng, step): each step's dropout stream from the seed
    "train.TrainState.rng": "train.trainer.dropout_generator",
    # flax Module internals: a torch module's name is its key among its
    # parent's children, and its variables are its registered parameters
    "models.QuantileGRU.name": "torch.nn.Module.named_children",
    "models.QuantileGRU.parent": "torch.nn.Module.named_children",
    "models.QuantileGRU.scope": "torch.nn.Module.named_parameters",
}


def __getattr__(name: str):
    if name in JAX_COUNTERPARTS:
        raise AttributeError(
            f"{__name__}.{name} is the JAX package's; on torch.distributed "
            f"its counterpart is deeprest_tpu_torch."
            f"{JAX_COUNTERPARTS[name]}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
