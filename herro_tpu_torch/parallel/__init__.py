"""Multi-device and multi-host inference and multi-device training: the
device mesh and the multi-process runtime (``mesh``), Megatron tensor
parallelism (``tensor``), and a train step over a mesh with sharded
inference against one device (``dryrun``, run as a module)."""

from .mesh import (
    Mesh,
    init_distributed,
    local_devices,
    make_mesh,
    make_mesh_2d,
    process_count,
    process_index,
    shutdown_distributed,
)
from .tensor import (
    TensorParallelModel,
    all_reduce,
    all_reduce_max,
    gather_weights,
    make_tp_correct_step,
    shard_weights,
)

__all__ = [
    "Mesh",
    "TensorParallelModel",
    "all_reduce",
    "all_reduce_max",
    "gather_weights",
    "init_distributed",
    "local_devices",
    "make_mesh",
    "make_mesh_2d",
    "make_tp_correct_step",
    "process_count",
    "process_index",
    "shard_weights",
    "shutdown_distributed",
]
