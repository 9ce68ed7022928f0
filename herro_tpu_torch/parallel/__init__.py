"""Multi-device and multi-host inference: the device mesh and the
multi-process runtime (``mesh``), Megatron tensor parallelism (``tensor``)."""

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
from .tensor import TensorParallelModel, all_reduce, make_tp_correct_step, shard_weights

__all__ = [
    "Mesh",
    "TensorParallelModel",
    "all_reduce",
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
