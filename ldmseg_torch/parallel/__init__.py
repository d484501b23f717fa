"""Parallelism on ``torch.distributed`` (counterpart of
``ldmseg_tpu/parallel/``): the process group (:mod:`.multihost`), the
``(data, model)`` mesh, batch sharding, gradient reduction and ZeRO-1
(:mod:`.mesh`), tensor parallelism of the UNet (:mod:`.tp`) and spatial
parallelism of the VAEs (:mod:`.sp`) over the model axis, and a launcher of
N local ranks (:mod:`.launch`)."""

from .mesh import (Mesh, global_mean, global_topk_mean, make_mesh,
                   prefetch_to_device, reduce_gradients, replicate,
                   shard_batch, zero1_partition)
from .multihost import (all_gather_host, broadcast_host, initialize_from_env,
                        is_main_process, world_size)
from .sp import batch_constraint, has_spatial_axis, spatial_constraint
from .tp import apply_tp, tp_param_sharding

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_batch",
    "replicate",
    "zero1_partition",
    "prefetch_to_device",
    "reduce_gradients",
    "global_mean",
    "global_topk_mean",
    "initialize_from_env",
    "is_main_process",
    "world_size",
    "all_gather_host",
    "broadcast_host",
    "tp_param_sharding",
    "apply_tp",
    "spatial_constraint",
    "batch_constraint",
    "has_spatial_axis",
]
