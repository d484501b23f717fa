"""Data parallelism on ``torch.distributed`` (counterpart of
``ldmseg_tpu/parallel/``): the process group (:mod:`.multihost`), the
``(data, model)`` mesh, batch sharding, gradient reduction and ZeRO-1
(:mod:`.mesh`), and a launcher of N local ranks (:mod:`.launch`). The JAX
package's ``sp.py`` and ``tp.py`` (a model axis) have no counterpart yet."""

from .mesh import (Mesh, global_mean, global_topk_mean, make_mesh,
                   prefetch_to_device, reduce_gradients, replicate,
                   shard_batch, zero1_partition)
from .multihost import (all_gather_host, broadcast_host, initialize_from_env,
                        is_main_process, world_size)

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
]
