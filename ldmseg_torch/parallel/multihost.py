"""Process-group set-up (counterpart of ``ldmseg_tpu/parallel/multihost.py``).

The reference launches one process per GPU (``mp.spawn`` in
``tools/main_ldm.py:70``, SLURM's variables in ``main_ldm_slurm.py:52-58``,
an ``env://`` or ``tcp://`` NCCL rendezvous). The port does the same with
``torch.distributed``: each rank is one process bound to one device, and
:func:`initialize_from_env` wires the group from explicit arguments,
torchrun's variables or SLURM's. ``torchrun --nproc_per_node=N -m
ldmseg_torch.tools.main_ldm ...`` thus trains on N GPUs; a plain ``python
-m ...`` stays one process without a group.

JAX's TPU-pod detection (``TPU_WORKER_HOSTNAMES``) has no counterpart: no
GPU cluster announces itself that way.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Any, List, Optional

import torch
import torch.distributed as dist

DEFAULT_PORT = 29500
DEFAULT_TIMEOUT_S = 300.0


def first_slurm_host(nodelist: str) -> str:
    """The first host of a SLURM node list (``node[03-05,9],gpu1`` ->
    ``node03``)."""
    m = re.match(r"([^,\[]+)(?:\[([^\]]+)\])?", nodelist.strip())
    if m is None or not m.group(1):
        raise ValueError(f"SLURM_NODELIST {nodelist!r}: no host")
    prefix, ranges = m.group(1), m.group(2)
    if ranges is None:
        return prefix
    return prefix + ranges.split(",")[0].split("-")[0]


def cluster_from_env(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     environ=None) -> Optional[dict]:
    """The rendezvous that the arguments or the environment describe, or
    None when nothing describes one: ``{"init_method", "world_size",
    "rank", "local_rank"}``. Explicit arguments come first
    (``coordinator_address`` ``host:port``, ``tcp://...``, ``env://`` or
    ``file://...``), then torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
    ``MASTER_ADDR``/``MASTER_PORT``, then SLURM's ``SLURM_NTASKS`` (above
    1)/``SLURM_PROCID``/``SLURM_LOCALID``/``SLURM_NODELIST`` (the address
    from ``MASTER_ADDR`` and ``MASTER_PORT`` where set, else the list's first
    host and port 29500)."""
    env = os.environ if environ is None else environ
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        return {"init_method": addr, "world_size": int(num_processes),
                "rank": int(process_id),
                "local_rank": int(env.get("LOCAL_RANK", 0)
                                  if local_rank is None else local_rank)}
    if "RANK" in env and "WORLD_SIZE" in env:
        host = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", str(DEFAULT_PORT))
        return {"init_method": f"tcp://{host}:{port}",
                "world_size": int(env["WORLD_SIZE"]),
                "rank": int(env["RANK"]),
                "local_rank": int(env.get("LOCAL_RANK", 0)
                                  if local_rank is None else local_rank)}
    if int(env.get("SLURM_NTASKS", "1")) > 1:
        host = env.get("MASTER_ADDR") or first_slurm_host(
            env["SLURM_NODELIST"])
        port = env.get("MASTER_PORT", str(DEFAULT_PORT))
        return {"init_method": f"tcp://{host}:{port}",
                "world_size": int(env["SLURM_NTASKS"]),
                "rank": int(env["SLURM_PROCID"]),
                "local_rank": int(env.get("SLURM_LOCALID", 0)
                                  if local_rank is None else local_rank)}
    return None


def initialize_from_env(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        device: str = "cuda",
                        backend: Optional[str] = None,
                        local_rank: Optional[int] = None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the process group that :func:`cluster_from_env` finds, once:
    a no-op when a group is up or nothing describes one. ``device`` is the
    ranks' device type: ``"cuda"`` binds each rank to ``cuda:local_rank``
    (``LOCAL_RANK``) and takes NCCL, ``"cpu"`` takes gloo; ``backend``
    overrides the choice (gloo over CUDA tensors serves ranks that share
    one card, which NCCL refuses). The rendezvous waits at most
    ``timeout_s`` seconds, and so does each collective, then raises.

    Returns ``{"process_id", "process_count", "local_devices",
    "global_devices", "device"}`` (one device a rank, so the global count is
    the world size; ``device`` the rank's, as given in one process)."""
    device = torch.device(device)
    if not dist.is_initialized():
        found = cluster_from_env(coordinator_address, num_processes,
                                 process_id, local_rank)
        if found is not None:
            if device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "initialize_from_env: device 'cuda' asked for but "
                        "torch.cuda.is_available() is False")
                if found["local_rank"] >= torch.cuda.device_count():
                    raise RuntimeError(
                        f"local rank {found['local_rank']} has no GPU: "
                        f"{torch.cuda.device_count()} visible")
                torch.cuda.set_device(found["local_rank"])
            dist.init_process_group(
                backend or ("nccl" if device.type == "cuda" else "gloo"),
                init_method=found["init_method"],
                world_size=found["world_size"], rank=found["rank"],
                timeout=datetime.timedelta(seconds=timeout_s))
    n = world_size()
    if dist.is_initialized() and device.type == "cuda" and \
            device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return {"process_id": process_index(), "process_count": n,
            "local_devices": 1, "global_devices": n, "device": str(device)}


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or the only process (the reference's ``is_main_process``,
    ``ldmseg/utils/utils.py:52-81``)."""
    return process_index() == 0


def all_gather_host(values: Any, group=None) -> List[Any]:
    """Every rank's ``values`` (any picklable object), in rank order (the
    detectron2 ``comm.gather`` of the reference's eval records,
    ``panoptic_evaluation.py:97-100``); ``[values]`` in one process."""
    if not dist.is_initialized():
        return [values]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, values, group=group)
    return out


def broadcast_host(value: Any, src: int = 0, group=None) -> Any:
    """Rank ``src``'s ``value`` on every rank; ``value`` in one process."""
    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
