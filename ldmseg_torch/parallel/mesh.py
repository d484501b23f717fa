"""The ``(data, model)`` mesh over the process group, and data parallelism
with ZeRO-1 (counterpart of ``ldmseg_tpu/parallel/mesh.py``).

The reference's only parallelism is DDP with optional ZeRO-1 optimizer
state sharding (SURVEY §2: torch DDP ``tools/main_ldm.py:189-193``,
``ZeroRedundancyOptimizer`` ``ldmseg/trainers/optim.py:102-126``). On a JAX
mesh GSPMD derives it from shardings; here each rank is one process:

  * DDP     -> each data rank loads its rows of the global batch
               (:func:`shard_batch`, ``data/loader.py:make_loader``);
               :func:`reduce_gradients` averages ``.grad`` over the data
               group once per optimizer step, in flat buckets in a fixed
               order.
  * losses  -> a loss whose normaliser is a count over the batch (the
               CE's valid points, the mask count, the warp's valid pixels,
               OHEM's top-k) divides each rank's sum by the global count
               (:func:`global_mean`, :func:`global_topk_mean`), so that the
               mean of the ranks' gradients is the global batch's, as JAX
               computes it on a mesh.
  * ZeRO-1  -> each parameter's optimizer state lives on one data rank
               (:func:`zero1_partition`, whole parameters, greedy by size as
               ``ZeroRedundancyOptimizer`` assigns them); the owners step
               their parameters and broadcast them (``train/optim.py``).

A ``model`` axis is laid out beside ``data`` (rank = data index x model
size + model index, JAX's ``reshape(num_data, num_model)``); no layer uses
it yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# elements of a flat bucket: 128 MiB of fp32
BUCKET_NUMEL = 1 << 25


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks; this rank's indices and the groups it
    reduces over (None: one process, no collective)."""
    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def loss_group(self):
        """The group a global-batch loss reduces its counts over: the data
        group when it holds more than one rank, else None (the one-rank
        loss, bit for bit)."""
        return self.data_group if self.data > 1 else None

    def local_batch(self, batch_size: int) -> int:
        """This data rank's rows of a global batch of ``batch_size``."""
        if batch_size % self.data:
            raise ValueError(f"global batch {batch_size} does not split "
                             f"over {self.data} data ranks")
        return batch_size // self.data


def check_mesh_device(mesh, device: torch.device, who: str) -> None:
    """A rank's tensors must live where its group's collectives run: a
    NCCL group needs the card, a CPU device needs gloo."""
    if mesh.data_group is None:
        return
    backend = dist.get_backend(mesh.data_group)
    if device.type == "cpu" and backend == "nccl":
        raise RuntimeError(f"{who}: device cpu in a NCCL process group; "
                           "initialise the group with device='cpu' (gloo)")


def group_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the mesh's data ranks (``x`` in one
    process)."""
    if mesh.data_group is None or mesh.data == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.data_group)
    return x / mesh.data


def rank_seed(seed: int, mesh) -> int:
    """The draws' seed of this data rank: ``seed`` itself in one process,
    else one derived from ``(seed, data rank)``."""
    if mesh.data == 1:
        return seed
    return int(np.random.SeedSequence([seed, mesh.data_rank])
               .generate_state(1)[0])


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """The mesh over the initialised process group (``num_data`` defaults
    to the world size over ``num_model``; the two must multiply to the world
    size), or the trivial mesh in one process. Every rank must call it: the
    subgroups are made collectively (``dist.new_group``)."""
    if not dist.is_initialized():
        if (num_data or 1) * num_model != 1:
            raise ValueError(f"a {num_data} x {num_model} mesh needs an "
                             "initialised process group of that many ranks")
        return Mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data} x {num_model} over a world of "
                         f"{world} ranks")
    d, m = divmod(rank, num_model)
    if num_model == 1:
        return Mesh(num_data, 1, d, 0, dist.group.WORLD, None)
    data_group = model_group = None
    for mi in range(num_model):
        g = dist.new_group([di * num_model + mi for di in range(num_data)])
        if mi == m:
            data_group = g
    for di in range(num_data):
        g = dist.new_group([di * num_model + mi for mi in range(num_model)])
        if di == d:
            model_group = g
    return Mesh(num_data, num_model, d, m, data_group, model_group)


def _rows(x, mesh: Mesh, key: str):
    n = len(x)
    if n % mesh.data:
        raise ValueError(f"{key}: leading size {n} does not split over "
                         f"{mesh.data} data ranks")
    per = n // mesh.data
    return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]


def shard_batch(mesh: Mesh, batch):
    """This data rank's rows of a global host batch: arrays, tensors and
    lists (a batch's ``meta``) cut on their leading axis, which ``data``
    must divide (as ``NamedSharding`` refuses); other values pass. A dict is
    cut value by value."""
    def cut(x, key):
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1 \
                or isinstance(x, list):
            return _rows(x, mesh, key)
        return x
    if isinstance(batch, dict):
        return {k: cut(v, k) for k, v in batch.items()}
    return cut(batch, "batch")


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for x in tree for t in _tensors(x)]


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int,
                      group) -> None:
    """Rank ``src``'s (a global rank) values into ``tensors`` on every rank
    of ``group``, in flat buckets of one dtype and device."""
    run: List[torch.Tensor] = []
    numel = 0

    def flush():
        nonlocal numel
        if not run:
            return
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.broadcast(flat, src=src, group=group)
        off = 0
        for t in run:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        run.clear()
        numel = 0

    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or numel + t.numel() > BUCKET_NUMEL):
            flush()
        run.append(t)
        numel += t.numel()
    flush()


def replicate(mesh: Mesh, tree):
    """The data group's first rank's values of every tensor of ``tree`` (a
    module's parameters and buffers, a tensor, or a dict or list of them)
    on every data rank, in place; returns ``tree``. A no-op in one
    process."""
    if mesh.data_group is not None and mesh.data > 1:
        broadcast_tensors(_tensors(tree),
                          dist.get_global_rank(mesh.data_group, 0),
                          mesh.data_group)
    return tree


def prefetch_to_device(iterator: Iterable[dict], mesh: Mesh, device,
                       size: int = 2) -> Iterator[dict]:
    """Each global host batch cut to this rank's rows (:func:`shard_batch`),
    then the port's pinned double-buffered H2D
    (``data/loader.py:prefetch_to_device``)."""
    from ..data.loader import prefetch_to_device as h2d
    return h2d((shard_batch(mesh, b) for b in iterator), device, size)


def zero1_partition(params: Sequence[torch.Tensor], n: int) -> List[int]:
    """The data rank that owns each parameter's optimizer state: whole
    parameters, the largest first, each to the rank holding the fewest
    bytes so far (``ZeroRedundancyOptimizer``'s rule), so the largest rank
    holds at most one parameter more than the mean. JAX slices each state
    leaf on an axis instead; the update is the same, as AdamW is
    elementwise, and whole parameters keep Adafactor's factored moments
    exact without a collective."""
    sizes = [p.numel() * p.element_size() for p in params]
    load = [0] * n
    owner = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(n), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += sizes[i]
    return owner


@torch.no_grad()
def reduce_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Average every parameter's ``.grad`` over ``group``: one SUM
    all-reduce per flat bucket (one dtype, at most :data:`BUCKET_NUMEL`
    elements, the parameters' order), then a division by the group's size.
    A parameter with a gradient on any rank gets one on every rank (zeros
    where it had none); one without a gradient anywhere keeps none, as in
    one process."""
    if group is None or not params:
        return
    n = dist.get_world_size(group)
    have = torch.tensor([p.grad is not None for p in params],
                        dtype=torch.int32, device=params[0].device)
    dist.all_reduce(have, group=group)
    for p, h in zip(params, have.tolist()):
        if h and p.grad is None:
            p.grad = torch.zeros_like(p)
    run: List[torch.Tensor] = []
    numel = 0

    def flush():
        nonlocal numel
        if not run:
            return
        flat = torch.cat([g.reshape(-1) for g in run])
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        off = 0
        for g in run:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        run.clear()
        numel = 0

    for p in params:
        g = p.grad
        if g is None:
            continue
        if run and (g.dtype != run[0].dtype
                    or numel + g.numel() > BUCKET_NUMEL):
            flush()
        run.append(g)
        numel += g.numel()
    flush()


def _all_reduce_detached(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


def global_mean(local_sum: torch.Tensor, local_count: torch.Tensor,
                group=None) -> torch.Tensor:
    """``sum(local_sum) / max(sum(local_count), 1)`` over the group's ranks,
    as this rank's share ``size * local_sum / max(total, 1)``: the mean of
    the ranks' shares, and of their gradients, is the global value (the
    count is all-reduced detached). Without a group: ``local_sum /
    max(local_count, 1)``."""
    if group is None:
        return local_sum / local_count.clamp_min(1.0)
    total = _all_reduce_detached(local_count, group)
    return local_sum * dist.get_world_size(group) / total.clamp_min(1.0)


def global_topk_mean(flat: torch.Tensor, ratio: float,
                     group=None) -> torch.Tensor:
    """OHEM over the global batch: the mean of the ``int(ratio * N)``
    largest of the ranks' ``flat`` losses together (N their total count;
    every rank holds as many), as this rank's share (see
    :func:`global_mean`). Each rank's detached top-k is summed into a
    ``[size, k]`` table (an all-reduce, which every backend has); the
    global k-th value is the threshold; values above it are taken, and the
    ties at it rank by rank, each rank's in its flat order, as ``top_k``
    takes the lower index first. Without a group: ``topk(flat).mean()``."""
    if group is None:
        return torch.topk(flat, int(ratio * flat.numel())).values.mean()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    k = int(ratio * flat.numel() * n)
    k_loc = min(k, flat.numel())
    table = flat.new_zeros((n, k_loc))
    table[r] = torch.topk(flat.detach(), k_loc).values
    dist.all_reduce(table, group=group)
    kth = torch.topk(table.reshape(-1), k).values[-1]
    above = (table > kth).sum(1)
    ties = (table == kth).sum(1)
    wanted = k - above.sum()
    before = torch.cumsum(ties, 0) - ties
    mine = (wanted - before[r]).clamp(0, None).minimum(ties[r])
    eq = flat.detach() == kth
    take = (flat.detach() > kth) | (eq & (torch.cumsum(eq.int(), 0) <= mine))
    return (flat * take).sum() * n / k
