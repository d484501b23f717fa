"""Tensor parallelism (TP) of the UNet over the mesh's ``model`` axis
(counterpart of ``ldmseg_tpu/parallel/tp.py``).

JAX assigns each parameter a sharding and GSPMD inserts the collectives.
:func:`tp_spec_for` applies JAX's rules verbatim to the port's names and
layouts (the port names hold JAX's markers, but for GEGLU's ``ff.net.2``,
JAX's ``ff/proj_out``):

  * conv kernels ``[kh, kw, cin, cout]`` shard ``cout`` (torch dim 0);
  * Dense kernels ``[cin, cout]`` shard ``cout`` (torch dim 0), except
    ``to_out`` and ``proj_out``, row-parallel on ``cin`` (torch dim 1);
  * the biases of column-parallel layers shard dim 0;
  * a path with ``norm``, ``ln``, ``time_embedding`` or ``codebook`` is
    replicated, and so is a dimension the axis does not divide.

Here each model rank is a process: :func:`apply_tp` cuts a whole UNet into
this rank's shards in place and gives each sharded layer its collectives,
autograd functions on ``all_reduce`` (a gather is an all-reduce of a
zero-filled buffer, ``parallel/sp.py:all_gather``):

  * a column-parallel layer runs on its input as it is, whose gradient is
    summed over the ranks (:func:`copy_to`: identity, all-reduce
    backward), and its output's channels are gathered
    (:func:`gather_from`: all-gather, this rank's slice of the gradient
    backward) wherever the next layer reads every channel: the UNet's
    convolutions, ``time_emb_proj`` and Transformer2D's ``proj_in``; so
    every ``GroupNorm`` and ``LayerNorm`` sees whole activations and its
    parameters stay replicated;
  * ``to_q``/``to_k``/``to_v`` keep their output local: K1 (K2 backward)
    attends over this rank's ``heads / n`` heads, and the row-parallel
    ``to_out`` sums the ranks' partial products (:func:`reduce_from`:
    all-reduce, identity backward) before its bias, added once; where the
    axis does not divide the heads (JAX then splits a head), q, k and v
    are gathered, K1 attends over all the heads and ``to_out`` takes this
    rank's channels of its input (:func:`scatter_to`);
  * GEGLU's ``proj`` (JAX's one Dense of ``2 * inner``) holds this rank's
    ``h`` rows and its ``gate`` rows side by side (``pairs`` 2), so that
    each rank computes its slice of the gated product locally; ``ff.net.2``
    is row-parallel on it;
  * Transformer2D's 1x1 ``proj_out`` is row-parallel on a replicated
    input: this rank's channels are taken (:func:`scatter_to`: slice,
    all-gather backward).

The replicated parameters (norms, the time embedding) receive the same
gradient on every model rank; the trainer averages them over the group all
the same. A checkpoint holds the one-rank layout (:func:`full_tensors`,
:func:`local_tensor`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .sp import Axis, all_gather, model_axis

ROW_PARALLEL_MARKERS = ("to_out", "proj_out")
REPLICATED_MARKERS = ("norm", "ln", "time_embedding", "codebook")

def tp_spec_for(name: str, shape: Sequence[int], n: int) -> Optional[int]:
    """The torch dim of a UNet parameter that JAX's ``tp_spec_for`` shards
    over a model axis of ``n`` (``ldmseg_tpu/parallel/tp.py:38-57``), or
    None where it is replicated. ``shape`` is the torch shape: conv
    ``[cout, cin, kh, kw]``, linear ``[out, in]``; a ``weight`` of either
    is JAX's ``kernel``."""
    s = name.replace("ff.net.2.", "ff.proj_out.").lower()
    if any(m in s for m in REPLICATED_MARKERS) or not shape:
        return None
    row = any(m in s for m in ROW_PARALLEL_MARKERS)
    if s.endswith(".weight") and len(shape) in (2, 4):
        cout, cin = shape[0], shape[1]
        if row and cin % n == 0:
            return 1
        if cout % n == 0:
            return 0
    elif s.endswith("bias") and len(shape) == 1 and not row:
        if shape[0] % n == 0:
            return 0
    return None


# ---------------------------------------------------------------------------
# the model group's collectives, each with its backward
# ---------------------------------------------------------------------------
def _reduce(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the group, added in fp32 and rounded once."""
    out = x.float() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(out, group=ax.group)
    return out.to(x.dtype)


def _slice(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.rank * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.ax, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _slice(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.ax, ctx.dim), None, None


def copy_to(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Identity; the gradient summed over the model group."""
    return _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum over the model group; the gradient passes."""
    return _ReduceFrom.apply(x, ax)


def gather_from(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim``; this rank's slice of the
    gradient."""
    return _GatherFrom.apply(x, ax, dim)


def scatter_to(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` on ``dim``; the gradient's slices
    gathered."""
    return _ScatterTo.apply(x, ax, dim)


# ---------------------------------------------------------------------------
# the sharded layers (apply_tp gives a layer one of these classes; its
# parameters keep their names)
# ---------------------------------------------------------------------------
class ColumnConv2d(nn.Conv2d):
    """This rank's output channels; gathered."""
    tp: Axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(copy_to(x, self.tp))
        return gather_from(y, self.tp, 1)


class RowConv2d(nn.Conv2d):
    """This rank's input channels of a replicated input; the partial
    products summed, then the bias."""
    tp: Axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(scatter_to(x, self.tp, 1), self.weight, None,
                     self.stride, self.padding)
        y = reduce_from(y, self.tp)
        return y if self.bias is None else \
            y + self.bias.to(y.dtype)[:, None, None]


class ColumnLinear(nn.Linear):
    """This rank's output features, gathered where ``gather``."""
    tp: Axis
    gather: bool = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(copy_to(x, self.tp))
        return gather_from(y, self.tp, -1) if self.gather else y


class RowLinear(nn.Linear):
    """This rank's input features: of a local input (the slice that a
    column-parallel layer without a gather made), or taken from a
    replicated one where ``scatter``; the partial products summed, then
    the bias."""
    tp: Axis
    scatter: bool = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.scatter:
            x = scatter_to(x, self.tp, -1)
        y = reduce_from(F.linear(x, self.weight), self.tp)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def local_tensor(full: torch.Tensor, dim: int, ax: Axis,
                 pairs: int = 1) -> torch.Tensor:
    """This rank's shard of a whole tensor: cut on ``dim`` (with ``pairs``
    2, each half cut alike and the rank's two pieces side by side)."""
    return torch.cat([h.chunk(ax.size, dim)[ax.rank]
                      for h in full.chunk(pairs, dim)], dim).contiguous()


def whole_tensor(shards: Sequence[torch.Tensor], dim: int,
                 pairs: int = 1) -> torch.Tensor:
    """The inverse of :func:`local_tensor` on every rank's shard."""
    halves = [s.chunk(pairs, dim) for s in shards]
    return torch.cat([h[k] for k in range(pairs) for h in halves], dim)


# the attribute on a TP UNet: {parameter name: (torch dim, pairs)}
LAYOUT = "_tp_layout"


def layout(module: nn.Module) -> Dict[str, Tuple[int, int]]:
    """The sharded parameters of a TP module (empty for any other)."""
    return getattr(module, LAYOUT, {})


_REFUSED = ("use_cross_attention", "encoder_hid_dim", "num_object_queries",
            "separate_conv", "separate_encoder", "add_adaptor",
            "upscaler_classes", "use_packed_attention",
            "use_absorbed_attention", "use_padded_attention",
            "use_fused_projs", "use_int8_conv", "use_int8_attention",
            "use_int8_ff", "use_fused_norms", "int8_fuse_gn")


def apply_tp(mesh, unet: nn.Module) -> nn.Module:
    """Cut ``unet`` (a whole :class:`~..models.unet.UNet2DCondition`, the
    same weights on every model rank) into this model rank's shards in
    place by :func:`tp_spec_for`, and give its layers their collectives.
    Without a model axis nothing changes. A UNet option that the model axis
    does not take raises ``NotImplementedError`` naming it. Returns
    ``unet``."""
    from ..models.unet import CrossAttention, FeedForward
    ax = model_axis(mesh)
    if ax is None:
        return unet
    if layout(unet):
        raise RuntimeError("apply_tp: the UNet is cut already")
    cfg = unet.config
    for key in _REFUSED:
        if getattr(cfg, key):
            raise NotImplementedError(
                f"UNetConfig.{key} with tensor parallelism over a model "
                f"axis of {ax.size} ranks is not ported")
    found: Dict[str, Tuple[int, int]] = {}
    # column layers whose output stays local, GEGLU's paired ones, and the
    # row layers that take such an output (an attention whose heads the
    # axis cuts gathers q, k and v and scatters to_out's input)
    local_out, paired, local_in = set(), set(), set()
    for mn, m in unet.named_modules():
        if isinstance(m, CrossAttention) and m.heads % ax.size == 0:
            local_out.update(f"{mn}.{p}" for p in ("to_q", "to_k", "to_v"))
            local_in.add(f"{mn}.to_out.0")
        elif isinstance(m, FeedForward):
            paired.add(f"{mn}.net.0.proj")
            local_in.add(f"{mn}.net.2")
    local_out |= paired
    with torch.no_grad():
        for mn, m in list(unet.named_modules()):
            if type(m) not in (nn.Conv2d, nn.Linear):
                continue
            dims = {pn: tp_spec_for(f"{mn}.{pn}", tuple(p.shape), ax.size)
                    for pn, p in m.named_parameters(recurse=False)}
            wdim = dims["weight"]
            if wdim is None:
                continue
            if "bias" in dims and dims["bias"] != (0 if wdim == 0 else None):
                raise NotImplementedError(f"{mn}: a column-parallel layer "
                                          "with a replicated bias")
            conv = isinstance(m, nn.Conv2d)
            pairs = 2 if mn in paired else 1
            for pn, p in m.named_parameters(recurse=False):
                d = dims[pn]
                if d is not None:
                    p.data = local_tensor(p.data, d, ax, pairs)
                    found[f"{mn}.{pn}"] = (d, pairs)
            if conv:
                m.__class__ = ColumnConv2d if wdim == 0 else RowConv2d
                m.out_channels, m.in_channels = m.weight.shape[:2]
            else:
                m.__class__ = ColumnLinear if wdim == 0 else RowLinear
                m.out_features, m.in_features = m.weight.shape
                if wdim == 0:
                    m.gather = mn not in local_out
                else:
                    m.scatter = mn not in local_in
            m.tp = ax
    setattr(unet, LAYOUT, found)
    return unet


def tp_param_sharding(mesh, unet: nn.Module) -> Dict[str, Optional[int]]:
    """Each UNet parameter's sharded torch dim over the mesh's model axis
    (None: replicated), by :func:`tp_spec_for`."""
    n = mesh.model if mesh is not None else 1
    return {name: tp_spec_for(name, tuple(p.shape), n) if n > 1 else None
            for name, p in unet.named_parameters()}


@torch.no_grad()
def full_tensors(mesh, named: Sequence[Tuple[str, torch.Tensor]],
                 lay: Dict[str, Tuple[int, int]], keep: bool
                 ) -> Optional[List[torch.Tensor]]:
    """The whole tensors of ``named`` (this rank's shards, each named by its
    parameter; a tensor whose name ``lay`` does not list is replicated and
    taken as it is), on the CPU: each rank's shards broadcast over the
    model group in turn. Collective over the model group; ``keep``: this
    rank assembles and returns them (else None)."""
    from .mesh import broadcast_tensors
    ax = model_axis(mesh)
    if ax is None:
        return [t.detach().cpu() for _, t in named] if keep else None
    sharded = [(i, t) for i, (n, t) in enumerate(named) if n in lay]
    parts: Dict[int, List[torch.Tensor]] = {i: [] for i, _ in sharded}
    for r in range(ax.size):
        bufs = [t.detach().clone() if r == ax.rank else torch.empty_like(t)
                for _, t in sharded]
        broadcast_tensors(bufs, dist.get_global_rank(ax.group, r), ax.group)
        if keep:
            for (i, _), b in zip(sharded, bufs):
                parts[i].append(b.cpu())
    if not keep:
        return None
    out = []
    for i, (n, t) in enumerate(named):
        if n in lay:
            d, pairs = lay[n]
            out.append(whole_tensor(parts[i], d, pairs))
        else:
            out.append(t.detach().cpu())
    return out
