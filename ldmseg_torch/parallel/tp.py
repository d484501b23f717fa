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
  * ``to_q``/``to_k``/``to_v`` keep their output local: K1 (K2 backward),
    or K14 on the packed ``[B, T, C/n]`` (``use_packed_attention``),
    attends over this rank's ``heads / n`` heads, and the row-parallel
    ``to_out`` sums the ranks' partial products (:func:`reduce_from`:
    all-reduce, identity backward) before its bias, added once; where the
    axis does not divide the heads (JAX then splits a head), q, k and v
    are gathered, K1 or K14 attends over all the heads and ``to_out`` takes
    this rank's channels of its input (:func:`scatter_to`);
  * an absorbed attention (``use_absorbed_attention``: K16 reads the four
    weights inside its kernel) keeps its plain ``Linear`` layers holding
    this rank's shards (``to_q``/``to_k``/``to_v`` ``[C/n, C]``, ``to_out``
    ``[C, C/n]``) and takes the group as ``tp_group``: x passes through
    :func:`copy_to`, K16's partial mode writes ``to_out``'s fp32 product
    over the rank's heads, summed with :func:`reduce_from`, rounded once,
    then the bias; where the axis does not divide the heads it stays whole
    on every rank;
  * GEGLU's ``proj`` (JAX's one Dense of ``2 * inner``) holds this rank's
    ``h`` rows and its ``gate`` rows side by side (``pairs`` 2), so that
    each rank computes its slice of the gated product locally; ``ff.net.2``
    is row-parallel on it;
  * Transformer2D's 1x1 ``proj_out`` is row-parallel on a replicated
    input: this rank's channels are taken (:func:`scatter_to`: slice,
    all-gather backward).

The replicated parameters (norms, the time embedding, the learnable
``object_queries``) receive the same gradient on every model rank; the
trainer averages them over the group all the same. A checkpoint holds the
one-rank layout (:func:`full_tensors`, :func:`local_tensor`).

The int8 UNet of ``sampling_kwargs.int8_inference`` is cut by the same
rules, its codes filled from the cut masters (``ops/quant.py:
prepare_int8_unet``), so that every rank's codes and scales are the slice
of the one-rank ones:

  * an s8 conv (``QuantConv2d``: the resnets', Down- and Upsample's) is
    column-parallel (:class:`ColumnQuantConv2d`), its per-output-channel
    codes a slice; its input is replicated, so a dynamic per-tensor scale
    is the same on every rank; with ``int8_fuse_gn`` K6 runs whole on the
    replicated activation and hands the conv its ``(codes, scales)``,
    which pass without a collective (no gradient on that path);
  * K3 (``LNAttentionS8``) packs a rank's heads (``w_qkv [3ci, C]``,
    ``wo [C, ci]``, per-head scales) and K4 (``LNFeedForwardS8``) a rank's
    GEGLU columns (``w1``'s paired rows, ``w2 [C, M/n]``); each writes its
    fp32 partial, summed over the group (:class:`ModelGroup`, their
    ``tp_group``) before the residual and bias are added and rounded once;
  * with ``use_fused_projs`` K8 and K9 take Transformer2D's 1x1
    ``proj_in`` and ``proj_out`` whole on every rank, gathered from the
    cut masters at prepare time (:func:`whole_layer`): K8's prologue
    builds the fp32 residual stream over all C (the LayerNorm reads every
    channel), K3's partial mode follows on a rank's heads and the finish
    rounds ``xf`` plus the summed partials once; K9 is K4's partial mode,
    the sum rounded into the block output, then its ``proj_out`` stage;
  * K11 (``PaddedAttentionS8``, ``use_padded_attention`` without fused
    norms) keeps its four projections' plain ``Linear`` class holding a
    rank's heads, as an absorbed attention does; its pack takes the
    group's maximum of the ``to_out`` head scales (``out_scale`` and each
    head's ratio read it), and its int32 ``to_out`` partials are summed
    exactly (:meth:`ModelGroup.sum_exact`): one rank's output bit for bit;
  * without fused norms, ``ff.net.0.proj`` is a column-parallel
    ``QuantLinear`` (:class:`ColumnQuantLinear`) and ``ff.net.2`` a
    row-parallel one (:class:`RowQuantLinear`: its int32 partials
    dequantized and summed in fp32, the bias once), K12 the rank's fp32
    partial, K13 or K15 (``use_packed_attention``) the rank's heads, and
    K17 (``use_absorbed_attention``, ``AbsorbedAttentionS8``) a pack of the
    rank's heads (its per-head scales local to a head, so the codes are the
    slice of one rank's) writing its fp32 ``to_out`` partial, summed over
    the group and rounded once to bf16;
  * a row-parallel layer's per-output-channel scale is an amax over the
    whole input dimension: ``RowLinear.tp_group`` gives the maximum over
    the group of the rank's amaxes (``ops/quant.py:quantize_rows``); so do
    the dynamic activation scales of what a rank holds a slice of (K4's and
    K12's interior per (image, token block), K13's and K15's q, k and v,
    the unfused ``ff.net.2``'s input) and the calibration's gated-interior
    site;
  * where the axis does not divide a block's heads, its attentions take
    no group (their q, k and v are gathered, as in the float UNet, or an
    absorbed one and K11 stay whole); K3 and K8 then run the one-rank
    kernel on every rank, on a pack of the masters' attention gathered
    whole (:func:`whole_attention`); where the axis does not divide the 4C
    GEGLU columns, the feed-forward stays whole and takes none.

Conditioning takes the same rules: ``attn2``'s ``to_q``/``to_k``/``to_v``
are column-parallel (``to_k``/``to_v`` on the replicated context),
``to_out`` row-parallel, ``encoder_hid_proj`` column-parallel with a
gather; ``object_queries`` stay replicated.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.quant import (QuantConv2d, QuantLinear, int8_matmul,
                         quantize_activation)
from .sp import (Axis, all_gather, all_reduce_max, all_reduce_sum,
                 group_scale, model_axis)

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
    """This rank's output channels; gathered. K6's ``(codes, scales)``
    input (an s8 conv's, inference only) passes as it is."""
    tp: Axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not isinstance(x, tuple):
            x = copy_to(x, self.tp)
        return gather_from(super().forward(x), self.tp, 1)


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

    @property
    def tp_group(self) -> "ModelGroup":
        """The model group's reductions: the weight's per-row quantization
        takes the whole rows' amax from them
        (``ops/quant.py:quantize_rows``)."""
        return ModelGroup(self.tp)


class ModelGroup:
    """The model group's reductions that the int8 ops take as ``group``
    (``apply_tp`` sets them as ``tp_group`` on a module whose projections
    it cut): ``sum`` adds the ranks' fp32 partials (in fp32),
    ``sum_exact`` their integer partials, ``max`` takes the maximum of the
    ranks' amaxes (exact, any dtype); and the
    collectives with their backward that K16's partial mode runs between
    (``copy_to``, ``reduce_from``)."""

    def __init__(self, ax: Axis):
        self.ax = ax

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _reduce(x.float(), self.ax)

    def sum_exact(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' integer partials (K11's int32 ``to_out``),
        exact, in their dtype."""
        return all_reduce_sum(x, self.ax)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(x, self.ax)

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`copy_to` over the group (identity; the gradient
        summed)."""
        return copy_to(x, self.ax)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`reduce_from` over the group (the sum; the gradient
        passes)."""
        return reduce_from(x, self.ax)

    def __deepcopy__(self, memo):
        return self


class ColumnQuantConv2d(ColumnConv2d, QuantConv2d):
    """An s8 conv on this rank's output channels (their codes and scales),
    on the replicated input; gathered."""


class ColumnQuantLinear(ColumnLinear, QuantLinear):
    """An s8 linear on this rank's output features, gathered where
    ``gather``."""


class RowQuantLinear(RowLinear, QuantLinear):
    """An s8 linear on this rank's input features (prepared: the codes of
    the whole rows' scales): the input quantized per tensor with the site's
    static scale, else with the amax over the group; the int32 partial
    product dequantized in fp32, the ranks' partials summed in fp32, then
    rounded to the input's dtype and the bias added once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_q is None:
            raise RuntimeError("RowQuantLinear: prepare it first (run "
                               "prepare_int8_unet)")
        if self.scatter:
            x = scatter_to(x, self.tp, -1)
        site = self.x_scale if self.x_scale is not None else self.act_scale
        if site is None:
            site = group_scale(x, self.tp)
        x_q, xs = quantize_activation(x, site)
        y = int8_matmul(x_q.reshape(-1, self.in_features), self.w_q)
        y = y.reshape(*x.shape[:-1], self.out_features)
        y = _reduce(y.float() * (xs * self.w_scale), self.tp).to(x.dtype)
        return y + self.bias.to(y.dtype)


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


def whole_layer(m: nn.Module):
    """The whole weight and bias of a layer that :func:`apply_tp` cut,
    its ranks' shards gathered in rank order (a collective over the model
    group): a column-parallel layer's output rows and bias, a row-parallel
    one's input columns (its bias is replicated). Returned as an object
    with ``weight`` and ``bias``; a layer it did not cut (no model axis,
    or a dimension the axis does not divide) is returned as it is. Not for
    GEGLU's paired ``proj``."""
    ax = getattr(m, "tp", None)
    if ax is None:
        return m
    column = isinstance(m, (ColumnConv2d, ColumnLinear))
    bias = m.bias
    if bias is not None and column:
        bias = all_gather(bias.detach(), ax, 0)
    return SimpleNamespace(weight=all_gather(m.weight.detach(), ax,
                                             0 if column else 1), bias=bias)


def whole_attention(attn: nn.Module):
    """An attention's four projections whole (:func:`whole_layer` each),
    for packing a kernel that runs the whole attention on every rank (K3,
    K8 and K11 where the axis does not divide the heads); ``attn`` itself
    where none of them was cut."""
    layers = (attn.to_q, attn.to_k, attn.to_v, attn.to_out[0])
    if all(getattr(m, "tp", None) is None for m in layers):
        return attn
    q, k, v, o = (whole_layer(m) for m in layers)
    return SimpleNamespace(to_q=q, to_k=k, to_v=v, to_out=[o])


# the attribute on a TP UNet: {parameter name: (torch dim, pairs)}
LAYOUT = "_tp_layout"


def layout(module: nn.Module) -> Dict[str, Tuple[int, int]]:
    """The sharded parameters of a TP module (empty for any other)."""
    return getattr(module, LAYOUT, {})


_REFUSED = ("separate_conv", "separate_encoder", "add_adaptor",
            "upscaler_classes")
# the layers apply_tp cuts: (column-parallel class, row-parallel class)
_CUT = {nn.Conv2d: (ColumnConv2d, RowConv2d),
        nn.Linear: (ColumnLinear, RowLinear),
        QuantConv2d: (ColumnQuantConv2d, None),
        QuantLinear: (ColumnQuantLinear, RowQuantLinear)}


def apply_tp(mesh, unet: nn.Module) -> nn.Module:
    """Cut ``unet`` (a whole :class:`~..models.unet.UNet2DCondition`, the
    same weights on every model rank) into this model rank's shards in
    place by :func:`tp_spec_for`, and give its layers their collectives.
    Without a model axis nothing changes. A UNet option that the model axis
    does not take raises ``NotImplementedError`` naming it. Returns
    ``unet``."""
    from ..models.unet import (BasicTransformerBlock, CrossAttention,
                               PaddedAttentionS8)
    ax = model_axis(mesh)
    if ax is None:
        return unet
    if layout(unet):
        raise RuntimeError("apply_tp: the UNet is cut already")
    cfg = unet.config
    refused = [key for key in _REFUSED if getattr(cfg, key)]
    if refused:
        raise NotImplementedError(
            f"UNetConfig.{refused[0]} with tensor parallelism over a model "
            f"axis of {ax.size} ranks is not ported")
    group = ModelGroup(ax)
    found: Dict[str, Tuple[int, int]] = {}
    # column layers whose output stays local, GEGLU's paired ones, the row
    # layers that take such an output, and the layers kept whole. An
    # attention whose heads the axis cuts keeps q, k and v local (else it
    # gathers them and scatters to_out's input); a feed-forward whose 4C
    # columns it cuts runs on a rank's columns (else it stays whole). The
    # int8 blocks (K3, K4, K8, K9, K11, K12, K13, K15, K17) get the group
    # where their pack or projections hold a rank's share, and only there.
    # An absorbed attention (K16, K17) and K11 read their four weights
    # themselves: they are cut where the axis divides the heads and keep
    # their plain class (``weights_only``), else the attention stays whole.
    local_out, paired, local_in, whole = set(), set(), set(), set()
    weights_only = set()
    for bn, blk in unet.named_modules():
        if not isinstance(blk, BasicTransformerBlock):
            continue
        heads_cut = blk.heads % ax.size == 0
        for an in ("attn1", "attn2"):
            attn = getattr(blk, an, None)
            if attn is None:
                continue
            projs = [f"{bn}.{an}.{p}" for p in ("to_q", "to_k", "to_v",
                                                "to_out.0")]
            reads_weights = (getattr(attn, "absorbed", False)
                             or isinstance(attn, PaddedAttentionS8))
            if reads_weights:
                (weights_only if heads_cut else whole).update(projs)
            if not heads_cut:
                continue
            attn.tp_group = group
            if isinstance(attn, CrossAttention) and not reads_weights:
                local_out.update(projs[:3])
                local_in.add(projs[3])
        names = (f"{bn}.ff.net.0.proj", f"{bn}.ff.net.2")
        if 4 * blk.dim % ax.size:
            whole.update(names)
            continue
        blk.ff.tp_group = group
        paired.add(names[0])
        local_in.add(names[1])
    local_out |= paired
    with torch.no_grad():
        for mn, m in list(unet.named_modules()):
            if type(m) not in _CUT or mn in whole:
                continue
            dims = {pn: tp_spec_for(f"{mn}.{pn}", tuple(p.shape), ax.size)
                    for pn, p in m.named_parameters(recurse=False)}
            wdim = dims["weight"]
            if wdim is None:
                continue
            if "bias" in dims and dims["bias"] != (0 if wdim == 0 else None):
                raise NotImplementedError(f"{mn}: a column-parallel layer "
                                          "with a replicated bias")
            column, row = _CUT[type(m)]
            if wdim != 0 and row is None:
                raise NotImplementedError(f"{mn}: a row-parallel "
                                          f"{type(m).__name__}")
            conv = isinstance(m, nn.Conv2d)
            pairs = 2 if mn in paired else 1
            for pn, p in m.named_parameters(recurse=False):
                d = dims[pn]
                if d is not None:
                    p.data = local_tensor(p.data, d, ax, pairs)
                    found[f"{mn}.{pn}"] = (d, pairs)
            if mn in weights_only:
                m.out_features, m.in_features = m.weight.shape
                continue
            m.__class__ = column if wdim == 0 else row
            if conv:
                m.out_channels, m.in_channels = m.weight.shape[:2]
            else:
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
