"""Spatial parallelism (SP) of the frozen VAEs over the mesh's ``model``
axis (counterpart of ``ldmseg_tpu/parallel/sp.py``).

JAX annotates the pixel-space tensors entering and leaving the VAEs with an
H sharding and GSPMD inserts the convolutions' halo exchanges and the
GroupNorms' cross-shard reductions. Here each model rank is a process, so
the exchanges are written out. :func:`apply_sp` gives the layers of a VAE
that read across rows a subclass that exchanges them, and the exchanges act
only while a stage runs under :func:`run_stage` (the VAEs are frozen: no
gradient crosses them); outside one each layer runs as its base class:

  * a row convolution (:class:`SpatialConv2d`, :func:`conv2d_rows`; the
    image VAE's ``(0, 1)``-padded downsample, :class:`SpatialDownsample`)
    takes the rows its window reads from the neighbouring shards (zeros at
    the image's borders: the convolution's own padding), then runs on its
    own rows with the window's stride; the stride-2 convolutions need
    shards whose row count the stride divides;
  * the int8 VAEs' s8 convolution (:class:`SpatialQuantConv2d`: the
    resnets', the image VAE's downsample with its ``(0, 1)`` padding, the
    seg decoder's ``in_conv`` and ``out_conv``) takes the same halo rows;
    its input scale is the site's static one or the maximum over the model
    group of the ranks' amaxes (one rank's scale), so its int32 sums are a
    rank's rows of the one-rank ones; the int8 ``ConvTranspose2x``
    (:class:`SpatialConvTranspose2x`, 2x2 with stride 2: no halo) takes its
    dynamic scale the same way;
  * ``GroupNorm`` (:class:`SpatialGroupNorm`) all-reduces its fp32 sums
    over the model group: the group means first, then the centred sums of
    squares; the int8 resnets' ``lowp`` GroupNorm + SiLU the same sums,
    then its affine in the input's dtype;
  * the VAE mid-block attention (:class:`SpatialAttentionBlock2D`) gathers
    the tokens of every shard, runs (K1's wide class with
    ``use_fused_attention``) on all of them and keeps its own rows;
  * the seg VAE's bilinear upsample (:class:`SpatialSegVAE`) and
    ``Resize`` (:class:`SpatialResize`) take rows of halo on each side
    (edge rows at the image's borders for the upsample's clamp; zero rows,
    weighted zero, for ``Resize``'s normalised triangle).

A stage whose input H the axis divides but whose shards the stage's total
stride does not run whole on every model rank (the same numbers, counted in
``run_stage.replicated``); where the axis does not divide H nothing is
sharded, JAX's no-op. The collectives are ``all_reduce`` alone (a gather is
an all-reduce of a zero-filled buffer of bytes, exact), which gloo runs on
CUDA tensors too.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.image_vae import _Downsample
from ..models.layers import (AttentionBlock2D, ConvTranspose2x, GroupNorm,
                             GroupNormSiLU)
from ..models.seg_vae import Resize, SegVAE
from ..ops.quant import QuantConv2d, dynamic_scale
from ..ops.resize import resize_weight_matrix


@dataclasses.dataclass(frozen=True)
class Axis:
    """The model group of one rank: its size, this rank's index in it and
    the group (None: a simulated axis in one process, no collective)."""
    size: int
    rank: int
    group: Any = None

    def __deepcopy__(self, memo):
        return self


def model_axis(mesh) -> Optional[Axis]:
    """The mesh's model axis, or None without one."""
    if mesh is None or mesh.model <= 1:
        return None
    return Axis(mesh.model, mesh.model_rank, mesh.model_group)


def all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated on ``dim`` in rank order, bit for
    bit: an all-reduce of a zero-filled ``[size, ...]`` buffer of bytes."""
    x = x.contiguous()
    buf = torch.zeros((ax.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[ax.rank] = x
    dist.all_reduce(buf.view(torch.uint8), group=ax.group)
    return torch.cat(buf.unbind(0), dim=dim)


def all_reduce_sum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    out = x.detach().clone()
    dist.all_reduce(out, group=ax.group)
    return out


def all_reduce_max(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x``, exact in any dtype:
    the ranks' tensors gathered (:func:`all_gather`), then their max."""
    return all_gather(x.detach().unsqueeze(0), ax, 0).amax(0)


_ACTIVE: Optional[Axis] = None


def active() -> Optional[Axis]:
    """The model axis the current stage's rows are sharded over, or None
    (outside :func:`run_stage`, or where it runs the stage whole)."""
    return _ACTIVE


@contextlib.contextmanager
def _sharded(ax: Optional[Axis]):
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, ax
    try:
        yield
    finally:
        _ACTIVE = before


def has_spatial_axis(mesh) -> bool:
    return mesh is not None and mesh.model > 1


def spatial_constraint(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This model rank's rows of ``x`` (H on ``dim``: 1 for NHWC, as JAX's,
    2 for the port's NCHW); ``x`` itself without a model axis, below rank
    3, or where the axis does not divide H."""
    if not has_spatial_axis(mesh) or x.dim() < 3 or x.shape[dim] % mesh.model:
        return x
    h = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * h, h).contiguous()


def batch_constraint(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """The whole of a tensor that :func:`spatial_constraint` sharded: the
    model ranks' rows gathered on ``dim`` (``x`` without a model axis)."""
    ax = model_axis(mesh)
    return x if ax is None else all_gather(x, ax, dim)


def run_stage(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              mesh, stride: int = 1) -> torch.Tensor:
    """``fn(x)`` for an NCHW ``x`` with H sharded over the mesh's model
    axis: each rank runs ``fn`` on its rows (the layers exchange their
    halos), and the output's rows are gathered back. ``stride`` is the
    stage's total stride: where the axis divides H but not into shards
    that ``stride`` divides, every rank runs ``fn`` whole
    (``run_stage.replicated`` counts it); where it does not divide H, and
    without a model axis, ``fn(x)``."""
    ax = model_axis(mesh)
    if ax is None or x.shape[2] % ax.size:
        return fn(x)
    if (x.shape[2] // ax.size) % stride:
        run_stage.replicated += 1
        return fn(x)
    with torch.no_grad(), _sharded(ax):
        y = fn(spatial_constraint(x, mesh, dim=2))
    run_stage.sharded += 1
    return all_gather(y, ax, 2)


run_stage.replicated = 0
run_stage.sharded = 0


def halo_rows(x: torch.Tensor, top: int, bottom: int, ax: Axis,
              edge: bool = False) -> torch.Tensor:
    """``x`` (NCHW, this rank's rows) with ``top`` rows of the shard above
    and ``bottom`` rows of the shard below added; at the image's borders
    zero rows, or with ``edge`` copies of the edge row. Every rank's
    boundary rows go through one gather."""
    if top == 0 and bottom == 0:
        return x
    h = x.shape[2]
    if top > h or bottom > h:
        raise ValueError(f"a halo of {top}/{bottom} rows over shards of "
                         f"{h}")
    parts = [x[:, :, h - top:], x[:, :, :bottom]]
    rows = all_gather(torch.cat(parts, dim=2).unsqueeze(0), ax, 0)
    r = ax.rank

    def border(n, row):
        if edge:
            return row.expand(-1, -1, n, -1)
        return torch.zeros_like(row).expand(-1, -1, n, -1)

    above = (rows[r - 1, :, :, :top] if r > 0
             else border(top, x[:, :, :1]))
    below = (rows[r + 1, :, :, top:] if r < ax.size - 1
             else border(bottom, x[:, :, h - 1:]))
    return torch.cat([above, x, below], dim=2)


def haloed_rows(x: torch.Tensor, kh: int, sh: int, top: int,
                bottom: int) -> torch.Tensor:
    """This rank's rows of the image inside a sharded stage with the rows a
    ``kh``-row window of stride ``sh``, padded ``top``/``bottom`` over the
    whole image, reads from the neighbours (zeros at the image's borders),
    so that a window without row padding gives this rank's output rows.
    The shard's row count must be a multiple of the stride, and the
    output's rows split evenly."""
    ax = active()
    h = x.shape[2]
    if h % sh or (ax.size * h + top + bottom - kh) // sh + 1 != \
            ax.size * h // sh:
        raise ValueError(f"a {kh}-row window of stride {sh}, padded "
                         f"{top}/{bottom}, over shards of {h} rows: the "
                         "output's rows do not split evenly")
    below = kh - sh - top  # rows past the shard the last window reads
    x = halo_rows(x, top, max(below, 0), ax)
    return x[:, :, :x.shape[2] + below] if below < 0 else x


def conv2d_rows(x: torch.Tensor, conv: nn.Conv2d,
                pad: Optional[Tuple[int, int, int, int]] = None
                ) -> torch.Tensor:
    """``conv`` on this rank's rows of the image inside a sharded stage:
    ``pad`` (left, right, top, bottom; default the convolution's own
    symmetric padding) as the convolution pads the whole image, the rows
    its windows read from the neighbours exchanged first
    (:func:`haloed_rows`)."""
    kh, _ = conv.kernel_size
    sh, sw = conv.stride
    if pad is None:
        ph, pw = conv.padding
        pad = (pw, pw, ph, ph)
    left, right, top, bottom = pad
    x = haloed_rows(x, kh, sh, top, bottom)
    if left or right:
        x = F.pad(x, (left, right, 0, 0))
    return F.conv2d(x, conv.weight, conv.bias, (sh, sw))


def group_scale(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The dynamic per-tensor int8 scale of the whole tensor of which ``x``
    holds this rank's part (a rank's rows, or its channels under tensor
    parallelism): the maximum of the ranks' amaxes."""
    return dynamic_scale(all_reduce_max(x.detach().float().abs().amax(),
                                        ax))


class SpatialConv2d(nn.Conv2d):
    """A convolution that exchanges halos inside a sharded stage."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _ACTIVE is None or (self.kernel_size[0] == 1
                               and self.stride[0] == 1):
            return super().forward(x)
        return conv2d_rows(x, self)


class SpatialQuantConv2d(QuantConv2d):
    """An s8 convolution (prepared) that exchanges halos inside a sharded
    stage: the input scale of the whole image (:func:`group_scale` where it
    is dynamic), the halo rows of its window and padding, then the s8
    convolution of the extended rows with its column padding alone."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ax = _ACTIVE
        if ax is None:
            return super().forward(x)
        if self.w_q is None or isinstance(x, tuple):
            raise RuntimeError("SpatialQuantConv2d: a prepared s8 conv on a "
                               "float input (prepare_int8_vae)")
        scale = self.site_scale()
        if scale is None:
            scale = group_scale(x, ax)
        (top, bottom), cols = self.s8_padding
        xh = haloed_rows(x, 3, self.s8_stride, top, bottom)
        return self.s8_forward(xh, scale, ((0, 0), cols))


class SpatialDownsample(_Downsample):
    """The image VAE's downsample: pad (0, 1), so a shard reads one row of
    the shard below (int8: its :class:`SpatialQuantConv2d` pads so)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _ACTIVE is None or self.use_int8:
            return super().forward(x)
        return conv2d_rows(x, self.conv, (0, 1, 0, 1))


class SpatialConvTranspose2x(ConvTranspose2x):
    """The int8 upscaler on this rank's rows (a 2x2 window of stride 2
    reads no other rows): a dynamic input scale is the whole image's."""

    def input_scale(self, x: torch.Tensor):
        ax = _ACTIVE
        if ax is None or self.act_scale is not None:
            return self.act_scale
        return group_scale(x, ax)


class _SpatialNorm:
    """GroupNorm in fp32 over the whole image of this rank's rows: the
    group sums all-reduced over the model group, then the centred sums of
    squares (the two passes of a one-rank variance)."""

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        ax = _ACTIVE
        if ax is None:
            return super().normalize(x)
        b, c = x.shape[:2]
        xf = x.float()
        xg = xf.reshape(b, self.num_groups, -1)
        count = xg.shape[-1] * ax.size
        mean = all_reduce_sum(xg.sum(-1), ax) / count
        cen = xg - mean[..., None]
        var = all_reduce_sum(cen.square().sum(-1), ax) / count
        y = (cen * torch.rsqrt(var + self.eps)[..., None]).reshape(xf.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return (y * self.weight.float().reshape(shape)
                + self.bias.float().reshape(shape))

    def group_stats(self, xr: torch.Tensor):
        """The ``lowp`` path's group mean and variance over the whole
        image: the same two all-reduced passes."""
        ax = _ACTIVE
        if ax is None:
            return super().group_stats(xr)
        count = xr.shape[-1] * ax.size
        mean = all_reduce_sum(xr.sum(-1, keepdim=True), ax) / count
        var = all_reduce_sum((xr - mean).square().sum(-1, keepdim=True),
                             ax) / count
        return mean, var


class SpatialGroupNorm(_SpatialNorm, GroupNorm):
    pass


class SpatialGroupNormSiLU(_SpatialNorm, GroupNormSiLU):
    pass


class SpatialAttentionBlock2D(AttentionBlock2D):
    """The mid-block attention reads every token: the rows gathered, the
    block run on the whole image with the stage suspended, this rank's
    rows kept."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ax = _ACTIVE
        if ax is None:
            return super().forward(x)
        h = x.shape[2]
        with _sharded(None):
            y = super().forward(all_gather(x, ax, 2))
        return y[:, :, ax.rank * h:(ax.rank + 1) * h]


class SpatialResize(Resize):
    """``Resize`` on this rank's rows: the whole image's ``[H, H']``
    weight matrix, ``factor / 2`` rows of halo on each side (zero rows
    outside the image, whose weights are zero), the rows of the matrix
    that the extended shard covers and its columns of this shard. The
    shard's rows must split the output's evenly."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ax = _ACTIVE
        if ax is None:
            return super().forward(x)
        h, w = x.shape[-2:]
        wh, ww = (torch.from_numpy(resize_weight_matrix(n, n // self.factor)
                                   ).to(x.device, x.dtype)
                  for n in (h * ax.size, w))
        halo, r = self.factor // 2, ax.rank
        ho = wh.shape[1] // ax.size
        xe = halo_rows(x, halo, halo, ax)
        we = wh.new_zeros((h + 2 * halo, ho))
        lo = r * h - halo
        a, b = max(lo, 0), min(lo + h + 2 * halo, wh.shape[0])
        we[a - lo:b - lo] = wh[a:b, r * ho:(r + 1) * ho]
        return torch.einsum("bchw,hH,wW->bcHW", xe, we, ww)


class SpatialSegVAE(SegVAE):
    """The bilinear (half-pixel, edge-clamped) upsample of the decode on
    this rank's rows: one edge-clamped halo row on each side, the upsample
    on them, the rows of this shard kept (it commutes with a shift by
    whole rows)."""

    def upsample(self, x: torch.Tensor) -> torch.Tensor:
        ax, f = _ACTIVE, self.interpolation_factor
        if ax is None or f == 1:
            return super().upsample(x)
        y = super().upsample(halo_rows(x, 1, 1, ax, edge=True))
        return y[:, :, f:f * (x.shape[2] + 1)]


_SPATIAL = {GroupNorm: SpatialGroupNorm,
            GroupNormSiLU: SpatialGroupNormSiLU,
            _Downsample: SpatialDownsample,
            AttentionBlock2D: SpatialAttentionBlock2D,
            Resize: SpatialResize, SegVAE: SpatialSegVAE,
            QuantConv2d: SpatialQuantConv2d,
            ConvTranspose2x: SpatialConvTranspose2x}


def apply_sp(module: nn.Module) -> nn.Module:
    """Give every ``nn.Conv2d`` of ``module`` the halo exchange of
    :class:`SpatialConv2d`, and each layer that reads across rows or takes
    a whole image's scale (a GroupNorm, the ``lowp`` GroupNorm + SiLU, the
    image VAE's downsample, the mid-block attention, ``Resize``, the seg
    VAE's upsample, an s8 conv, the int8 upscaler) its spatial subclass;
    their parameters and names stay, and outside a sharded stage they run
    as before. K5 and K6 (``use_pallas``, ``quantize``) raise
    ``NotImplementedError``. Returns ``module``."""
    for m in module.modules():
        kind = type(m)
        if kind is nn.Conv2d:
            if m.padding_mode != "zeros" or m.groups != 1 or \
                    m.dilation != (1, 1):
                raise NotImplementedError(
                    f"spatial parallelism of {m}: zero padding, one group "
                    "and no dilation only")
            m.__class__ = SpatialConv2d
        elif kind in _SPATIAL:
            if any(getattr(m, k, False) for k in ("use_pallas", "quantize")):
                raise NotImplementedError(
                    f"spatial parallelism of {kind.__name__}: the fused "
                    "GroupNorm kernels (K5, K6) are not ported")
            m.__class__ = _SPATIAL[kind]
    return module
