"""K7: one ResnetBlock half, GroupNorm + SiLU + 3x3 conv + bias, NCHW.

Counterpart of ``ldmseg_tpu/ops/pallas/gn_silu_conv.py``: the Pallas kernel
``_kernel`` (:30) behind ``fused_gn_silu_conv`` (:105) with its recompute
VJP (:116-128), the XLA twin ``_reference`` (:95) and the dispatch
``gn_silu_conv`` (:131). No module routes to it, in JAX or here: it is an op
(``chip_smoke.py`` drives it on the UNet's resnet halves). It takes the
port's layouts, x ``[B, Cin, H, W]`` and w ``[Cout, Cin, 3, 3]`` (the JAX
function NHWC and HWIO).

Dispatch, as in JAX: when ``max(H·W·Cin, H·W·Cout)·4 <= 6 MiB`` a CUDA
tensor goes to ``csrc/gn_silu_conv.cu`` (bf16 only, the path's type; any
other input it cannot take raises; counted in
``gn_silu_conv.launches``) and a CPU tensor to the kernel's plain version
:func:`gn_silu_conv_reference`; larger images go to
:func:`gn_silu_conv_fallback`, counted in ``gn_silu_conv.fallbacks``.

On the card a call is two or three launches (:func:`sm90_conv_plan`): y =
GN + SiLU of x into a zero-padded channel-last scratch of
:func:`padded_width` columns a row, the 3x3 conv as one product of
``gemm_sm90.cuh`` over nine shifted taps of that scratch (A: the weights
packed tap-major, :func:`pack_conv_weight`, once per weight and version),
and, where the product splits its stages over blocks, the sum of the
split's partials.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch
import torch.nn.functional as F

from . import _build
from .attention import SM90_SMS
from .gemm import DEEP_STAGES, GemmPlan, sm90_gemm_plan
from .groupnorm_silu import (MAX_CLUSTER, check_kernel_input,
                             gn_silu_reference, gn_silu_rows)

MAX_TILE_BYTES = 6 * 1024 * 1024
# the product's tile, (output channels, padded positions): the largest, so
# that the weights and the scratch are read by the fewest blocks; the
# stages split over blocks where its grid leaves SMs idle
CONV_TILE = (128, 128)
CHANNEL_BLOCK = 64       # channels of one stage (one 128-byte swizzle row)
PAD_SMEM_LIMIT = 200 * 1024  # the activation pass's chunk of x
PAD_VALUES = 8192        # x values a CTA of the activation pass holds (K5's)


def takes_kernel(x: torch.Tensor, cout: int, max_tile_bytes: int) -> bool:
    """The JAX wrapper's tile rule (:139) without its CPU clause."""
    _, cin, h, w = x.shape
    return max(h * w * cin, h * w * cout) * 4 <= max_tile_bytes


def gn_silu_conv_reference(x, scale, bias, w, b, groups: int = 32,
                           eps: float = 1e-5) -> torch.Tensor:
    """K7's plain version (:30-58): :func:`gn_silu_rows` rounded to x's
    dtype (the kernel's padded scratch), zero padding of that activation,
    the 3x3 conv of its values with w in x's dtype summed in fp32, the bias
    added in fp32, the result in x's dtype."""
    y = gn_silu_rows(x, scale, bias, groups, eps).to(x.dtype).float()
    out = F.conv2d(y, w.to(x.dtype).float(), padding=1)
    return (out + b.float()[:, None, None]).to(x.dtype)


def gn_silu_conv_fallback(x, scale, bias, w, b, groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """``_reference`` (:95-102): :func:`gn_silu_reference` in x's dtype,
    the conv in x's dtype, the bias in the conv's dtype; differentiable (the
    recompute of the backward)."""
    y = gn_silu_reference(x, scale, bias, groups, eps)
    out = F.conv2d(y, w.to(x.dtype), padding=1)
    return (out + b.to(out.dtype)[:, None, None]).to(x.dtype)


def padded_width(w: int) -> int:
    """Columns of a row of K7's padded scratch: the image's ``w``, then
    zeros up to ``w + 1`` rounded up to even. One zero column between two
    rows is the right halo of one and the left halo of the next, and an
    even width makes padded positions pair up as image columns do (an
    accumulator pair, one store)."""
    return w + 1 + (w + 1) % 2


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """K7's launches for ``x [b, cin, h, w]`` and ``cout`` outputs: the
    product ``gemm`` (``[cout, n]`` over ``9·cblocks`` stages of 64
    channels, ``n`` the ``positions = b·(h + 2)·wp`` of the padded scratch
    rounded up to 8), its stages split over ``splits`` blocks per tile; the
    activation pass's cluster of ``cluster`` CTAs per (image, group), each
    ``rows_per_cta`` image rows, 16-byte loads (``vec`` 8) or scalar ones,
    its slice of x held in chunks of ``chunk_ch`` channels x ``chunk_pix``
    pixels (:func:`pad_chunk`; x read once when the slice is one chunk,
    else twice, the sums and then chunk by chunk), ``pad_smem`` bytes of
    shared memory; the
    scratch's and the pack's rows ``cin8`` channels a tap (Cin rounded up
    to 8)."""

    gemm: GemmPlan
    wp: int
    cblocks: int
    splits: int
    cluster: int
    rows_per_cta: int
    vec: int
    pad_smem: int
    chunk_ch: int
    chunk_pix: int
    cin8: int
    positions: int
    n: int

    def fields(self) -> tuple:
        """The eighteen ints the C entry point reads: the product's nine,
        then ``gn_silu_conv.cu``'s ``TapsPlan``."""
        return (*self.gemm.fields(), self.wp, self.cblocks, self.splits,
                self.cluster, self.rows_per_cta, self.vec, self.pad_smem,
                self.chunk_ch, self.chunk_pix)

    def split_ranges(self) -> list:
        """The stages ``[first, end)`` of each split, in the kernel's
        order (``gemm_kernel``: block z takes ``[z·K / Z, (z + 1)·K /
        Z)``)."""
        k = self.gemm.k_tiles
        return [(z * k // self.splits, (z + 1) * k // self.splits)
                for z in range(self.splits)]

    @property
    def launches(self) -> int:
        """Kernels a call: the activation pass, the product, and the sum of
        the split's partials where there is a split."""
        return 2 + (self.splits > 1)


def pad_chunk(cg: int, npix: int) -> tuple:
    """(channels, pixels) of the activation pass's chunk of x for a CTA
    slice of ``cg`` channels x ``npix`` pixels, at most
    :data:`PAD_SMEM_LIMIT` bytes as bf16 ``[channels, pixels + 2]``: the
    whole slice when it fits (x read once); else all ``cg`` channels and
    the most pixels, a multiple of 8 (16-byte loads), that fit; else 64
    pixels and an even number of channels (pairs of channels a store)."""
    values = PAD_SMEM_LIMIT // 2
    if cg * (npix + 2) <= values:
        return cg, npix
    if cg * 10 <= values:
        return cg, (values // cg - 2) // 8 * 8
    pix = min(npix, 64)
    ch = values // (pix + 2)
    return ch - ch % 2, pix


@functools.lru_cache(maxsize=None)
def sm90_conv_plan(b: int, cin: int, cout: int, h: int, w: int,
                   groups: int, aligned: bool = True) -> ConvPlan:
    """K7's launch plan (checked by ``csrc/gn_silu_conv.cu``): the product
    on :data:`CONV_TILE` tiles with the deepest ring that fits, split-K by
    ``splits = max(1, min(132 // blocks, stages))`` where its grid leaves
    SMs idle (the deep levels, bound by their weights); the activation pass
    with as many CTAs per (image, group) as hold its ``C/G·H·W`` values at
    :data:`PAD_VALUES` a CTA (at most 8, each a range of ``rows_per_cta``
    image rows; a small span takes one CTA and no cluster barrier), each
    CTA's slice in :func:`pad_chunk`'s chunks. ``aligned``: x's base allows
    16-byte loads (with ``w % 8 == 0``). Any Cin the groups divide: the
    scratch's and the pack's rows are ``cin8`` channels (a tensor map's
    stride is a multiple of 16 bytes). Raises ``ValueError`` on a
    non-positive dimension or Cin not divisible by the groups."""
    if min(b, cin, cout, h, w, groups) < 1 or cin % groups:
        raise ValueError(f"K7 takes positive dimensions and Cin a multiple "
                         f"of the groups, got [{b}, {cin}, {h}, {w}] -> "
                         f"{cout} in {groups} groups")
    wp = padded_width(w)
    positions = b * (h + 2) * wp
    n = -(-positions // 8) * 8
    cblocks = -(-cin // CHANNEL_BLOCK)
    stages = 9 * cblocks
    gemm = sm90_gemm_plan(cout, n, CHANNEL_BLOCK * stages, "bfloat16",
                          max_stages=DEEP_STAGES, tile=CONV_TILE)
    blocks = gemm.grid[0] * gemm.grid[1]
    splits = max(1, min(SM90_SMS // blocks, stages))
    cg = cin // groups
    rows_per_cta = -(-h // max(1, min(MAX_CLUSTER,
                                      -(-cg * h * w // PAD_VALUES))))
    chunk_ch, chunk_pix = pad_chunk(cg, rows_per_cta * w)
    return ConvPlan(gemm=gemm, wp=wp, cblocks=cblocks, splits=splits,
                    cluster=-(-h // rows_per_cta), rows_per_cta=rows_per_cta,
                    vec=8 if aligned and w % 8 == 0 else 1,
                    pad_smem=chunk_ch * (chunk_pix + 2) * 2,
                    chunk_ch=chunk_ch, chunk_pix=chunk_pix,
                    cin8=-(-cin // 8) * 8, positions=positions, n=n)


@functools.lru_cache(maxsize=None)
def _plan_c(*key):
    plan = sm90_conv_plan(*key)
    fields = plan.fields()
    return plan, (ctypes.c_int * len(fields))(*fields)


def pack_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """K7's A operand: ``w [Cout, Cin, 3, 3]`` as bf16 ``[Cout, 9·cin8]``,
    tap-major and K-major (``w.permute(0, 2, 3, 1)``, each tap's Cin
    weights followed by zeros up to ``cin8``, Cin rounded up to 8): a tap's
    weights of an output channel contiguous, a TMA box at a fixed tap, a
    row a multiple of 16 bytes."""
    t = w.detach().permute(0, 2, 3, 1)
    cin = t.shape[-1]
    t = F.pad(t, (0, -(-cin // 8) * 8 - cin))
    return t.reshape(w.shape[0], -1).to(torch.bfloat16).contiguous()


def _fp32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


# (id(t), make) -> (weak reference to t, what it was made of, make(t))
_PACKS: dict = {}


def _cached(t: torch.Tensor, make):
    """``make(t)``, made once per tensor and kept until ``t`` changes (its
    version, storage, shape or type) or dies; an inference tensor, which
    keeps no version, is made anew at every call."""
    if t.is_inference():
        return make(t)
    key = (id(t), make)
    made_of = (t._version, t.data_ptr(), tuple(t.shape), t.dtype)
    hit = _PACKS.get(key)
    if hit is not None and hit[0]() is t and hit[1] == made_of:
        return hit[2]
    out = make(t)
    _PACKS[key] = (weakref.ref(t, lambda _r, key=key: _PACKS.pop(key, None)),
                   made_of, out)
    return out


def packed_weight(w: torch.Tensor) -> torch.Tensor:
    """:func:`pack_conv_weight` of ``w``, made once per weight and version
    (the pack moves 1.8-59 MB at the UNet's sites: paid per call it would
    take longer than the deep levels' conv)."""
    return _cached(w, pack_conv_weight)


@functools.cache
def _kernel():
    fn = _build.load("gn_silu_conv").ldmseg_gn_silu_conv
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_int),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, scale, bias, w, b, groups, eps):
    check_kernel_input("K7", x, groups, dtypes=(torch.bfloat16,))
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"K7: w must be [Cout, {cin}, 3, 3], got "
                         f"{tuple(w.shape)}")
    try:
        plan, plan_c = _plan_c(bsz, cin, cout, h, wd, groups,
                               x.data_ptr() % 16 == 0)
    except ValueError as e:
        raise ValueError(f"K7: {e}") from None
    wk = packed_weight(w)
    # the affine and the bias in fp32, once per tensor as the pack (a bf16
    # UNet's are bf16: a cast each would be a launch a call)
    sc, bi, bk = (_cached(t, _fp32) for t in (scale, bias, b))
    if any(t.device != x.device for t in (wk, sc, bi, bk)) or \
            sc.numel() != cin or bi.numel() != cin or bk.numel() != cout:
        raise ValueError(f"K7: w, scale, bias [{cin}] and b [{cout}] must "
                         f"lie on x's device")
    dev = x.device
    out = torch.empty((bsz, cout, h, wd), dtype=x.dtype, device=dev)
    ypad = torch.empty((plan.positions, plan.cin8), dtype=torch.bfloat16,
                       device=dev)
    part = torch.empty(plan.splits * cout * plan.n if plan.splits > 1 else 1,
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(x.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                        wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                        ypad.data_ptr(), part.data_ptr(), bsz, cin, cout, h,
                        wd, groups, eps, plan_c, stream)
    if err != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {err}")
    return out


def _forward(x, scale, bias, w, b, groups, eps):
    """K7 on a CUDA tensor, its plain version on a CPU one."""
    if x.device.type == "cpu":
        return gn_silu_conv_reference(x, scale, bias, w, b, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"K7: unsupported device {x.device}")
    out = _launch(x, scale, bias, w, b, groups, eps)
    gn_silu_conv.launches += 1
    return out


class _FusedGnSiluConv(torch.autograd.Function):
    """K7 forward; the backward recomputes through
    :func:`gn_silu_conv_fallback` (``_bwd`` :120-125)."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, b, groups, eps):
        ctx.save_for_backward(x, scale, bias, w, b)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, scale, bias, w, b, groups, eps)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = gn_silu_conv_fallback(*leaves, ctx.groups, ctx.eps)
        return (*torch.autograd.grad(y, leaves, g), None, None)


def fused_gn_silu_conv(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """``conv3x3(silu(group_norm(x)·scale + bias), w) + b`` on K7,
    ``[B, Cout, H, W]`` in x's dtype; differentiable."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias, w, b)):
        return _FusedGnSiluConv.apply(x, scale, bias, w, b, groups, eps)
    return _forward(x, scale, bias, w, b, groups, eps)


def gn_silu_conv(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, groups: int = 32,
                 eps: float = 1e-5,
                 max_tile_bytes: int = MAX_TILE_BYTES) -> torch.Tensor:
    """The dispatch of ``gn_silu_conv`` (:131-142): K7 (or its plain
    version on the CPU) when the image fits ``max_tile_bytes``, else
    :func:`gn_silu_conv_fallback`, counted in ``gn_silu_conv.fallbacks``."""
    if takes_kernel(x, w.shape[0], max_tile_bytes):
        return fused_gn_silu_conv(x, scale, bias, w, b, groups, eps)
    gn_silu_conv.fallbacks += 1
    return gn_silu_conv_fallback(x, scale, bias, w, b, groups, eps)


gn_silu_conv.launches = 0
gn_silu_conv.fallbacks = 0
