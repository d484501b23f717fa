"""K4, K9 and K12: the int8 UNet's fused feed-forward.

K4 is the block of the fused-norms UNet,
``x + W2·q(h ⊙ gelu_tanh(gate))·s2 + b2`` with ``[h, gate] = W1·q(LN(x))``;
K12 the feed-forward alone of the UNet without fused norms,
``W2·q(h ⊙ gelu_tanh(gate))·s2`` with ``[h, gate] = W1·q(x)``, bf16 out,
no b2 and no residual (:func:`fused_geglu_s8`).

Counterpart of ``ldmseg_tpu/ops/pallas/geglu.py``: ``fused_geglu_ln_s8``
(:327) and its kernel ``_geglu_ln_kernel`` with ``_ff_interior`` (:164, :66,
``nc=1``) on the operands of ``pack_geglu_ln_tiles`` (:295).

:func:`geglu_ln_s8` dispatches as the JAX wrapper does (:351): ``T % 8`` or
``T % min(512, T)`` go to :func:`geglu_ln_s8_fallback`, the JAX package's
``_xla_geglu_ln_s8`` (exact erf gelu, one amax over the whole tensor),
counted in ``geglu_ln_s8.fallbacks``. Every other shape takes the kernel's
arithmetic: on a CUDA tensor the hand-written kernel ``csrc/geglu_ln_s8.cu``
(counted in ``geglu_ln_s8.launches``; an input it cannot take raises), on a
CPU tensor its plain PyTorch version :func:`geglu_ln_s8_reference`.

The interior scale is static when the site was calibrated (``gs``), else
dynamic: one amax per (image, block of ``min(512, T)`` tokens), the Pallas
grid's block, not per tensor as in the fallback.

K12 is the counterpart of ``fused_geglu_s8`` (:400) and its kernel
``_geglu_kernel`` (:123), with the same rule, fallback
(:func:`geglu_s8_fallback`, ``_xla_geglu_s8`` :377, counted in
``fused_geglu_s8.fallbacks``) and interior scales; its kernel is the second
entry point of ``csrc/geglu_ln_s8.cu`` (counted in
``fused_geglu_s8.launches``), its plain version :func:`geglu_s8_reference`.
The caller adds b2 in the activation dtype, the block the residual
(``unet.py:415``, ``:502``).

On a model axis (``parallel/tp.py``) K4 and K12 run on the pack of a
rank's GEGLU columns: ``w1`` holds its ``M/n`` h rows, then its ``M/n``
gate rows (the paired layout), ``w2 [C, M/n]`` with ``s2`` the scales of
whole rows (:func:`pack_geglu` reads them through ``quantize_rows``). Given
``group`` (the model group's reductions, ``parallel/tp.py:ModelGroup``:
``sum`` in fp32, ``max``), :func:`geglu_ln_s8` and :func:`fused_geglu_s8`
compute the rank's fp32 ``y·gs·s2`` alone, sum it over the group, then
add the residual and b2 (K4) or round (K12) where the one-rank kernel
does. A dynamic interior scale is one amax per (image, token block) over
all M columns: the group's maximum of the ranks' amaxes (on the card
between the kernel's two halves, ``ldmseg_geglu_s8_up`` and
``ldmseg_geglu_s8_down_partial``; one launch counted).

K9 is the counterpart of ``fused_geglu_ln_s8(..., proj_out=)`` (:327) and
its kernel ``_geglu_ln_pout_kernel`` (:186): K4 with Transformer2D's 1x1
``proj_out`` conv as a bf16 epilogue, ``bf16(bf16(K4(x))·Wpoᵀ + b_po)``
(:func:`geglu_ln_s8_pout`, third entry point of ``csrc/geglu_ln_s8.cu``,
counted in ``geglu_ln_s8_pout.launches``; plain version
:func:`geglu_ln_s8_pout_reference`): K4's kernels write ``r``, then the
Hopper product runs ``proj_out`` with its operands swapped, ``Wpo·rᵀ``, so
that its columns are tokens and its output is channel-major
(:func:`pout_plan`). K4's rule; its fallback
(:func:`geglu_ln_s8_pout_fallback`, counted) is K4's, rounded to x's dtype,
then the proj in fp32 on the float32 weight (:352-361). The result is the
Transformer2D's output before its outer residual, which the caller adds.
On a model axis K9 is K4's partial mode on a rank's columns (its two
launches, the group's amax between them), the group's sum finished into
the bf16 block output ``r`` (:func:`geglu_finish`), then the ``proj_out``
stage alone on ``r`` with the whole ``proj_out`` weight, gathered at
prepare time (``ldmseg_geglu_ln_s8_pout`` with ``proj_out_only`` 1; one
launch counted).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from . import _build
from .attention_s8 import _layer_norm, quantize_s8
from .attention import SM90_SMS
from .gemm import (DEEP_STAGES, SM90_SMEM_PER_SM, SM90_SMEM_RESERVED,
                   gemm_grid, gemm_smem_bytes, gemm_takes, plans_c,
                   sm90_gemm_plan)
from .quant import exact_int8_matmul, f32, quantize_rows, quantize_weight

BLOCK_T = 512
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class GegluPack:
    """K4's and K12's operands for one transformer block (float32 unless
    noted); K12's carry no LayerNorm."""

    xs: float              # the input's static int8 scale
    gs: Optional[float]    # the static interior scale, None = dynamic
    w1: torch.Tensor       # int8 [2M, C] (out, in): h rows, then gate rows
    s1: torch.Tensor       # [2M] per-output-channel scales
    b1: torch.Tensor       # [2M]
    w2: torch.Tensor       # int8 [C, M] (out, in)
    s2: torch.Tensor       # [C]
    b2: torch.Tensor       # [C]
    eps: Optional[float] = None          # K4's LayerNorm
    ln_w: Optional[torch.Tensor] = None  # [C]
    ln_b: Optional[torch.Tensor] = None  # [C]
    # K9's epilogue, Transformer2D's 1x1 proj_out (:func:`with_proj_out`)
    wpo: Optional[torch.Tensor] = None    # bf16 [C, C] (out, in)
    wpo_f: Optional[torch.Tensor] = None  # fp32, for the fallback
    bpo: Optional[torch.Tensor] = None    # [C]


def _vec(t):
    return t.detach().float().contiguous()


@torch.no_grad()
def pack_geglu(norm, proj_in, proj_out, xs: float,
               gs: Optional[float] = None) -> GegluPack:
    """Quantize a block's ``norm3`` (LayerNorm) and feed-forward
    ``proj_in``/``proj_out`` (Linear) float weights per output channel
    (``prequantize_conv_tree(quantize_ff=True)``, :223-235) and pack K4's
    operands (``pack_geglu_ln_tiles``); a row-parallel ``proj_out`` is
    quantized over its whole rows (``quantize_rows``)."""
    w1, s1 = quantize_weight(proj_in.weight, dims=(1,))
    w2, s2 = quantize_rows(proj_out)
    return GegluPack(
        eps=norm.eps, xs=f32(xs), gs=None if gs is None else f32(gs),
        ln_w=_vec(norm.weight), ln_b=_vec(norm.bias), w1=w1.contiguous(),
        s1=s1.contiguous(), b1=_vec(proj_in.bias), w2=w2.contiguous(),
        s2=s2.contiguous(), b2=_vec(proj_out.bias))


def pack_geglu_s8(proj_in, proj_out, src_proj_in, src_proj_out, xs: float,
                  gs: Optional[float] = None) -> GegluPack:
    """K12's operands from the prepared ``QuantLinear`` pair of an int8
    feed-forward (their codes and scales, shared, not copied) and the float
    biases of the masters' ``Linear`` pair."""
    return GegluPack(
        xs=f32(xs), gs=None if gs is None else f32(gs), w1=proj_in.w_q,
        s1=proj_in.w_scale, b1=_vec(src_proj_in.bias), w2=proj_out.w_q,
        s2=proj_out.w_scale, b2=_vec(src_proj_out.bias))


def takes_kernel(t: int) -> bool:
    """The JAX wrapper's shape rule (:351) without its CPU clause."""
    return not (t % 8 != 0 or t % min(BLOCK_T, t) != 0)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``geglu.py:_gelu_tanh`` in its operation order: ``x / (1 +
    exp(-2z))``, ``z = 0.7978845608028654·(x + 0.044715·x·x·x)``."""
    z = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    return x / (1.0 + torch.exp(-2.0 * z))


def _gated_interior(hn, p: GegluPack):
    x8 = quantize_s8(hn, torch.tensor(p.xs, device=hn.device))
    m = p.w2.shape[1]
    u = exact_int8_matmul(x8, p.w1).float() * (p.xs * p.s1) + p.b1
    return u[..., :m], u[..., m:]


def _kernel_interior(h, p: GegluPack, block_t: int,
                     group=None) -> torch.Tensor:
    """The kernels' interior on the float input ``h`` of W1 (K4: the LN
    output, K12: x): ``y = float(int32 g8·W2)·gs`` in fp32, ``[B, T, C]``.
    ``group``: the dynamic amaxes are the model group's maximum."""
    b, t, _ = h.shape
    uh, ug = _gated_interior(h, p)
    g = uh * gelu_tanh(ug)                                 # [B, T, M]
    if p.gs is not None:
        gs = torch.full((b, t, 1), p.gs, device=h.device)
    else:
        bt = min(block_t, t)
        amax = g.abs().reshape(b, t // bt, -1).amax(-1)    # [B, T / bt]
        if group is not None:
            amax = group.max(amax)
        gs = (amax.clamp_min(1e-6) / 127.0).repeat_interleave(bt, dim=1)
        gs = gs[..., None]
    g8 = torch.round(g / gs).clamp_(-127, 127).to(torch.int8)
    return exact_int8_matmul(g8, p.w2).float() * gs


def geglu_ln_s8_reference(x: torch.Tensor, p: GegluPack,
                          block_t: int = BLOCK_T, partial: bool = False,
                          group=None) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch (``[B, T, C]`` -> bf16): LN and
    quantize, ``u`` from the int32 product, the tanh-gelu gating, the
    interior quantized with ``gs`` (clipped) or with one dynamic amax per
    (image, ``min(block_t, T)``-token block), the int32 product with W2 and
    ``bf16(x + y·gs·s2 + b2)``; ``partial``: the fp32 ``y·gs·s2`` alone (a
    rank's columns, ``group`` the dynamic amaxes' maximum). The
    dynamic codes are clipped too, which changes nothing: ``|g| / gs <=
    127`` by construction."""
    xf = x.float()
    y = _kernel_interior(_layer_norm(xf, p.ln_w, p.ln_b, p.eps), p, block_t,
                         group)
    if partial:
        return y * p.s2
    return ((xf + y * p.s2) + p.b2).to(torch.bfloat16)


def geglu_s8_reference(x: torch.Tensor, p: GegluPack,
                       block_t: int = BLOCK_T, partial: bool = False,
                       group=None) -> torch.Tensor:
    """K12's arithmetic in plain PyTorch: K4's without the LayerNorm, b2
    and the residual, ``bf16(y·gs·s2)``; ``partial`` as there."""
    y = _kernel_interior(x.float(), p, block_t, group) * p.s2
    return y if partial else y.to(torch.bfloat16)


def _gelu_exact(x):
    return x * 0.5 * (1.0 + torch.erf(x / np.float32(np.sqrt(2.0))))


def geglu_s8_fallback(x: torch.Tensor, p: GegluPack, partial: bool = False,
                      group=None) -> torch.Tensor:
    """``_xla_geglu_s8`` (:377) for the shapes K12 does not take: the exact
    erf gelu, one interior amax over the whole tensor when dynamic (its
    codes unclipped, as there), the result in the input dtype, no b2;
    ``partial``: fp32, a rank's columns (``group`` as in
    :func:`geglu_s8_reference`)."""
    uh, ug = _gated_interior(x.float(), p)
    g = uh * _gelu_exact(ug)
    if p.gs is not None:
        gs = p.gs
        g8 = torch.round(g / gs).clamp_(-127, 127)
    else:
        amax = g.abs().amax()
        if group is not None:
            amax = group.max(amax)
        gs = amax.clamp_min(1e-6) / 127.0
        g8 = torch.round(g / gs)
    y = exact_int8_matmul(g8.to(torch.int8), p.w2).float() * (gs * p.s2)
    return y if partial else y.to(x.dtype)


def geglu_ln_s8_fallback(x: torch.Tensor, p: GegluPack, partial: bool = False,
                         group=None) -> torch.Tensor:
    """``_xla_geglu_ln_s8`` (:281) with ``_xla_geglu_s8`` (:377) for the
    shapes K4 does not take: LN in the input dtype, then
    :func:`geglu_s8_fallback`, then the residual and bias in fp32;
    ``partial`` as there."""
    xf = x.float()
    h = _layer_norm(xf, p.ln_w, p.ln_b, p.eps).to(x.dtype)
    if partial:
        return geglu_s8_fallback(h, p, True, group)
    return (xf + geglu_s8_fallback(h, p).float() + p.b2).to(x.dtype)


def geglu_finish(x: torch.Tensor, y: torch.Tensor, p: GegluPack,
                 block: bool, fallback: bool) -> torch.Tensor:
    """The output from the fp32 ``y·gs·s2`` (on a model axis the sum of the
    ranks' partials), in x's dtype, rounded where the one-rank path rounds:
    K4 (``block``) ``bf16(x + y + b2)``, its fallback the FF rounded to x's
    dtype first; K12 ``bf16(y)``, its fallback ``y`` in x's dtype."""
    if fallback:
        y = y.to(x.dtype)
        return (x.float() + y.float() + p.b2).to(x.dtype) if block else y
    if block:
        y = (x.float() + y) + p.b2
    return y.to(torch.bfloat16).to(x.dtype)


def geglu_plans(b: int, t: int, c: int, m: int) -> tuple:
    """The launch plans of K4's and K12's two int8 products on Hopper: up
    (``[B·T, C]·[M, C]ᵀ`` with two W1 tiles per stage, the h and the gate
    rows) and down (``[B·T, M]·[C, M]ᵀ``). Raises ``ValueError`` on a shape
    the products do not take (C and M multiples of 16: a row of x8 and of
    g8 is a tensor map's stride)."""
    if not (gemm_takes(m, c, "int8") and gemm_takes(c, m, "int8")):
        raise ValueError(f"C={c}, M={m} must be multiples of 16 (the rows "
                         f"of the int8 products' operands)")
    rows = b * t
    return (sm90_gemm_plan(rows, m, c, "int8", operands=2),
            sm90_gemm_plan(rows, c, m, "int8"))


POUT_TILE = (64, 64)


def pout_plan(b: int, t: int, c: int):
    """The launch plan of K9's ``proj_out`` on Hopper: the bf16 product with
    its operands swapped, ``Wpo [C, C]·r [B·T, C]ᵀ`` (rows: output
    channels, columns: tokens), so that an accumulator pair is two tokens of
    one image and the store is channel-major. The smallest tile,
    :data:`POUT_TILE`, for the most blocks (at T = 128 and 32, C = 1,280,
    Wpo's 3.3 MB bound it), and the deepest ring up to ``DEEP_STAGES``
    with which every block is resident at once (three 4-stage blocks share
    an SM, one 8-stage block fills one). A sweep of the four tiles and of
    two to eight stages at the int8 path's shapes (NVIDIA H100 80GB HBM3,
    700 W) put this rule within 2% of the best at each."""
    blocks = math.prod(gemm_grid(c, b * t, *POUT_TILE))
    k_tiles = -(-c // 64)

    def resident(stages):
        per_sm = SM90_SMEM_PER_SM // (gemm_smem_bytes(*POUT_TILE, 1, stages)
                                      + SM90_SMEM_RESERVED)
        return SM90_SMS * per_sm
    deepest = max(2, min(DEEP_STAGES, k_tiles))
    stages = next((s for s in range(deepest, 1, -1) if resident(s) >= blocks),
                  deepest)
    return sm90_gemm_plan(c, b * t, c, "bfloat16", max_stages=stages,
                          tile=POUT_TILE)


@functools.lru_cache(maxsize=None)
def _plans_c(b: int, t: int, c: int, m: int, pout: bool = False):
    return plans_c(*geglu_plans(b, t, c, m),
                   *((pout_plan(b, t, c),) if pout else ()))


@functools.lru_cache(maxsize=None)
def _half_plans_c(b: int, t: int, c: int, m: int):
    """The up and the down product's plans apart, for a rank's columns'
    two launches."""
    return tuple(plans_c(plan) for plan in geglu_plans(b, t, c, m))


@functools.cache
def _kernel(entry: str):
    fn = getattr(_build.load("geglu_ln_s8"), entry)
    tail = [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]  # plans, stream
    if entry == "ldmseg_geglu_ln_s8":   # K4
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_float] + tail)
    elif entry == "ldmseg_geglu_ln_s8_pout":   # K9, or its proj_out alone
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 17
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int]
                       + tail)
    elif entry == "ldmseg_geglu_s8":    # K12
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_int] + tail)
    elif entry == "ldmseg_geglu_s8_up":  # a rank's columns: the first half
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_int, ctypes.c_float] + tail)
    else:                               # the second half, the fp32 partial
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int] + tail)
    fn.restype = ctypes.c_int
    return fn


def _geglu(x: torch.Tensor, p: GegluPack, block: bool, group,
           counter) -> torch.Tensor:
    """K4 (``block``) or K12 by the shape rule, on one rank or (``group``)
    on a rank's columns."""
    if not takes_kernel(x.shape[1]):
        counter.fallbacks += 1
        fallback = geglu_ln_s8_fallback if block else geglu_s8_fallback
        if group is None:
            return fallback(x, p)
        part = fallback(x, p, True, group)
        return geglu_finish(x, group.sum(part), p, block, fallback=True)
    if x.device.type == "cpu":
        ref = geglu_ln_s8_reference if block else geglu_s8_reference
        if group is None:
            return ref(x, p).to(x.dtype)
        part = ref(x, p, partial=True, group=group)
    elif x.device.type != "cuda":
        raise ValueError(f"{'K4' if block else 'K12'}: unsupported device "
                         f"{x.device}")
    else:
        out = _launch(x, p, block=block, group=group)
        counter.launches += 1
        if group is None:
            return out.to(x.dtype)
        part = out
    return geglu_finish(x, group.sum(part), p, block, fallback=False)


def _launch(x: torch.Tensor, p: GegluPack, block: bool,
            pout: bool = False, group=None) -> torch.Tensor:
    """K4 (``block``: LN, residual and b2), K9 (``pout`` too: the proj_out
    epilogue, the result channel-major ``[B, C, T]`` seen as ``[B, T, C]``)
    or K12 on the card. With ``group`` (K4 or K12 on a rank's GEGLU
    columns) the fp32 ``y·gs·s2`` alone, in two launches
    (``ldmseg_geglu_s8_up``, then ``ldmseg_geglu_s8_down_partial``), a
    dynamic scale's amax slots taking ``group.max`` between them (the slots
    hold non-negative floats' bits, which order as the floats)."""
    name = "K9" if pout else ("K4" if block else "K12")
    b, t, c = x.shape
    m = p.w2.shape[1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    try:
        plans = (_half_plans_c(b, t, c, m) if group is not None
                 else _plans_c(b, t, c, m, pout))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    bt = min(BLOCK_T, t)
    x = x.contiguous()
    ops = ((p.w1, p.s1, p.b1, p.w2, p.s2, p.b2)
           + ((p.ln_w, p.ln_b) if block else ())
           + ((p.wpo, p.bpo) if pout else ()))
    if any(o is None or o.device != x.device or not o.is_contiguous()
           for o in ops):
        raise ValueError(f"{name}: the pack must be contiguous on x's "
                         f"device{' and carry proj_out' if pout else ''}")
    dev = x.device
    out = torch.empty((b, c, t) if pout else (b, t, c),
                      dtype=torch.bfloat16 if group is None
                      else torch.float32, device=dev)
    x8 = torch.empty((b * t, c), dtype=torch.int8, device=dev)
    dynamic = p.gs is None
    # g (fp32) only with the dynamic scale: the static one quantizes in
    # the up product's epilogue
    g = torch.empty((b * t, m) if dynamic else (0,), dtype=torch.float32,
                    device=dev)
    g8 = torch.empty((b * t, m), dtype=torch.int8, device=dev)
    amax = torch.empty(b * (t // bt), dtype=torch.int32, device=dev)
    gs = 0.0 if dynamic else p.gs
    scratch = (x8.data_ptr(), g.data_ptr(), g8.data_ptr(), amax.data_ptr(),
               b, t, c, m, bt, p.xs, gs, int(dynamic))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if group is not None:
            err = _kernel("ldmseg_geglu_s8_up")(
                _DTYPE_CODE[x.dtype], int(block), x.data_ptr(),
                p.ln_w.data_ptr() if block else None,
                p.ln_b.data_ptr() if block else None, p.w1.data_ptr(),
                p.s1.data_ptr(), p.b1.data_ptr(), x8.data_ptr(),
                g.data_ptr(), g8.data_ptr(), amax.data_ptr(), b, t, c, m, bt,
                p.xs, gs, int(dynamic), p.eps if block else 0.0, plans[0],
                stream)
            if err == 0 and dynamic:
                amax.copy_(group.max(amax))
            if err == 0:
                err = _kernel("ldmseg_geglu_s8_down_partial")(
                    g.data_ptr(), g8.data_ptr(), amax.data_ptr(),
                    p.w2.data_ptr(), p.s2.data_ptr(), out.data_ptr(), b, t,
                    c, m, bt, gs, int(dynamic), plans[1], stream)
        elif pout:
            r = torch.empty((b * t, c), dtype=torch.bfloat16, device=dev)
            err = _kernel("ldmseg_geglu_ln_s8_pout")(
                _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
                p.ln_w.data_ptr(), p.ln_b.data_ptr(), p.w1.data_ptr(),
                p.s1.data_ptr(), p.b1.data_ptr(), p.w2.data_ptr(),
                p.s2.data_ptr(), p.b2.data_ptr(), p.wpo.data_ptr(),
                p.bpo.data_ptr(), r.data_ptr(), *scratch, p.eps, 0, plans,
                stream)
        elif block:
            err = _kernel("ldmseg_geglu_ln_s8")(
                _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
                p.ln_w.data_ptr(), p.ln_b.data_ptr(), p.w1.data_ptr(),
                p.s1.data_ptr(), p.b1.data_ptr(), p.w2.data_ptr(),
                p.s2.data_ptr(), p.b2.data_ptr(), *scratch, p.eps, plans,
                stream)
        else:
            err = _kernel("ldmseg_geglu_s8")(
                _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
                p.w1.data_ptr(), p.s1.data_ptr(), p.b1.data_ptr(),
                p.w2.data_ptr(), p.s2.data_ptr(), *scratch, plans, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out.transpose(1, 2) if pout else out


def geglu_ln_s8(x: torch.Tensor, p: GegluPack, group=None) -> torch.Tensor:
    """``x + FF(LN(x))`` for ``x [B, T, C]``, returned in ``x``'s dtype.
    With ``group`` (a model axis: ``p`` holds this rank's columns) the
    rank's fp32 FF output is summed over the group before the residual and
    b2, and a dynamic interior amax is the group's maximum."""
    return _geglu(x, p, True, group, geglu_ln_s8)


geglu_ln_s8.launches = 0
geglu_ln_s8.fallbacks = 0


def fused_geglu_s8(x: torch.Tensor, p: GegluPack,
                   group=None) -> torch.Tensor:
    """``FF(x)`` without b2 for ``x [B, T, C]``, returned in ``x``'s dtype
    (the kernel's result is bf16, cast as the JAX wrapper casts it);
    ``group`` as in :func:`geglu_ln_s8`."""
    return _geglu(x, p, False, group, fused_geglu_s8)


fused_geglu_s8.launches = 0
fused_geglu_s8.fallbacks = 0


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------
@torch.no_grad()
def with_proj_out(p: GegluPack, conv) -> GegluPack:
    """K9's pack: K4's ``p`` with Transformer2D's 1x1 ``proj_out`` conv
    (``pack_inference_tiles(fuse_projs=True)`` with the wrapper's
    ``proj_out[0].astype(bf16)``): the float32 weight ``[C_out, C_in]``
    cast to bf16 for the kernel and kept in float32 for the fallback, the
    bias in float32 (``g`` row 3). On a model axis ``conv`` is the whole
    layer (``parallel/tp.py:whole_layer``) and ``p`` a rank's columns."""
    w = conv.weight.detach().float().reshape(conv.weight.shape[0], -1)
    return dataclasses.replace(
        p, wpo=w.to(torch.bfloat16).contiguous(), wpo_f=w.contiguous(),
        bpo=_vec(conv.bias))


def proj_out_reference(r: torch.Tensor, p: GegluPack) -> torch.Tensor:
    """K9's ``proj_out`` stage in plain PyTorch: ``bf16(float(r)·
    float(Wpo)ᵀ + b_po)`` with fp32 sums, ``r`` the block's output."""
    return (r.float() @ p.wpo.float().t() + p.bpo).to(torch.bfloat16)


def geglu_ln_s8_pout_reference(x: torch.Tensor, p: GegluPack,
                               block_t: int = BLOCK_T) -> torch.Tensor:
    """K9's arithmetic in plain PyTorch (``[B, T, C]`` -> bf16): K4's
    output rounded to bf16 (:func:`geglu_ln_s8_reference`), then
    :func:`proj_out_reference`."""
    return proj_out_reference(geglu_ln_s8_reference(x, p, block_t), p)


def geglu_ln_s8_pout_fallback(x: torch.Tensor, p: GegluPack,
                              group=None) -> torch.Tensor:
    """The JAX wrapper's branch with ``proj_out`` for the shapes K9 does
    not take (:352-361): :func:`geglu_ln_s8_fallback` (in x's dtype; with
    ``group`` its partial over a rank's columns, summed, then finished),
    then the proj in fp32 on the float32 weight plus the bias, rounded to
    x's dtype."""
    if group is None:
        r = geglu_ln_s8_fallback(x, p)
    else:
        r = geglu_finish(x, group.sum(geglu_ln_s8_fallback(x, p, True,
                                                           group)),
                         p, True, fallback=True)
    return (r.float() @ p.wpo_f.t() + p.bpo).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _pout_plan_c(b: int, t: int, c: int):
    return plans_c(pout_plan(b, t, c))


def _proj_out_launch(r: torch.Tensor, p: GegluPack) -> torch.Tensor:
    """K9's ``proj_out`` stage alone on the card (``proj_out_only`` 1):
    the bf16 block output ``r [B, T, C]`` -> ``bf16(r·Wpoᵀ + b_po)`` as the
    tokens view of a channel-major ``[B, C, T]``."""
    b, t, c = r.shape
    r = r.to(torch.bfloat16).contiguous()
    if any(o is None or o.device != r.device or not o.is_contiguous()
           for o in (p.wpo, p.bpo)):
        raise ValueError("K9: the pack must carry proj_out, contiguous on "
                         "x's device")
    try:
        plan = _pout_plan_c(b, t, c)
    except ValueError as e:
        raise ValueError(f"K9: {e}") from None
    out = torch.empty((b, c, t), dtype=torch.bfloat16, device=r.device)
    with torch.cuda.device(r.device):
        err = _kernel("ldmseg_geglu_ln_s8_pout")(
            1, None, out.data_ptr(), None, None, None, None, None, None, None,
            None, p.wpo.data_ptr(), p.bpo.data_ptr(), r.data_ptr(), None,
            None, None, None, b, t, c, 0, 0, 0.0, 0.0, 0, 0.0, 1, plan,
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K9 proj_out launch failed: CUDA error {err}")
    return out.transpose(1, 2)


def geglu_ln_s8_pout(x: torch.Tensor, p: GegluPack,
                     group=None) -> torch.Tensor:
    """K9: ``proj_out(x + FF(LN(x))) + b_po`` for ``x [B, T, C]`` (the
    Transformer2D's output before its outer residual), in ``x``'s dtype.
    On the card the result is the tokens view of a channel-major ``[B, C,
    T]`` tensor: the NCHW layout of the residual add. With ``group`` (a
    model axis: ``p`` holds this rank's GEGLU columns and the whole
    ``proj_out``) the ranks' FF partials are summed and rounded into the
    block output ``r`` first (``proj_out`` reads every channel of it)."""
    if not takes_kernel(x.shape[1]):
        geglu_ln_s8_pout.fallbacks += 1
        return geglu_ln_s8_pout_fallback(x, p, group)
    if x.device.type == "cpu":
        if group is None:
            return geglu_ln_s8_pout_reference(x, p).to(x.dtype)
        part = geglu_ln_s8_reference(x, p, partial=True, group=group)
        r = geglu_finish(x, group.sum(part), p, True, fallback=False)
        return proj_out_reference(r, p).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K9: unsupported device {x.device}")
    if group is None:
        out = _launch(x, p, block=True, pout=True)
    else:
        part = _launch(x, p, block=True, group=group)
        r = geglu_finish(x, group.sum(part), p, True, fallback=False)
        out = _proj_out_launch(r, p)
    geglu_ln_s8_pout.launches += 1
    return out.to(x.dtype)


geglu_ln_s8_pout.launches = 0
geglu_ln_s8_pout.fallbacks = 0
