"""K3, K8, K10, K11, K13, K15, K17 and K18: the int8 UNet's self-attention.

K3 is the fused block of the fused-norms UNet,
``x + to_out(attention(LN(x))) + b_out`` on ``[B, T, C]`` tokens; K8 the
same block behind Transformer2D's 1x1 ``proj_in`` as a bf16 prologue
(``use_fused_projs``, :func:`ln_attention_s8_pin`); K13 the int8 attention
alone of the UNet without fused norms, on the float projections' ``[B, T,
H, D]`` q, k and v (:func:`fused_self_attention_s8`); K11 the padded
attention of ``use_padded_attention`` without fused norms, int8
projections, attention and ``to_out`` on ``[B, T, C]``
(:func:`padded_attention_s8`).

Counterpart of ``ldmseg_tpu/ops/pallas/attention.py``:
``absorbed_padded_ln_self_attention_s8`` (:1070) with its defaults
``v_bf16=True, v_transposed=True``, whose kernel is
``_attn_kernel_abs_padded_ln_s8_vt``/``_abs_padded_ln_s8_vt_body`` (:845,
:895) on the operands of ``pack_padded_ln_vt_tiles`` (:1032).

:func:`ln_attention_s8` dispatches as the JAX wrapper does (:1105): a shape
that rule sends away (``T > 2048``, ``T % 8``, ``C % heads`` or ``d % 8``)
goes to :func:`ln_attention_s8_fallback`, the JAX package's float math,
counted in ``ln_attention_s8.fallbacks``. Every other shape takes the
kernel's arithmetic: on a CUDA tensor the hand-written kernel
``csrc/attention_ln_s8.cu`` (counted in ``ln_attention_s8.launches``; an
input it cannot take raises), on a CPU tensor its plain PyTorch version
:func:`ln_attention_s8_reference`.

The operands are packed once per sampling call from the float weights
(:func:`pack_ln_attention`, the port's ``pack_padded_ln_vt_tiles``). The
TPU layout tricks (128-lane head padding, the K-major Vᵀ, the ones-rows
that give the softmax denominator) are not carried over; the values the
kernel computes with are: the per-column Q/K requant factors
``w_scale·(xs/as)``, ``as²·d^-0.5``, the per-head V dequant ``w_scale·xs``,
``to_out`` dequantized to bf16 per head, the LN and bias rows.

On a model axis (``parallel/tp.py``) K3 runs on the pack of a rank's
heads: ``w_qkv [3ci, C]`` and ``wo [C, ci]`` with ``ci = heads_local·d``;
the LayerNorm and x8 stay over the whole replicated C. Given ``group``
(the model group's reductions, ``parallel/tp.py:ModelGroup``: ``sum`` in
fp32, ``max``), :func:`ln_attention_s8` computes the rank's fp32 ``to_out``
product alone (the kernel's ``ldmseg_attention_ln_s8`` with ``partial`` 1,
the plain version's and the fallback's ``partial``), sums it over the
group and then adds the residual and the bias and rounds once, where the
one-rank block rounds. K8 (:func:`ln_attention_s8_pin`) does the same on
the fp32 residual stream ``xf`` that its prologue builds from the whole
``proj_in`` (gathered at prepare time: the LayerNorm reads all C), the
finish ``bf16(xf + sum + b_out)``. K11 (:func:`padded_attention_s8`) takes
a pack of a rank's heads whose ``out_scale`` and ``ratio`` use the group's
``max(wos)``, writes the int32 ``of8·Wo8`` of those heads unscaled, sums
it over the group exactly (``group.sum_exact``) and rounds
``bf16(float(sum)·out_scale)`` as the one-rank kernel does: bit for bit
one rank's. K13 takes a rank's ``[B, T, H/n, d]`` q, k and v as they
are; its dynamic scales take the group's maximum of each tensor's amax.
So do K15's, on a rank's ``[B, T, C/n]``: with ``group`` its launch splits
in two (``ldmseg_attention_packed_s8`` stage 1, the amax bits, and 2,
the scales and the attention), ``group.max`` between them, so that the scales
equal one rank's bit for bit. K17 takes the pack of a rank's heads
(``w_qkv [3ci, C]``, ``wo_q [C, ci]``, ``w_scale [4, H/n]``, ``wo_p [C,
(H/n)·dp]``: its scales are per (image, head) and x's is static, so a rank
needs nothing of the others) and with ``partial`` writes its fp32
``to_out`` sum over them (``ldmseg_attention_absorbed_s8``, ``partial``
1), which
the caller sums over the group and rounds once to bf16.

K13 is the counterpart of ``fused_self_attention_s8`` (:104) and its kernel
``_attn_kernel_s8`` (:47). It keeps the wrapper's shape rule (``T > 4096``,
``T % min(1024, T)`` or ``T % 8`` go to the float ``_xla_bthd``, :1420,
counted in ``fused_self_attention_s8.fallbacks``): at KITTI's 24x80 latent
the T = 1920 and T = 30 sites take float attention, unquantized, as in JAX;
at 32x64 every site takes the kernel. Other shapes quantize q, k and v with
the static ``act_scale`` or one dynamic amax each, then a CUDA tensor goes
to ``csrc/attention_s8.cu`` (which quantizes too; counted in
``fused_self_attention_s8.launches``) and a CPU tensor to
:func:`attention_s8_reference`.

K8 (``absorbed_padded_ln_self_attention_s8(..., proj_in=)``, :1070-1135,
kernel ``_attn_kernel_abs_padded_ln_s8_vt_pin`` :875) keeps K3's rule; its
fallback (:func:`ln_attention_s8_pin_fallback`) projects in fp32 on the
float32 weight, rounds to x's dtype and takes K3's; its pack is K3's with
the ``proj_in`` weight in bf16 and the bias (:func:`with_proj_in`). On the
card its prologue ``xf = x·Wpiᵀ + b_pi`` (fp32, never rounded) runs on the
Hopper product (``csrc/gemm_sm90.cuh``), reading x as tokens or, where x is
the tokens view of the GroupNorm's NCHW output, channel-major as it lies
(plans from :func:`pin_plans`; alone, :func:`proj_in_f32`). K11
(``absorbed_padded_self_attention_s8`` :1226, kernel
``_attn_kernel_abs_padded_s8`` :646) keeps the same rule; its fallback
(:func:`padded_attention_s8_fallback`) is the float attention on the
dequantized weights; every other shape quantizes x once with the static
scale, a true division, and a CUDA tensor goes to the second entry point
of ``csrc/attention_s8.cu`` (counted in ``padded_attention_s8.launches``)
and a CPU tensor to :func:`padded_attention_s8_reference`. Its operands
(:func:`pack_padded_attention`) are ``quantize_head_weights``' codes and
the scales of ``_abs_padded_prep`` (:1161).

K15 (``fused_self_attention_packed_s8`` :210, kernel ``_attn_kernel_btc_s8``
:142) is ``use_packed_attention``'s int8 attention on the float
projections' ``[B, T, C]``: K13's arithmetic on the head view, always with
one dynamic amax per tensor (the wrapper has no ``act_scale``). It keeps
its wrapper's rule, K14's (``T > 2048``, ``T % 8`` or ``C % heads`` go to
the float ``_xla_btc``, unquantized, counted in
``fused_self_attention_packed_s8.fallbacks``); every other shape goes on a
CUDA tensor to the third entry point of ``csrc/attention_s8.cu`` (which
computes the three scales on the card too) and on a CPU tensor to
:func:`fused_self_attention_s8_reference` on the view.

K10 (``absorbed_padded_ln_self_attention_s8(..., v_transposed=False)`` or
``v_bf16=False``, :1140-1158; kernel ``_attn_kernel_abs_padded_ln_s8``
:716) is an op: no module reaches it. :func:`ln_attention_s8_rowmajor`
keeps K3's rule and fallback; ``v_bf16=True`` is K3's function in the
row-major layout (``csrc/attention_ln_s8.cu``'s last entry point, K3's
kernels and pack), ``v_bf16=False`` K11's int8 attention behind the LN with
the residual and bias epilogue (``csrc/attention_s8.cu``'s fourth entry
point); both packs come from :func:`pack_ln_attention_rowmajor`.

K17 (``absorbed_self_attention_s8`` :473, kernel ``_attn_kernel_absorbed_s8``
:360) is ``use_absorbed_attention``'s int8 attention: x quantized once with a
static scale, int8 projections with weight scales per head, dynamic scales
per (image, head) for q, k, v and the attention output, ``to_out`` summed
per head in fp32. K18 (``absorbed_fullc_self_attention_s8`` :619, kernel
``_attn_kernel_absorbed_fullc_s8`` :500) is an op: no module reaches it; it
is K17 with one weight scale per tensor (``quantize_fullc_weights``) and the
projections' dynamic scales per image. Both keep K16's rule (``T > 2048``,
``T % 8``, ``C % heads`` or ``d % 8`` go to
:func:`absorbed_attention_s8_fallback`, float attention on the dequantized
weights, counted in ``.fallbacks``); every other shape goes on a CUDA tensor
to ``csrc/attention_s8.cu``'s last two entry points (counted in
``.launches``) and on a CPU tensor to :func:`absorbed_attention_s8_reference`.
Their weights are ``[C, C]`` int8 codes in the ``Linear`` layout, the three
projections stacked ``[3C, C]`` (q, k, v rows), with scales ``[4, H]`` (K17)
or ``[4]`` (K18).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .attention import (SM90_HEAD_CLASSES, SM90_MAX_STAGES,
                        SM90_SMEM_LIMIT, SM90_SMS, absorbed_takes_kernel,
                        packed_attention_fallback, packed_takes_kernel,
                        sm90_forward_tiles, sm90_smem_bytes)
from .gemm import gemm_takes, plans_c, sm90_gemm_plan
from .quant import exact_int8_matmul, f32, quantize_head_weights

ATTN_SCALE = 0.1    # the static q/k/v scale ``as`` (pack_inference_tiles)
S8_MAX_SEQ = 4096   # fused_self_attention_s8's max_seq
S8_BLOCK_Q = 1024   # and its block_q
LN127 = 4.844187086458591  # ln 127: the row max of e is 127
MAX_HEAD_DIM = 160  # the largest head dim the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class LNAttentionPack:
    """K3's operands for one transformer block (float32 unless noted)."""

    heads: int
    eps: float
    xs: float             # the input's static int8 scale
    score_scale: float    # as² · d^-0.5
    ln_w: torch.Tensor    # [C]
    ln_b: torch.Tensor    # [C]
    out_b: torch.Tensor   # [C] to_out bias
    w_qkv: torch.Tensor   # int8 [3C, C]: to_q, to_k, to_v rows (out, in)
    m_qkv: torch.Tensor   # [3C]: q, k requant and v dequant per column
    wo: torch.Tensor      # bf16 [C, C] (out, in), dequantized per head
    wo_q: torch.Tensor    # int8 [C, C] (out, in), for the fallback
    w_scale: torch.Tensor  # [4, H] per-head scales of q, k, v, o
    # (on a model axis: ``heads`` this rank's, 3ci rows of w_qkv and m_qkv,
    # ci columns of wo and wo_q, ci = heads·d)
    # K8's prologue, Transformer2D's 1x1 proj_in (:func:`with_proj_in`)
    wpi: Optional[torch.Tensor] = None    # bf16 [C, C] (out, in)
    wpi_f: Optional[torch.Tensor] = None  # fp32, for the fallback
    bpi: Optional[torch.Tensor] = None    # [C]


@torch.no_grad()
def pack_ln_attention(norm, attn, heads: int, xs: float,
                      attn_scale: float = ATTN_SCALE) -> LNAttentionPack:
    """Quantize a block's ``norm1`` (LayerNorm) and ``attn1``
    (CrossAttention) float weights and pack K3's operands, in the JAX
    package's float32 order (``quantize_head_weights``, ``_abs_padded_prep``
    :1161, ``pack_padded_ln_vt_tiles``). ``heads`` is the block's; where
    ``attn1`` holds a rank's heads (tensor parallelism: ``to_q`` ``[ci,
    C]``) the pack holds them, ``ci / d`` of them."""
    wq, wk, wv = (p.weight for p in (attn.to_q, attn.to_k, attn.to_v))
    to_out = attn.to_out[0]
    d = wq.shape[1] // heads
    heads = wq.shape[0] // d
    q8, k8, v8, o8, scales = quantize_head_weights(wq, wk, wv,
                                                   to_out.weight, heads)
    xs32, as32 = np.float32(xs), np.float32(attn_scale)
    ratio = float(xs32 / as32)
    per_col = scales.repeat_interleave(d, dim=1)          # [4, C]
    m_qkv = torch.cat([per_col[0] * ratio, per_col[1] * ratio,
                       per_col[2] * float(xs32)])
    wo = (o8.float() * per_col[3][None, :]).to(torch.bfloat16)
    score = np.float32(as32 * as32) * np.float32(d ** -0.5)
    return LNAttentionPack(
        heads=heads, eps=norm.eps, xs=float(xs32), score_scale=float(score),
        ln_w=norm.weight.detach().float().contiguous(),
        ln_b=norm.bias.detach().float().contiguous(),
        out_b=to_out.bias.detach().float().contiguous(),
        w_qkv=torch.cat([q8, k8, v8]).contiguous(),
        m_qkv=m_qkv.contiguous(), wo=wo.contiguous(), wo_q=o8.contiguous(),
        w_scale=scales.contiguous())


def _layer_norm(xf, w, b, eps):
    """LayerNorm in fp32 in the kernels' order: mean, the mean of the
    centred squares, ``(x - mu) * rsqrt(var + eps) * w + b``."""
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * w + b


def ln_quant_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       xs: float, eps: float) -> torch.Tensor:
    """The int8 blocks' LN + quantize stage in plain PyTorch: x8 =
    ``clip(rint(_layer_norm(float(x)) / xs))``, a true division."""
    hn = _layer_norm(x.float(), w, b, eps)
    return quantize_s8(hn, torch.tensor(xs, device=x.device))


@functools.cache
def _ln_quant_kernel():
    fn = _build.load("attention_ln_s8").ldmseg_ln_quant_s8
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ln_quant_s8(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                xs: float, eps: float, stats: bool = False):
    """The LN + quantize stage that K3, K4, K8, K9 and K10 run first
    (``csrc/s8_common.cuh:ln_quant_kernel``), alone: ``x [..., C]`` -> x8
    int8 of its shape; with ``stats`` also each row's ``(mu, var, r)`` fp32
    ``[rows, 3]``. An op: no model path calls it; the tests and
    ``chip_smoke.py`` hold its codes against :func:`ln_quant_reference`. A
    CPU tensor takes that plain version (its statistics with ``stats``), a
    CUDA tensor the kernel (counted in ``ln_quant_s8.launches``)."""
    c = x.shape[-1]
    if x.device.type == "cpu":
        x8 = ln_quant_reference(x, w, b, xs, eps)
        if not stats:
            return x8
        xf = x.float().reshape(-1, c)
        mu = xf.mean(-1)
        var = ((xf - mu[:, None]) ** 2).mean(-1)
        return x8, torch.stack([mu, var, torch.rsqrt(var + eps)], -1)
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(f"ln_quant_s8: x must be contiguous float32 or "
                         f"bfloat16, got {x.dtype}")
    if any(t.dtype != torch.float32 or t.shape != (c,) or t.device !=
           x.device or not t.is_contiguous() for t in (w, b)):
        raise ValueError(f"ln_quant_s8: w and b must be fp32 [{c}] on x's "
                         f"device")
    rows = x.numel() // c
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    st = (torch.empty((rows, 3), dtype=torch.float32, device=x.device)
          if stats else None)
    with torch.cuda.device(x.device):
        err = _ln_quant_kernel()(
            _DTYPE_CODE[x.dtype], x.data_ptr(), x8.data_ptr(), w.data_ptr(),
            b.data_ptr(), None if st is None else st.data_ptr(), rows, c, xs,
            eps, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ln_quant_s8 launch failed: CUDA error {err}")
    ln_quant_s8.launches += 1
    return (x8, st) if stats else x8


ln_quant_s8.launches = 0


def ln_attention_s8_reference(x: torch.Tensor, p: LNAttentionPack,
                              static_offset: Optional[float] = None,
                              partial: bool = False) -> torch.Tensor:
    """K3's arithmetic in plain PyTorch (``[B, T, C]`` -> bf16): the LN and
    quantize, the int8 projections with int32 sums, the per-column requant
    of q and k and the bf16 v, per head ``p = bf16(exp(s - rowmax))``,
    ``o = bf16((p·v) / Σp)`` with both sums over the rounded p in fp32, and
    ``bf16(x + o·Wo + b_out)`` with fp32 sums; ``partial``: the fp32
    ``o·Wo`` alone (a rank's heads). ``static_offset`` swaps the row max
    for the TPU kernel's form, ``exp(min(s - offset, 80))`` (:939-941), to
    compare with it; the kernel has no such option."""
    b, t, c = x.shape
    h = p.heads
    ci = p.w_qkv.shape[0] // 3
    d = ci // h
    xf = x.float()
    x8 = ln_quant_reference(xf, p.ln_w, p.ln_b, p.xs, p.eps)
    y = exact_int8_matmul(x8, p.w_qkv).float() * p.m_qkv     # [B, T, 3ci]
    q8, k8 = (torch.round(y[..., i * ci:(i + 1) * ci]).clamp_(-127, 127)
              .to(torch.int8) for i in range(2))
    v = y[..., 2 * ci:].to(torch.bfloat16)

    def heads_of(z):
        return z.reshape(b, t, h, d).transpose(1, 2)          # [B, H, T, d]

    s = exact_int8_matmul(heads_of(q8), heads_of(k8)).float() * p.score_scale
    if static_offset is None:
        s = s - s.amax(-1, keepdim=True)
    else:
        s = (s - static_offset).clamp_max(80.0)
    e = torch.exp(s).to(torch.bfloat16).float()
    o = (e @ heads_of(v).float()) / e.sum(-1, keepdim=True)
    o = o.to(torch.bfloat16).transpose(1, 2).reshape(b, t, ci)
    part = o.float() @ p.wo.float().t()
    if partial:
        return part
    return ((xf + part) + p.out_b).to(torch.bfloat16)


def _dequantized_attention(hs: torch.Tensor, w_qkv: torch.Tensor,
                           wo_q: torch.Tensor, w_scale: torch.Tensor,
                           heads: int,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """``absorbed_padded_self_attention_s8``'s float branch (:1244-1256) on
    fp32 ``hs [B, T, C]``: float attention on the dequantized weights (no
    activation quantize), ``to_out`` without its bias, fp32.
    ``softmax_scale`` defaults to d^-0.5. ``w_qkv`` may hold a rank's
    ``heads`` (``[3ci, C]``, ``wo_q [C, ci]``)."""
    b, t, c = hs.shape
    ci = w_qkv.shape[0] // 3
    d = ci // heads
    if softmax_scale is None:
        softmax_scale = d ** -0.5
    scale = w_scale.repeat_interleave(d, dim=1)               # [4, ci]
    wq, wk, wv = (w_qkv[i * ci:(i + 1) * ci].float() * scale[i][:, None]
                  for i in range(3))
    wo = wo_q.float() * scale[3][None, :]

    def heads_of(z):
        return z.reshape(b, t, heads, d).transpose(1, 2)

    q, k, v = (heads_of(F.linear(hs, w)) for w in (wq, wk, wv))
    a = torch.softmax((q @ k.transpose(-1, -2)) * softmax_scale, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, t, ci)
    return F.linear(o, wo)


def ln_attention_s8_fallback(x: torch.Tensor, p: LNAttentionPack,
                             partial: bool = False) -> torch.Tensor:
    """The JAX wrapper's float branch (:1112-1117 with
    ``absorbed_padded_self_attention_s8``'s :1247-1258) for the shapes K3
    does not take: LN in the input dtype, float attention on the
    dequantized weights (no activation quantize), then the residual and
    bias in fp32; returns the input dtype. ``partial``: the fp32 attention
    of the pack's heads alone (:func:`ln_attention_s8_finish` adds the
    rest)."""
    hs = _layer_norm(x.float(), p.ln_w, p.ln_b, p.eps).to(x.dtype).float()
    attn = _dequantized_attention(hs, p.w_qkv, p.wo_q, p.w_scale, p.heads)
    if partial:
        return attn
    return ln_attention_s8_finish(x, attn, p, fallback=True)


def ln_attention_s8_finish(x: torch.Tensor, attn: torch.Tensor,
                           p: LNAttentionPack, fallback: bool
                           ) -> torch.Tensor:
    """The block's output from the fp32 ``to_out`` product ``attn`` (on a
    model axis the sum of the ranks' partials), in x's dtype, rounded where
    the one-rank path rounds: the kernel's ``bf16(x + attn + b_out)``, or
    the fallback's attention rounded to x's dtype first, then the residual
    and bias in fp32."""
    if fallback:
        attn = attn.to(x.dtype).float()
        return (x.float() + attn + p.out_b).to(x.dtype)
    return ((x.float() + attn) + p.out_b).to(torch.bfloat16).to(x.dtype)


# K3's attention stage on Hopper (csrc/attention_ln_s8.cu,
# attn_s8_kernel_sm90): the skeleton K1 runs on (csrc/attention_sm90.cuh)
# with an int8 score product. q8 and k8 are head-padded to dp = d rounded up
# to 32 (a tensor map's strides are multiples of 16 bytes); a TMA box is one
# 128-byte swizzle row, 128 int8 of q8/k8 or 64 bf16 of v.


def head_padded_width(d: int) -> int:
    """``dp``: the width of a head of K3's q8/k8 scratch ``[B·T, H, dp]``,
    d rounded up to a multiple of 32 (one k32 step of the int8 product)."""
    return -(-d // 32) * 32


@dataclasses.dataclass(frozen=True)
class S8AttentionPlan:
    """How K3's attention stage covers one ``(B·H, T, d)``: ``head_class``
    the N of its bf16 P·V (d rounded up to a compiled class), ``block_q``
    query rows per block (64 per consumer warpgroup), ``block_k`` keys per
    tile, a ring of ``stages`` K/V tiles, ``qk_chunks`` 128-column int8
    boxes across a head of q8/k8 and ``v_chunks`` 64-column bf16 boxes
    across a head of v, ``dp`` the head-padded width, ``smem_bytes`` of
    dynamic shared memory and the ``grid`` (query tiles, B·H)."""

    head_class: int
    block_q: int
    block_k: int
    stages: int
    qk_chunks: int
    v_chunks: int
    dp: int
    smem_bytes: int
    grid: tuple

    def fields(self) -> tuple:
        """The ten ints the C entry points read (``struct AttnPlan``)."""
        return (self.head_class, self.block_q, self.block_k, self.stages,
                self.qk_chunks, self.v_chunks, self.dp, self.smem_bytes,
                *self.grid)


@functools.lru_cache(maxsize=None)
def sm90_s8_attention_plan(bh: int, t: int, d: int) -> S8AttentionPlan:
    """K3's attention launch plan: K1's tiles (``attention.py:
    sm90_forward_tiles``) with q8/k8 boxes of 128 int8 columns and v boxes
    of 64 bf16 columns."""
    head_class = next(c for c in SM90_HEAD_CLASSES if c >= d)
    qk_chunks = -(-(-(-head_class // 32)) // 4)
    v_chunks = -(-head_class // 64)
    block_q, block_k, stages = sm90_forward_tiles(bh, t, head_class,
                                                  qk_chunks, v_chunks)
    return S8AttentionPlan(
        head_class, block_q, block_k, stages, qk_chunks, v_chunks,
        head_padded_width(d),
        sm90_smem_bytes(block_q, block_k, qk_chunks, stages, v_chunks),
        (-(-t // block_q), bh))


def ln_attention_plans(b: int, t: int, c: int, heads: int,
                       ci: Optional[int] = None) -> tuple:
    """K3's three launch plans: the int8 Q/K/V projection, the attention
    stage and the bf16 ``to_out``; ``ci`` the inner width of ``heads`` (a
    rank's on a model axis; default C). Raises ``ValueError`` on a shape
    the products do not take (C a multiple of 16: a row of x8 is a tensor
    map's stride)."""
    rows = b * t
    ci = c if ci is None else ci
    if not (gemm_takes(3 * ci, c, "int8") and gemm_takes(c, ci, "bfloat16")):
        raise ValueError(f"C={c} must be a multiple of 16 and ci={ci} of 8 "
                         f"(the rows of the products' operands)")
    return (sm90_gemm_plan(rows, 3 * ci, c, "int8"),
            sm90_s8_attention_plan(b * heads, t, ci // heads),
            sm90_gemm_plan(rows, c, ci, "bfloat16"))


@functools.lru_cache(maxsize=None)
def _ln_plans_c(b: int, t: int, c: int, heads: int,
                ci: Optional[int] = None):
    return plans_c(*ln_attention_plans(b, t, c, heads, ci))


def proj_in_plan(b: int, t: int, c: int, channels_major: bool):
    """The launch plan of K8's prologue, ``[B·T, C]·[C, C]ᵀ`` in bf16: A as
    tokens, or channel-major ``[B, C, T]`` with its row tiles per image."""
    return sm90_gemm_plan(b * t, c, c, "bfloat16",
                          images=b if channels_major else 1)


@functools.lru_cache(maxsize=None)
def pin_plans(b: int, t: int, c: int, heads: int, channels_major: bool,
              ci: Optional[int] = None) -> tuple:
    """K8's four launch plans, in the order its C entry point reads them:
    the prologue's (:func:`proj_in_plan`, over all C), then K3's three
    (:func:`ln_attention_plans`, ``ci`` a rank's inner width)."""
    return (proj_in_plan(b, t, c, channels_major),
            *ln_attention_plans(b, t, c, heads, ci))


@functools.lru_cache(maxsize=None)
def _pin_plans_c(b: int, t: int, c: int, heads: int, channels_major: bool,
                 ci: Optional[int] = None):
    return plans_c(*pin_plans(b, t, c, heads, channels_major, ci))


# K13's attention stage on Hopper (csrc/attention_s8.cu,
# attn_s8pv_kernel_sm90), which K15, K11, K10 without v_bf16, K17 and K18
# run too: the skeleton of K1 and K3 (csrc/attention_sm90.cuh) with an int8
# score product and an int8 e8·V product whose A operand is the codes in
# registers and whose B operand is Vᵀ, int8 being K-major only. Vᵀ lies as
# ``v8t [B, H, d, tp]`` (keys contiguous, tp = T rounded up to 16) with the
# keys of every 16 permuted so that a thread's score registers are the A
# fragment as they stand. Its N classes are the .s8 ``wgmma`` widths.
S8PV_HEAD_CLASSES = (16, 32, 48, 64, 80, 128, 160)
S8PV_BOX_KEYS = 128  # a Vᵀ box: one 128-byte swizzle row of keys


def key_of_position(q):
    """The key of a 16-key group that position ``q`` (0..15, numpy or int)
    of ``v8t`` holds: ``2·((q/4) mod 4) + q mod 2 + 8·((q/2) mod 2)``. A
    thread of lane l holds the scores of keys ``2(l mod 4) + {0, 1}`` and
    ``+8`` of each 16; the A fragment of an 8-bit ``wgmma`` wants depth
    ``4(l mod 4) + {0..3}``: this order makes the two the same."""
    return 2 * ((q >> 2) & 3) + (q & 1) + 8 * ((q >> 1) & 1)


def padded_keys(t: int) -> int:
    """``tp``: the key stride of ``v8t``, T rounded up to a multiple of 16
    (the permutation works on whole 16-key groups; a tensor map's strides
    are multiples of 16 bytes)."""
    return -(-t // 16) * 16


@dataclasses.dataclass(frozen=True)
class S8PVAttentionPlan:
    """How K13's attention stage covers one ``(B·H, T, d)``: ``head_class``
    the N of its e8·V product (d rounded up to an .s8 class), ``block_q``
    query rows per block (64 per consumer warpgroup), ``block_k`` keys per
    tile, a ring of ``stages`` K/Vᵀ tiles, ``qk_chunks`` 128-column int8
    boxes across a head of q8/k8, ``dp`` their head-padded width, ``tp`` the
    key stride of ``v8t``, ``smem_bytes`` of dynamic shared memory and the
    ``grid`` (query tiles, B·H)."""

    head_class: int
    block_q: int
    block_k: int
    stages: int
    qk_chunks: int
    dp: int
    tp: int
    smem_bytes: int
    grid: tuple

    def fields(self) -> tuple:
        """The ten ints the C entry points read (``struct AttnPlan`` of
        ``csrc/attention_s8.cu``)."""
        return (self.head_class, self.block_q, self.block_k, self.stages,
                self.qk_chunks, self.dp, self.tp, self.smem_bytes,
                *self.grid)


def s8pv_smem_bytes(block_q: int, block_k: int, qk_chunks: int,
                    head_class: int, stages: int) -> int:
    """1 KiB of slack, Q, per stage a K tile and a Vᵀ tile (``head_class``
    rows of 128 keys), the mbarriers: ``csrc/attention_sm90.cuh:
    smem_bytes_s8pv``."""
    row = S8PV_BOX_KEYS
    return (1024 + block_q * qk_chunks * row
            + stages * (block_k * qk_chunks + head_class) * row
            + 8 * (1 + 2 * stages))


@functools.lru_cache(maxsize=None)
def sm90_s8pv_attention_plan(bh: int, t: int, d: int) -> S8PVAttentionPlan:
    """K13's attention launch plan: K1's tile rules (``attention.py:
    sm90_forward_tiles``: 128-query tiles where they still give every SM a
    block, 128-key tiles up to class 80 and 64 above) and the deepest ring
    of two to four stages that fits, no deeper than the key tiles of the
    two passes."""
    head_class = next(c for c in S8PV_HEAD_CLASSES if c >= d)
    qk_chunks = -(-(-(-head_class // 32)) // 4)
    block_k = 128 if head_class <= 80 else 64
    block_q = 128 if bh * -(-t // 128) >= SM90_SMS else 64
    deepest = max(2, min(SM90_MAX_STAGES, 2 * -(-t // block_k)))
    stages = next(s for s in range(deepest, 1, -1)
                  if s8pv_smem_bytes(block_q, block_k, qk_chunks, head_class,
                                     s) <= SM90_SMEM_LIMIT)
    return S8PVAttentionPlan(
        head_class, block_q, block_k, stages, qk_chunks, head_padded_width(d),
        padded_keys(t), s8pv_smem_bytes(block_q, block_k, qk_chunks,
                                        head_class, stages),
        (-(-t // block_q), bh))


@functools.cache
def _kernel(entry: str):
    fn = getattr(_build.load("attention_ln_s8"), entry)
    # K3 and K10: dtype, x; K8: channels_major, x, wpi, bpi, xf; K3 and K8
    # take ci and partial, K10 neither
    head = [ctypes.c_int] + [ctypes.c_void_p] * (
        4 if entry == _LN_ENTRIES["K8"] else 1)
    k10 = entry == _LN_ENTRIES["K10"]
    fn.argtypes = (head + [ctypes.c_void_p] * 12
                   + [ctypes.c_int] * (4 if k10 else 5)
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * (0 if k10 else 1)
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_LN_ENTRIES = {"K3": "ldmseg_attention_ln_s8",
               "K8": "ldmseg_attention_ln_s8_pin",
               "K10": "ldmseg_attention_ln_s8_rowmajor"}


def _launch(x: torch.Tensor, p: LNAttentionPack, name: str = "K3",
            partial: bool = False):
    """K3, K8 (x the GroupNorm output, bf16, read channel-major when it is
    the tokens view of a contiguous ``[B, C, T]``) or K10 with ``v_bf16``
    (K3's kernels behind K10's entry point). ``partial`` (K3 or K8 on a
    rank's heads, ``partial`` 1 of their entry points): the fp32 ``to_out``
    product ``[B, T, C]`` of the pack's heads alone, no residual, no bias;
    K8 then returns ``(xf [B·T, C] fp32, partial)``, its prologue's
    residual stream beside it."""
    pin = name == "K8"
    b, t, c = x.shape
    h = p.heads
    ci = p.w_qkv.shape[0] // 3
    if pin and x.dtype != torch.bfloat16:
        raise ValueError(f"K8: x must be bfloat16 (the prologue's bf16 "
                         f"operand), got {x.dtype}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if ci // h > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {ci // h} > {MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"{name}: B*heads {b * h} > 65535")
    if not p.score_scale > 0:
        raise ValueError(f"{name}: score_scale {p.score_scale} must be > 0 "
                         f"(the kernel takes the row max of the int32 "
                         f"scores)")
    channels_major = pin and x.transpose(1, 2).is_contiguous()
    if not channels_major:
        x = x.contiguous()
    try:
        plans = (_pin_plans_c(b, t, c, h, channels_major, ci) if pin
                 else _ln_plans_c(b, t, c, h, ci))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    ops = (p.ln_w, p.ln_b, p.out_b, p.w_qkv, p.m_qkv, p.wo) + (
        (p.wpi, p.bpi) if pin else ())
    if any(o is None or o.device != x.device or not o.is_contiguous()
           for o in ops):
        raise ValueError(f"{name}: the pack must be contiguous on x's "
                         f"device{' and carry proj_in' if pin else ''}")
    dev = x.device
    out = torch.empty((b, t, c), dtype=torch.float32 if partial
                      else torch.bfloat16, device=dev)
    x8 = torch.empty((b * t, c), dtype=torch.int8, device=dev)
    # head-padded [B·T, H, dp]: the padding is never read (TMA fills zeros
    # past d)
    q8, k8 = (torch.empty((b * t, h, head_padded_width(ci // h)),
                          dtype=torch.int8, device=dev) for _ in range(2))
    v, o = (torch.empty((b * t, ci), dtype=torch.bfloat16, device=dev)
            for _ in range(2))
    k10 = name == "K10"
    if k10 and (partial or ci != c):
        raise ValueError("K10: one rank's whole block only")
    block = (out.data_ptr(), p.ln_w.data_ptr(), p.ln_b.data_ptr(),
             p.out_b.data_ptr(), p.w_qkv.data_ptr(), p.m_qkv.data_ptr(),
             p.wo.data_ptr(), x8.data_ptr(), q8.data_ptr(), k8.data_ptr(),
             v.data_ptr(), o.data_ptr(), b, t, c) + (() if k10 else (ci,)) + (
                 h, p.xs, p.score_scale, p.eps) + (
                     () if k10 else (int(partial),)) + (plans,)
    kernel = _kernel(_LN_ENTRIES[name])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pin:
            xf = torch.empty((b * t, c), dtype=torch.float32, device=dev)
            err = kernel(int(channels_major), x.data_ptr(), p.wpi.data_ptr(),
                         p.bpi.data_ptr(), xf.data_ptr(), *block, stream)
        else:
            err = kernel(_DTYPE_CODE[x.dtype], x.data_ptr(), *block, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return (xf, out) if pin and partial else out


def ln_attention_s8(x: torch.Tensor, p: LNAttentionPack,
                    group=None) -> torch.Tensor:
    """``x + to_out(attention(LN(x))) + b_out`` for ``x [B, T, C]``,
    returned in ``x``'s dtype (the kernel's result is bf16, cast as the JAX
    wrapper's ``.astype(x.dtype)``). With ``group`` (a model axis: ``p``
    holds this rank's heads) the rank's fp32 ``to_out`` product is summed
    over the group before the residual and the bias."""
    t = x.shape[1]
    ci = p.w_qkv.shape[0] // 3
    if not absorbed_takes_kernel(t, ci, p.heads):
        ln_attention_s8.fallbacks += 1
        if group is None:
            return ln_attention_s8_fallback(x, p)
        return ln_attention_s8_finish(
            x, group.sum(ln_attention_s8_fallback(x, p, partial=True)), p,
            fallback=True)
    if x.device.type == "cpu":
        if group is None:
            return ln_attention_s8_reference(x, p).to(x.dtype)
        part = ln_attention_s8_reference(x, p, partial=True)
    elif x.device.type != "cuda":
        raise ValueError(f"K3: unsupported device {x.device}")
    else:
        out = _launch(x, p, partial=group is not None)
        ln_attention_s8.launches += 1
        if group is None:
            return out.to(x.dtype)
        part = out
    return ln_attention_s8_finish(x, group.sum(part), p, fallback=False)


ln_attention_s8.launches = 0
ln_attention_s8.fallbacks = 0



# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------
def s8_takes_kernel(t: int) -> bool:
    """``fused_self_attention_s8``'s shape rule (:120) without its CPU
    clause."""
    return not (t > S8_MAX_SEQ or t % min(S8_BLOCK_Q, t) != 0 or t % 8 != 0)


def attention_s8_fallback(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """``_xla_bthd`` (:1420): float attention in the input dtype, the
    softmax in fp32, on ``[B, T, H, D]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def s8_scales(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              act_scale: Optional[float], group=None):
    """The q, k, v scales of the JAX wrapper (:123-131): the static
    ``act_scale`` (made float32) for all three, else ``max(amax, 1e-6) /
    127`` of each tensor in float32 (0-d tensors, no host sync).
    With ``group`` q, k and v hold a rank's heads and the amaxes are the
    whole tensors', the maximum over the model group."""
    if act_scale is not None:
        return (float(np.float32(act_scale)),) * 3
    amax = torch.stack([x.abs().amax() for x in (q, k, v)])
    if group is not None:
        amax = group.max(amax)
    return tuple((amax.clamp_min(1e-6).float() / 127.0).unbind(0))


def attention_s8_reference(q8: torch.Tensor, k8: torch.Tensor,
                           v8: torch.Tensor, sc0, sc1) -> torch.Tensor:
    """K13's arithmetic in plain PyTorch on int8 ``[B, T, H, D]`` codes ->
    bf16: ``s = float(int32 q8·k8ᵀ)·sc0``, ``e = exp((s - rowmax) + ln 127)``,
    ``denom = Σe`` over the unrounded e in fp32, ``e8 = round(e)``,
    ``o = bf16(float(int32 e8·v8)·((sc1·127) / denom))``."""
    def heads_of(z):
        return z.transpose(1, 2)                              # [B, H, T, D]
    s = exact_int8_matmul(heads_of(q8), heads_of(k8)).float() * sc0
    e = torch.exp((s - s.amax(-1, keepdim=True)) + LN127)
    denom = e.sum(-1, keepdim=True)
    e8 = torch.round(e).to(torch.int8)
    o32 = exact_int8_matmul(e8, heads_of(v8).transpose(-1, -2))
    # (sc1 * 127) in float32, then a true division (``scalar / tensor``
    # would multiply by the reciprocal)
    num = torch.as_tensor(sc1, dtype=torch.float32,
                          device=q8.device) * np.float32(127.0)
    o = o32.float() * (num / denom)
    return o.to(torch.bfloat16).transpose(1, 2)


def quantize_s8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(float(x) / scale), -127, 127)`` as int8, ``scale`` a
    0-d float32 tensor on x's device: a true division, as the kernel's (on
    the card a Python scalar divisor is applied as its reciprocal, which
    moves ties of bf16 inputs over static scales such as 3/100)."""
    return torch.round(x.float() / scale).clamp_(-127, 127).to(torch.int8)


def fused_self_attention_s8_reference(q: torch.Tensor, k: torch.Tensor,
                                      v: torch.Tensor, scale: float,
                                      act_scale: Optional[float] = None,
                                      group=None) -> torch.Tensor:
    """The kernel branch of :func:`fused_self_attention_s8` in plain
    PyTorch on any device: the scales, the quantize of q, k and v, and
    :func:`attention_s8_reference` with ``sc0 = (qs·ks)·scale`` and ``sc1 =
    vs / 127`` in float32 -> bf16 ``[B, T, H, D]``."""
    scales = s8_scales(q, k, v, act_scale, group)
    qs, ks, vs = (torch.as_tensor(x, dtype=torch.float32, device=q.device)
                  for x in scales)
    sc0 = (qs * ks) * torch.tensor(scale, dtype=torch.float32,
                                   device=q.device)
    q8, k8, v8 = (quantize_s8(x, s_) for x, s_ in zip((q, k, v),
                                                      (qs, ks, vs)))
    return attention_s8_reference(
        q8, k8, v8, sc0, vs / torch.tensor(127.0, device=q.device))


@functools.cache
def _s8_kernel():
    fn = _build.load("attention_s8").ldmseg_attention_s8
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] + [ctypes.c_float] * 4
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _s8pv_plan_c(bh: int, t: int, d: int):
    return plans_c(sm90_s8pv_attention_plan(bh, t, d))


def _s8_scratch(b: int, t: int, h: int, d: int, dev, zero_pad: bool = False):
    """The attention stage's int8 inputs: q8 and k8 head-padded ``[B·T, H,
    dp]`` (the padding never read: TMA fills zeros past d) and ``v8t [B, H,
    d, tp]`` (``zero_pad``: zeroed, for a producer that leaves the
    positions past T unwritten; their codes meet e8 = 0 anyway)."""
    dp, tp = head_padded_width(d), padded_keys(t)
    q8, k8 = (torch.empty((b * t, h, dp), dtype=torch.int8, device=dev)
              for _ in range(2))
    alloc = torch.zeros if zero_pad and tp != t else torch.empty
    return q8, k8, alloc((b, h, d, tp), dtype=torch.int8, device=dev)


def _s8_launch(q, k, v, scale, scales) -> torch.Tensor:
    b, t, h, d = q.shape
    xs = (q, k, v)
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"K13: q, k, v must share float32 or bfloat16, got "
                         f"{[x.dtype for x in xs]}")
    if any(x.shape != q.shape or x.device != q.device for x in xs):
        raise ValueError("K13: q, k, v must share one shape and device")
    if (d % 8 or not 8 <= d <= MAX_HEAD_DIM or not 1 <= b * h <= 65535
            or q.numel() >= 2 ** 31):
        raise ValueError(f"K13: head dim {d} (a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}), B*heads {b * h} or "
                         f"{q.numel()} elements not taken")
    if any(x.stride(3) != 1 for x in xs):
        raise ValueError("K13: q, k, v need unit stride on D")
    if not float(scale) > 0:
        raise ValueError(f"K13: scale {scale} must be > 0 (the kernel takes "
                         f"the row max of the int32 scores)")
    dev = q.device
    q8, k8, v8t = _s8_scratch(b, t, h, d, dev)
    out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=dev)
    strides = [s_ for x in xs for s_ in x.stride()[:3]]
    if isinstance(scales[0], torch.Tensor):
        dev_scales = torch.stack(scales).contiguous()
        ptr, host = dev_scales.data_ptr(), (0.0, 0.0, 0.0)
    else:
        ptr, host = None, scales
    kernel = _s8_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            (ctypes.c_longlong * 9)(*strides), q8.data_ptr(), k8.data_ptr(),
            v8t.data_ptr(), out.data_ptr(), b, t, h, d, ptr, *host,
            float(scale), _s8pv_plan_c(b * h, t, d), stream)
    if err != 0:
        raise RuntimeError(f"K13 launch failed: CUDA error {err}")
    fused_self_attention_s8.launches += 1
    return out


def fused_self_attention_s8(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float,
                            act_scale: Optional[float] = None,
                            group=None) -> torch.Tensor:
    """int8 self-attention on float ``[B, T, H, D]`` q, k, v (no gradient),
    returned in q's dtype: the kernel's bf16 result cast as the JAX wrapper
    casts it. ``act_scale`` is the static q/k/v scale, None one dynamic
    amax per tensor (with ``group`` q, k and v hold a rank's heads: the
    amaxes over the model group)."""
    t = q.shape[1]
    if not s8_takes_kernel(t):
        fused_self_attention_s8.fallbacks += 1
        return attention_s8_fallback(q, k, v, scale)
    if q.device.type == "cpu":
        return fused_self_attention_s8_reference(
            q, k, v, scale, act_scale, group).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"K13: unsupported device {q.device}")
    scales = s8_scales(q, k, v, act_scale, group)
    return _s8_launch(q, k, v, scale, scales).to(q.dtype)


fused_self_attention_s8.launches = 0
fused_self_attention_s8.fallbacks = 0


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------
@torch.no_grad()
def with_proj_in(p: LNAttentionPack, conv) -> LNAttentionPack:
    """K8's pack: K3's ``p`` with Transformer2D's 1x1 ``proj_in`` conv
    (``pack_inference_tiles(fuse_projs=True)`` with the wrapper's
    ``proj_in[0].astype(bf16)``): the float32 weight ``[C_out, C_in]``
    cast to bf16 for the kernel and kept in float32 for the fallback, the
    bias in float32 (``g`` row 3). On a model axis ``conv`` is the whole
    layer (``parallel/tp.py:whole_layer``) and ``p`` a rank's heads."""
    w = conv.weight.detach().float().reshape(conv.weight.shape[0], -1)
    return dataclasses.replace(
        p, wpi=w.to(torch.bfloat16).contiguous(), wpi_f=w.contiguous(),
        bpi=conv.bias.detach().float().contiguous())


def proj_in_reference(x: torch.Tensor, p: LNAttentionPack) -> torch.Tensor:
    """K8's prologue in plain PyTorch: the residual stream ``xf =
    float(x)·float(Wpi)ᵀ + b_pi`` in fp32, never rounded, ``[B, T, C]``."""
    return x.float() @ p.wpi.float().t() + p.bpi


def ln_attention_s8_pin_reference(x: torch.Tensor, p: LNAttentionPack,
                                  static_offset: Optional[float] = None,
                                  partial: bool = False) -> torch.Tensor:
    """K8's arithmetic in plain PyTorch (``[B, T, C]`` -> bf16): the
    residual stream :func:`proj_in_reference`, then K3's arithmetic on it
    (:func:`ln_attention_s8_reference`; ``partial`` its fp32 ``to_out``
    product of a rank's heads alone)."""
    return ln_attention_s8_reference(proj_in_reference(x, p), p,
                                     static_offset, partial)


def ln_attention_s8_pin_fallback(x: torch.Tensor, p: LNAttentionPack,
                                 group=None) -> torch.Tensor:
    """The JAX wrapper's branch with ``proj_in`` for the shapes K8 does
    not take (:1106-1117): the proj in fp32 on the float32 weight, rounded
    to x's dtype, then :func:`ln_attention_s8_fallback` (with ``group``
    its partial over a rank's heads, summed, then finished)."""
    h = (x.float() @ p.wpi_f.t() + p.bpi).to(x.dtype)
    if group is None:
        return ln_attention_s8_fallback(h, p)
    return ln_attention_s8_finish(
        h, group.sum(ln_attention_s8_fallback(h, p, partial=True)), p,
        fallback=True)


def ln_attention_s8_pin(x: torch.Tensor, p: LNAttentionPack,
                        group=None) -> torch.Tensor:
    """K8: the block of :func:`ln_attention_s8` on the residual stream ``x
    Wpiᵀ + b_pi`` that it builds from the GroupNorm output ``x [B, T, C]``;
    returns the new residual stream in ``x``'s dtype. On the card ``x`` is
    bf16, as tokens or as the tokens view of an NCHW tensor, which the
    kernel reads where it lies. With ``group`` (a model axis: ``p`` holds
    this rank's heads and the whole ``proj_in``) the prologue runs on all
    C, K3's partial mode on the rank's heads, the partials are summed over
    the group and ``bf16(xf + sum + b_out)`` rounds once, with the fp32
    ``xf``, where the one-rank kernel rounds."""
    b, t, c = x.shape
    ci = p.w_qkv.shape[0] // 3
    if not absorbed_takes_kernel(t, ci, p.heads):
        ln_attention_s8_pin.fallbacks += 1
        return ln_attention_s8_pin_fallback(x, p, group)
    if x.device.type == "cpu":
        if group is None:
            return ln_attention_s8_pin_reference(x, p).to(x.dtype)
        xf = proj_in_reference(x, p)
        part = ln_attention_s8_reference(xf, p, partial=True)
    elif x.device.type != "cuda":
        raise ValueError(f"K8: unsupported device {x.device}")
    else:
        out = _launch(x, p, "K8", partial=group is not None)
        ln_attention_s8_pin.launches += 1
        if group is None:
            return out.to(x.dtype)
        xf, part = out
        xf = xf.view(b, t, c)
    return ln_attention_s8_finish(xf, group.sum(part), p,
                                  fallback=False).to(x.dtype)


ln_attention_s8_pin.launches = 0
ln_attention_s8_pin.fallbacks = 0


@functools.cache
def _proj_in_kernel():
    fn = _build.load("attention_ln_s8").ldmseg_proj_in_f32
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 3
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def proj_in_f32(x: torch.Tensor, p: LNAttentionPack) -> torch.Tensor:
    """K8's prologue alone: ``xf = float(x)·float(Wpi)ᵀ + b_pi`` in fp32,
    ``[B·T, C]``, from bf16 ``x [B, T, C]`` (tokens, or the tokens view of a
    contiguous ``[B, C, T]``, read channel-major). No model path calls it:
    the card tests and ``chip_smoke.py`` hold the kernel's prologue against
    ``torch.matmul`` in fp32 with it (``csrc/attention_ln_s8.cu:
    ldmseg_proj_in_f32``). A CPU tensor takes the plain version."""
    b, t, c = x.shape
    if x.dtype != torch.bfloat16 or p.wpi is None:
        raise ValueError("proj_in_f32: bf16 x and a pack with proj_in")
    if x.device.type == "cpu":
        return proj_in_reference(x, p).reshape(b * t, c)
    channels_major = x.transpose(1, 2).is_contiguous()
    if not channels_major:
        x = x.contiguous()
    xf = torch.empty((b * t, c), dtype=torch.float32, device=x.device)
    plan = plans_c(proj_in_plan(b, t, c, channels_major))
    with torch.cuda.device(x.device):
        err = _proj_in_kernel()(
            int(channels_major), x.data_ptr(), p.wpi.data_ptr(),
            p.bpi.data_ptr(), xf.data_ptr(), b, t, c, plan,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"proj_in_f32 launch failed: CUDA error {err}")
    return xf


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PaddedAttentionPack:
    """K11's operands for one self-attention (float32 unless noted). On a
    model axis they hold this rank's ``heads``: 3ci rows of ``w_qkv`` and
    ``m_qkv``, ci columns of ``wo_q``, ``ratio`` and ``w_scale`` of those
    heads (ci = heads·d); ``out_scale`` and ``ratio`` use the maximum of
    ``wos`` over every rank's heads."""

    heads: int
    xs: float              # the input's static int8 scale
    score_scale: float     # as² · d^-0.5
    out_scale: float       # as · max(wos)
    w_qkv: torch.Tensor    # int8 [3C, C]: to_q, to_k, to_v rows (out, in)
    m_qkv: torch.Tensor    # [3C]: q, k, v requant w_scale · (xs / as)
    wo_q: torch.Tensor     # int8 [C, C] (out, in)
    ratio: torch.Tensor    # [H]: wos[h] / max(wos)
    w_scale: torch.Tensor  # [4, H] per-head scales of q, k, v, o


@torch.no_grad()
def pack_padded_attention(attn, heads: int, xs: float,
                          attn_scale: float = ATTN_SCALE, group=None
                          ) -> PaddedAttentionPack:
    """Quantize an attention's ``to_q/k/v/to_out`` weights per head
    (``quantize_head_weights``, the storage of
    ``prequantize_conv_tree(absorbed_attention=True)``) and pack K11's
    operands in the JAX package's float32 order (``_abs_padded_prep``
    :1161). ``heads`` is the attention's; where ``attn`` holds a rank's
    heads (tensor parallelism: ``to_q`` ``[ci, C]``) the pack holds them,
    and ``group`` (the model group's reductions) gives ``max(wos)`` over
    every rank's heads: ``out_scale`` and ``ratio`` are one rank's, the
    codes and ``m_qkv`` the slice of one rank's."""
    wq, wk, wv = (m.weight for m in (attn.to_q, attn.to_k, attn.to_v))
    d = wq.shape[1] // heads
    heads = wq.shape[0] // d
    q8, k8, v8, o8, scales = quantize_head_weights(
        wq, wk, wv, attn.to_out[0].weight, heads)
    xs32, as32 = np.float32(xs), np.float32(attn_scale)
    ratio = float(xs32 / as32)
    per_col = scales.repeat_interleave(d, dim=1)          # [4, ci]
    m_qkv = torch.cat([per_col[i] * ratio for i in range(3)])
    wos = scales[3]
    top = wos.max()
    if group is not None:
        top = group.max(top)
    wos_max = np.maximum(np.float32(top.item()), np.float32(1e-8))
    score = np.float32(as32 * as32) * np.float32(d ** -0.5)
    return PaddedAttentionPack(
        heads=heads, xs=float(xs32), score_scale=float(score),
        out_scale=float(as32 * wos_max),
        w_qkv=torch.cat([q8, k8, v8]).contiguous(),
        m_qkv=m_qkv.contiguous(), wo_q=o8.contiguous(),
        ratio=(wos / torch.tensor(wos_max, device=wos.device)).contiguous(),
        w_scale=scales.contiguous())


def padded_attention_s8_reference(x: torch.Tensor, p: PaddedAttentionPack,
                                  partial: bool = False) -> torch.Tensor:
    """K11's arithmetic in plain PyTorch (``[B, T, C]`` -> bf16):
    ``x8 = clip(rint(float(x) / xs))``, the three int8 projections
    requantized per column, per head ``e = exp((s - rowmax) + ln 127)``
    with ``denom = Σe`` over the fp32 e, ``e8 = rint(e)``, ``of8 =
    clip(rint(float(int32 e8·v8)·(ratio[h] / denom)))``, and
    ``bf16(float(int32 of8·Wo8)·out_scale)``; ``partial``: the int32
    ``of8·Wo8`` of the pack's heads alone (a rank's)."""
    x8 = quantize_s8(x, torch.tensor(p.xs, device=x.device))
    out = _padded_core(x8, p)
    if partial:
        return out
    return padded_attention_s8_finish(out, p)


def padded_attention_s8_finish(o32: torch.Tensor,
                               p: PaddedAttentionPack) -> torch.Tensor:
    """K11's last rounding point on the int32 ``of8·Wo8`` (on a model axis
    the exact sum of the ranks' partials): ``bf16(float(o32)·out_scale)``."""
    return (o32.float() * p.out_scale).to(torch.bfloat16)


def _padded_core(x8: torch.Tensor, p: "PaddedAttentionPack") -> torch.Tensor:
    """K11's steps 2-4 and the int32 ``of8·Wo8`` on the codes ``x8 [B, T,
    C]`` (over the pack's ci inner columns)."""
    b, t, c = x8.shape
    h = p.heads
    ci = p.w_qkv.shape[0] // 3
    d = ci // h
    y = exact_int8_matmul(x8, p.w_qkv).float() * p.m_qkv      # [B, T, 3ci]
    q8, k8, v8 = (torch.round(y[..., i * ci:(i + 1) * ci]).clamp_(-127, 127)
                  .to(torch.int8).reshape(b, t, h, d).transpose(1, 2)
                  for i in range(3))                          # [B, H, T, d]
    s = exact_int8_matmul(q8, k8).float() * p.score_scale
    e = torch.exp((s - s.amax(-1, keepdim=True)) + LN127)
    denom = e.sum(-1, keepdim=True)
    e8 = torch.round(e).to(torch.int8)
    o32 = exact_int8_matmul(e8, v8.transpose(-1, -2))
    of8 = torch.round(o32.float() * (p.ratio[:, None, None] / denom))
    of8 = of8.clamp_(-127, 127).to(torch.int8).transpose(1, 2)
    return exact_int8_matmul(of8.reshape(b, t, ci), p.wo_q)


def padded_attention_s8_fallback(x: torch.Tensor, p: PaddedAttentionPack,
                                 partial: bool = False) -> torch.Tensor:
    """``absorbed_padded_self_attention_s8``'s float branch (:1244-1256)
    for the shapes K11 does not take: float attention on the dequantized
    weights, x unquantized, in x's dtype; ``partial``: fp32, the pack's
    heads alone (a rank's)."""
    out = _dequantized_attention(x.float(), p.w_qkv, p.wo_q, p.w_scale,
                                 p.heads)
    return out if partial else out.to(x.dtype)


@functools.cache
def _padded_kernel():
    fn = _build.load("attention_s8").ldmseg_attention_padded_s8
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def padded_attention_plans(b: int, t: int, c: int, heads: int,
                           ci: Optional[int] = None) -> tuple:
    """K11's (and K10's without ``v_bf16``) four launch plans: the int8 Q/K
    projection ``[B·T, 2ci, C]``, the V projection with its operands
    swapped ``[ci, B·T, C]`` (its columns are tokens, so its epilogue
    writes ``v8t``), the attention stage and the int8 ``to_out`` ``[B·T, C,
    ci]``; ``ci`` the inner width of ``heads`` (a rank's on a model axis;
    default C). Raises ``ValueError`` on a shape the products do not take
    (C and ci multiples of 16: a row of x8 and of of8 is a tensor map's
    stride)."""
    rows = b * t
    ci = c if ci is None else ci
    if not (gemm_takes(ci, c, "int8") and gemm_takes(c, ci, "int8")) \
            or rows % 8:
        raise ValueError(f"C={c} and ci={ci} must be multiples of 16 and "
                         f"B*T={rows} of 8 (the int8 products' operands)")
    return (sm90_gemm_plan(rows, 2 * ci, c, "int8"),
            sm90_gemm_plan(ci, rows, c, "int8"),
            sm90_s8pv_attention_plan(b * heads, t, ci // heads),
            sm90_gemm_plan(rows, c, ci, "int8"))


@functools.lru_cache(maxsize=None)
def _padded_plans_c(b: int, t: int, c: int, heads: int,
                    ci: Optional[int] = None):
    return plans_c(*padded_attention_plans(b, t, c, heads, ci))


def _padded_scratch(b: int, t: int, c: int, h: int, dev,
                    ci: Optional[int] = None):
    """x8 ``[B·T, C]``, of8 ``[B·T, ci]`` and the attention stage's inputs
    (v8t zeroed where T % 16 leaves positions that the V projection does
    not write)."""
    ci = c if ci is None else ci
    x8 = torch.empty((b * t, c), dtype=torch.int8, device=dev)
    of8 = torch.empty((b * t, ci), dtype=torch.int8, device=dev)
    return (x8, *_s8_scratch(b, t, h, ci // h, dev, zero_pad=True), of8)


def _padded_launch(x: torch.Tensor, p: PaddedAttentionPack,
                   partial: bool = False) -> torch.Tensor:
    """K11 on the card; ``partial`` (a rank's heads): the int32 ``of8·Wo8``
    ``[B, T, C]`` of the pack's heads, unscaled (``partial`` 1 of
    ``ldmseg_attention_padded_s8``)."""
    b, t, c = x.shape
    h = p.heads
    ci = p.w_qkv.shape[0] // 3
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K11: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if ci != c and not partial:
        raise ValueError(f"K11: a pack of {ci} of {c} inner columns needs "
                         f"the partial mode")
    if ci // h > MAX_HEAD_DIM or b * h > 65535 or x.numel() >= 2 ** 31:
        raise ValueError(f"K11: head dim {ci // h} (<= {MAX_HEAD_DIM}), "
                         f"B*heads {b * h} or {x.numel()} elements not "
                         f"taken")
    try:
        plans = _padded_plans_c(b, t, c, h, ci)
    except ValueError as e:
        raise ValueError(f"K11: {e}") from None
    x = x.contiguous()
    ops = (p.w_qkv, p.m_qkv, p.wo_q, p.ratio)
    if any(o.device != x.device or not o.is_contiguous() for o in ops):
        raise ValueError("K11: the pack must be contiguous on x's device")
    dev = x.device
    out = torch.empty((b, t, c), dtype=torch.int32 if partial
                      else torch.bfloat16, device=dev)
    scratch = _padded_scratch(b, t, c, h, dev, ci)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _padded_kernel()(
            _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
            p.w_qkv.data_ptr(), p.m_qkv.data_ptr(), p.wo_q.data_ptr(),
            p.ratio.data_ptr(), *(z.data_ptr() for z in scratch), b, t, c,
            ci, h, p.xs, p.score_scale, p.out_scale, int(partial), plans,
            stream)
    if err != 0:
        raise RuntimeError(f"K11 launch failed: CUDA error {err}")
    return out


def padded_attention_s8(x: torch.Tensor, p: PaddedAttentionPack,
                        group=None) -> torch.Tensor:
    """K11: ``to_out(attention(x))`` without the ``to_out`` bias for ``x
    [B, T, C]`` (no gradient), returned in x's dtype: the kernel's bf16
    result cast as the JAX wrapper casts it. With ``group`` (a model axis:
    ``p`` holds this rank's heads, its scales the group's ``max(wos)``)
    the int32 partials are summed over the group, exactly
    (``group.sum_exact``), then scaled and rounded once: one rank's result
    bit for bit (the fallback's fp32 partials summed in fp32)."""
    b, t, c = x.shape
    ci = p.w_qkv.shape[0] // 3
    if not absorbed_takes_kernel(t, ci, p.heads):
        padded_attention_s8.fallbacks += 1
        if group is None:
            return padded_attention_s8_fallback(x, p)
        return group.sum(padded_attention_s8_fallback(x, p, True)).to(
            x.dtype)
    if x.device.type == "cpu":
        if group is None:
            return padded_attention_s8_reference(x, p).to(x.dtype)
        part = padded_attention_s8_reference(x, p, partial=True)
    elif x.device.type != "cuda":
        raise ValueError(f"K11: unsupported device {x.device}")
    else:
        out = _padded_launch(x, p, partial=group is not None)
        padded_attention_s8.launches += 1
        if group is None:
            return out.to(x.dtype)
        part = out
    return padded_attention_s8_finish(group.sum_exact(part), p).to(x.dtype)


padded_attention_s8.launches = 0
padded_attention_s8.fallbacks = 0


# ---------------------------------------------------------------------------
# K15
# ---------------------------------------------------------------------------
def fused_self_attention_packed_s8_reference(q: torch.Tensor,
                                             k: torch.Tensor,
                                             v: torch.Tensor, heads: int,
                                             scale: float,
                                             group=None) -> torch.Tensor:
    """K15's arithmetic in plain PyTorch on ``[B, T, C]`` -> bf16:
    :func:`fused_self_attention_s8_reference` on the head views with the
    dynamic scales (``act_scale=None``; ``group`` as in
    :func:`fused_self_attention_packed_s8`)."""
    b, t, c = q.shape
    qh, kh, vh = (x.unflatten(-1, (heads, c // heads)) for x in (q, k, v))
    return fused_self_attention_s8_reference(qh, kh, vh, scale, None,
                                             group).reshape(b, t, c)


@functools.cache
def _packed_s8_kernel():
    fn = _build.load("attention_s8").ldmseg_attention_packed_s8
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_float,
                      ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _packed_s8_launch(q, k, v, heads, scale, group=None) -> torch.Tensor:
    b, t, c = q.shape
    xs = (q, k, v)
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"K15: q, k, v must share float32 or bfloat16, got "
                         f"{[x.dtype for x in xs]}")
    if any(x.shape != q.shape or x.device != q.device for x in xs):
        raise ValueError("K15: q, k, v must share one shape and device")
    d = c // heads
    if (d % 8 or not 8 <= d <= MAX_HEAD_DIM or not 1 <= b * heads <= 65535
            or q.numel() >= 2 ** 31):
        raise ValueError(f"K15: head dim {d} (a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}), B*heads {b * heads} or "
                         f"{q.numel()} elements not taken")
    if any(x.stride(2) != 1 for x in xs):
        raise ValueError("K15: q, k, v need unit stride on C")
    if not float(scale) > 0:
        raise ValueError(f"K15: scale {scale} must be > 0 (the kernel takes "
                         f"the row max of the int32 scores)")
    dev = q.device
    q8, k8, v8t = _s8_scratch(b, t, heads, d, dev)
    out = torch.empty((b, t, c), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(6, dtype=torch.int32, device=dev)  # amax, scales
    strides = [s_ for x in xs for s_ in x.stride()[:2]]
    fn = _packed_s8_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream

        def stage(n):
            return fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), (ctypes.c_longlong * 6)(*strides),
                      q8.data_ptr(), k8.data_ptr(), v8t.data_ptr(),
                      out.data_ptr(), b, t, c, heads, scratch.data_ptr(),
                      float(scale), _s8pv_plan_c(b * heads, t, d), n, stream)
        if group is None:
            err = stage(0)
        else:
            # the amax bits (non-negative floats, which order as their
            # bits), the group's maximum, then the scales and the attention
            err = stage(1)
            if err == 0:
                scratch[:3].copy_(group.max(scratch[:3]))
                err = stage(2)
    if err != 0:
        raise RuntimeError(f"K15 launch failed: CUDA error {err}")
    fused_self_attention_packed_s8.launches += 1
    return out


def fused_self_attention_packed_s8(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, heads: int,
                                   scale: float, group=None) -> torch.Tensor:
    """int8 self-attention on float ``[B, T, C]`` q, k, v (no gradient),
    returned in q's dtype: the kernel's bf16 result cast as the JAX wrapper
    casts it. The scales are always dynamic: there is no ``act_scale``.
    ``group`` (a model axis: q, k and v hold this rank's ``heads``): the
    amaxes are the whole tensors', the model group's maximum of the ranks'
    (on the card two launches, ``ldmseg_attention_packed_s8`` stages 1
    and 2, with ``group.max`` of the amax bits between them), so the scales
    equal one rank's bit for bit."""
    b, t, c = q.shape
    if not packed_takes_kernel(t, c, heads):
        fused_self_attention_packed_s8.fallbacks += 1
        return packed_attention_fallback(q, k, v, heads, scale)
    if q.device.type == "cpu":
        return fused_self_attention_packed_s8_reference(
            q, k, v, heads, scale, group).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"K15: unsupported device {q.device}")
    return _packed_s8_launch(q, k, v, heads, scale, group).to(q.dtype)


fused_self_attention_packed_s8.launches = 0
fused_self_attention_packed_s8.fallbacks = 0


# ---------------------------------------------------------------------------
# K10 (an op)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class LNRowMajorPack:
    """K10's operands for one block: K3's pack (the LN and bias rows; with
    ``v_bf16`` every operand) and K11's (the int8 q, k, v, to_out and the
    scales of ``v_bf16=False``), quantized from the same float weights with
    the same input scale."""

    ln: LNAttentionPack
    padded: PaddedAttentionPack


@torch.no_grad()
def pack_ln_attention_rowmajor(norm, attn, heads: int, xs: float,
                               attn_scale: float = ATTN_SCALE
                               ) -> LNRowMajorPack:
    """K10's operands from a block's ``norm1`` and ``attn1``, as
    ``absorbed_padded_ln_self_attention_s8`` builds them (:1140-1155 on
    ``_abs_padded_prep`` :1161): with ``v_bf16`` the per-column V dequant
    (``m`` row 3) and the bf16 ``to_out`` of :func:`pack_ln_attention`,
    without it the requant rows and int8 ``to_out`` of
    :func:`pack_padded_attention`."""
    return LNRowMajorPack(
        ln=pack_ln_attention(norm, attn, heads, xs, attn_scale),
        padded=pack_padded_attention(attn, heads, xs, attn_scale))


def ln_attention_s8_rowmajor_reference(x: torch.Tensor, p: LNRowMajorPack,
                                       v_bf16: bool = True,
                                       x8: Optional[torch.Tensor] = None
                                       ) -> torch.Tensor:
    """K10's arithmetic in plain PyTorch (``[B, T, C]`` -> bf16). With
    ``v_bf16`` it is K3's (:func:`ln_attention_s8_reference`: the TPU kernel
    subtracts the row max, :768). Without it: the LN and quantize of K3
    (or the codes ``x8`` given, to run the later steps on a kernel's own),
    K11's int8 projections, e8 attention and ``of8``, and ``bf16((float(x)
    + float(of8·Wo8)·(as·max(wos))) + b_out)``."""
    if v_bf16:
        return ln_attention_s8_reference(x, p.ln)
    ln = p.ln
    xf = x.float()
    if x8 is None:
        x8 = ln_quant_reference(xf, ln.ln_w, ln.ln_b, p.padded.xs, ln.eps)
    out = _padded_core(x8, p.padded).float() * p.padded.out_scale
    return ((xf + out) + ln.out_b).to(torch.bfloat16)


@functools.cache
def _ln_padded_kernel():
    fn = _build.load("attention_s8").ldmseg_attention_ln_padded_s8
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                   + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _ln_padded_launch(x: torch.Tensor, p: LNRowMajorPack) -> torch.Tensor:
    """K10 without ``v_bf16``: K3's LN rows, K11's int8 operands."""
    b, t, c = x.shape
    ln, pd = p.ln, p.padded
    h = ln.heads
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"K10: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if c // h > MAX_HEAD_DIM or b * h > 65535 or x.numel() >= 2 ** 31:
        raise ValueError(f"K10: head dim {c // h} (<= {MAX_HEAD_DIM}), "
                         f"B*heads {b * h} or {x.numel()} elements not "
                         f"taken")
    try:
        plans = _padded_plans_c(b, t, c, h)
    except ValueError as e:
        raise ValueError(f"K10: {e}") from None
    x = x.contiguous()
    ops = (ln.ln_w, ln.ln_b, ln.out_b, pd.w_qkv, pd.m_qkv, pd.wo_q, pd.ratio)
    if any(o.device != x.device or not o.is_contiguous() for o in ops):
        raise ValueError("K10: the pack must be contiguous on x's device")
    dev = x.device
    out = torch.empty((b, t, c), dtype=torch.bfloat16, device=dev)
    scratch = _padded_scratch(b, t, c, h, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _ln_padded_kernel()(
            _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
            ln.ln_w.data_ptr(), ln.ln_b.data_ptr(), ln.out_b.data_ptr(),
            pd.w_qkv.data_ptr(), pd.m_qkv.data_ptr(), pd.wo_q.data_ptr(),
            pd.ratio.data_ptr(), *(z.data_ptr() for z in scratch), b, t, c,
            h, pd.xs, pd.score_scale, pd.out_scale, ln.eps, plans, stream)
    if err != 0:
        raise RuntimeError(f"K10 launch failed: CUDA error {err}")
    return out


def ln_attention_s8_rowmajor(x: torch.Tensor, p: LNRowMajorPack,
                             v_bf16: bool = True) -> torch.Tensor:
    """K10: ``x + to_out(attention(LN(x))) + b_out`` for ``x [B, T, C]`` in
    the row-major TPU kernel's two variants, returned in x's dtype (the
    kernel's result is bf16, cast as the JAX wrapper's ``.astype``). Shapes
    K3's rule sends away take :func:`ln_attention_s8_fallback` (:1107-1117)
    and count in ``ln_attention_s8_rowmajor.fallbacks``."""
    b, t, c = x.shape
    if not absorbed_takes_kernel(t, c, p.ln.heads):
        ln_attention_s8_rowmajor.fallbacks += 1
        return ln_attention_s8_fallback(x, p.ln)
    if x.device.type == "cpu":
        return ln_attention_s8_rowmajor_reference(x, p, v_bf16).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"K10: unsupported device {x.device}")
    out = _launch(x, p.ln, "K10") if v_bf16 else _ln_padded_launch(x, p)
    ln_attention_s8_rowmajor.launches += 1
    return out.to(x.dtype)


ln_attention_s8_rowmajor.launches = 0
ln_attention_s8_rowmajor.fallbacks = 0


# ---------------------------------------------------------------------------
# K17 and K18
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class AbsorbedAttentionPack:
    """K17's operands for one self-attention."""

    heads: int
    xs: float              # the input's static int8 scale
    w_qkv: torch.Tensor    # int8 [3ci, C]: to_q, to_k, to_v rows (out, in)
    wo_q: torch.Tensor     # int8 [C, ci] (out, in)
    w_scale: torch.Tensor  # [4, H] per-head scales of q, k, v, o
    wo_p: torch.Tensor     # int8 [C, H·dp]: wo_q head-padded (head_padded_wo)
    # ci = heads·d: C, or a model axis's heads of a rank (apply_tp's cut)


def head_padded_wo(wo_q: torch.Tensor, heads: int) -> torch.Tensor:
    """``to_out``'s codes ``[C, ci]`` (out, in; ``ci = heads·d``) as K17's
    per-head product reads them: ``[C, H, dp]`` with each head's d input
    columns padded with zeros to dp = d rounded up to 32 (a k32 step of the
    int8 product), so that each head's sums end on a step and the padding
    adds nothing."""
    c = wo_q.shape[0]
    d = wo_q.shape[1] // heads
    dp = head_padded_width(d)
    out = wo_q.new_zeros((c, heads, dp))
    out[:, :, :d] = wo_q.reshape(c, heads, d)
    return out.reshape(c, heads * dp).contiguous()


@torch.no_grad()
def pack_absorbed_attention(attn, heads: int,
                            xs: float) -> AbsorbedAttentionPack:
    """Quantize an attention's ``to_q/k/v/to_out`` weights per head
    (``quantize_head_weights``: the in-graph quantize of
    ``CrossAttention._absorbed``'s int8 branch, :201-208, and the storage of
    ``prequantize_conv_tree(absorbed_attention=True)``, :192-222). Under
    tensor parallelism ``attn`` holds this rank's ``heads`` (``to_q/k/v``
    ``[ci, C]``, ``to_out`` ``[C, ci]``): the per-head scales are local to
    a head, so the pack is the slice of one rank's bit for bit."""
    q8, k8, v8, o8, scales = quantize_head_weights(
        attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
        attn.to_out[0].weight, heads)
    return AbsorbedAttentionPack(
        heads=heads, xs=f32(xs), w_qkv=torch.cat([q8, k8, v8]).contiguous(),
        wo_q=o8.contiguous(), w_scale=scales.contiguous(),
        wo_p=head_padded_wo(o8, heads))


def _per_head(w_scale: torch.Tensor, heads: int) -> torch.Tensor:
    """``[4, H]`` scales: K17's as they are, K18's ``[4]`` repeated per head
    (the same values)."""
    if w_scale.dim() == 1:
        return w_scale.float()[:, None].expand(4, heads).contiguous()
    return w_scale.float().contiguous()


def absorbed_attention_s8_reference(x: torch.Tensor, w_qkv: torch.Tensor,
                                    wo_q: torch.Tensor,
                                    w_scale: torch.Tensor, heads: int,
                                    scale: float, act_scale: float,
                                    per_image: bool = False,
                                    partial: bool = False
                                    ) -> torch.Tensor:
    """K17's arithmetic in plain PyTorch (``[B, T, C]`` -> bf16), or K18's
    with ``per_image`` (and ``[4]`` per-tensor scales), in fp32: ``x8 =
    clip(rint(x / xs))``; ``y = float(int32 x8·W8ᵀ)·(xs·ws[h])``; ``ys =
    max(amax|y|, 1e-6) / 127`` per (image, head) over ``[T, d]`` (per image
    over ``[T, C]``), ``y8 = rint(y / ys)``; per (image, head) ``s =
    float(q8·k8ᵀ)·((qs·ks)·scale)``, ``e = exp((s - rowmax) + ln 127)``,
    ``denom = Σe``, ``e8 = rint(e)``, ``oh = (float(e8·v8)·vs) / denom``,
    ``os = max(amax|oh|, 1e-6) / 127``, ``oh8 = rint(oh / os)``; ``out =
    Σ_h float(oh8_h·Wo8[:, h]ᵀ)·(os·wos[h])``, h = 0 first, as bf16. Every
    division is by a tensor on x's device, a true division as the
    kernel's. ``partial`` (K17 on a rank's ``heads``: ``w_qkv [3ci, C]``,
    ``wo_q [C, ci]``): the fp32 sum over these heads, not rounded."""
    b, t, c = x.shape
    ci = w_qkv.shape[0] // 3
    d = ci // heads
    dev = x.device

    def dev_f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    ws = _per_head(w_scale, heads)
    xs = dev_f32(f32(act_scale))
    x8 = quantize_s8(x, xs)
    fac = (xs * ws[:3]).repeat_interleave(d, dim=1).reshape(3 * ci)
    y = exact_int8_matmul(x8, w_qkv).float() * fac             # [B, T, 3ci]
    groups = 1 if per_image else heads
    y = y.reshape(b, t, 3, groups, ci // groups)
    ys = y.abs().amax(dim=(1, 4), keepdim=True).clamp_min(1e-6) / dev_f32(
        127.0)                                                # [B, 1, 3, G, 1]
    y8 = torch.round(y / ys).to(torch.int8).reshape(b, t, 3, heads, d)
    ys = ys.reshape(b, 3, groups).repeat_interleave(heads // groups, dim=2)
    q8, k8, v8 = (y8[:, :, i].transpose(1, 2) for i in range(3))  # [B,H,T,d]
    qs, ks, vs = (ys[:, i, :, None, None] for i in range(3))      # [B,H,1,1]
    s = exact_int8_matmul(q8, k8).float() * ((qs * ks) * dev_f32(scale))
    e = torch.exp((s - s.amax(-1, keepdim=True)) + LN127)
    denom = e.sum(-1, keepdim=True)
    e8 = torch.round(e).to(torch.int8)
    oh = (exact_int8_matmul(e8, v8.transpose(-1, -2)).float() * vs) / denom
    os_ = oh.abs().amax(dim=(2, 3), keepdim=True).clamp_min(1e-6) / dev_f32(
        127.0)                                                # [B, H, 1, 1]
    oh8 = torch.round(oh / os_).to(torch.int8)
    out = None
    for h in range(heads):
        c32 = exact_int8_matmul(oh8[:, h], wo_q[:, h * d:(h + 1) * d])
        contrib = c32.float() * (os_[:, h] * ws[3, h])
        out = contrib if out is None else out + contrib
    return out if partial else out.to(torch.bfloat16)


def absorbed_attention_s8_fallback(x: torch.Tensor, w_qkv: torch.Tensor,
                                   wo_q: torch.Tensor, w_scale: torch.Tensor,
                                   heads: int, scale: float,
                                   partial: bool = False) -> torch.Tensor:
    """The float branch of ``absorbed_self_attention_s8`` (:488-492) and of
    ``absorbed_fullc_self_attention_s8`` (:631-638) for the shapes the
    kernels do not take: float attention on the dequantized weights, x
    unquantized, in x's dtype (``partial``: a rank's heads, fp32, not
    rounded)."""
    out = _dequantized_attention(x.float(), w_qkv, wo_q,
                                 _per_head(w_scale, heads), heads, scale)
    return out if partial else out.to(x.dtype)


@functools.cache
def _absorbed_s8_kernel(fullc: bool):
    lib = _build.load("attention_s8")
    fn = (lib.ldmseg_attention_absorbed_fullc_s8 if fullc
          else lib.ldmseg_attention_absorbed_s8)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def absorbed_s8_plans(b: int, t: int, c: int, heads: int,
                      ci: Optional[int] = None) -> tuple:
    """K17's (and K18's) three launch plans: the int8 ``[B·T, 3ci, C]``
    projection, the attention stage and the per-head ``to_out`` ``[B·T, C,
    H·dp]`` (``ci = heads·d``: C, or a rank's heads in the partial mode).
    Raises ``ValueError`` on a shape the products do not take."""
    rows = b * t
    ci = c if ci is None else ci
    d = ci // heads
    if not gemm_takes(c, c, "int8"):
        raise ValueError(f"C={c} must be a multiple of 16 (the rows of the "
                         f"int8 projection's operands)")
    return (sm90_gemm_plan(rows, 3 * ci, c, "int8"),
            sm90_s8pv_attention_plan(b * heads, t, d),
            sm90_gemm_plan(rows, c, heads * head_padded_width(d), "int8"))


@functools.lru_cache(maxsize=None)
def _absorbed_plans_c(b: int, t: int, c: int, heads: int,
                      ci: Optional[int] = None):
    return plans_c(*absorbed_s8_plans(b, t, c, heads, ci))


def _absorbed_s8_launch(name: str, x: torch.Tensor, w_qkv: torch.Tensor,
                        wo_q: torch.Tensor, w_scale: torch.Tensor,
                        heads: int, scale: float, act_scale: float,
                        wo_p: Optional[torch.Tensor] = None,
                        partial: bool = False) -> torch.Tensor:
    b, t, c = x.shape
    ci = w_qkv.shape[0] // 3
    fullc = name == "K18"
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    d = ci // heads
    if (d > MAX_HEAD_DIM or b * heads > 65535
            or 3 * x.numel() >= 2 ** 31):
        raise ValueError(f"{name}: head dim {d} (<= {MAX_HEAD_DIM}), "
                         f"B*heads {b * heads} or {x.numel()} elements not "
                         f"taken")
    if (w_qkv.dtype != torch.int8 or wo_q.dtype != torch.int8
            or w_qkv.shape != (3 * ci, c) or wo_q.shape != (c, ci)
            or ci % heads or (ci != c and not partial) or ci > c
            or (fullc and partial)
            or w_scale.shape != ((4,) if fullc else (4, heads))):
        raise ValueError(f"{name}: weights must be int8 [3ci, C] and [C, "
                         f"ci] (ci = C but in K17's partial mode) with "
                         f"scales {'[4]' if fullc else '[4, H]'}, got "
                         f"{tuple(w_qkv.shape)}, {tuple(wo_q.shape)}, "
                         f"{tuple(w_scale.shape)}")
    if not float(scale) > 0:
        raise ValueError(f"{name}: scale {scale} must be > 0 (the kernel "
                         f"takes the row max of the int32 scores)")
    try:
        plans = _absorbed_plans_c(b, t, c, heads, ci)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if wo_p is None:
        wo_p = head_padded_wo(wo_q, heads)
    ws = _per_head(w_scale, heads)
    ops = (w_qkv, wo_p, ws)
    if any(o.device != x.device or not o.is_contiguous() for o in ops):
        raise ValueError(f"{name}: the weights must be contiguous on x's "
                         f"device")
    dp = head_padded_width(d)
    if wo_p.dtype != torch.int8 or wo_p.shape != (c, heads * dp):
        raise ValueError(f"{name}: wo_p must be int8 [C, H*dp] "
                         f"({c}, {heads * dp}), got {tuple(wo_p.shape)}")
    x = x.contiguous()
    dev = x.device
    rows = b * t
    out = torch.empty((b, t, c), device=dev,
                      dtype=torch.float32 if partial else torch.bfloat16)
    x8 = torch.empty((rows, c), dtype=torch.int8, device=dev)
    oh8 = torch.empty((rows, heads * dp), dtype=torch.int8, device=dev)
    y = torch.empty((rows, 3 * ci), dtype=torch.float32, device=dev)
    q8, k8, v8t = _s8_scratch(b, t, heads, d, dev)
    oh = torch.empty((rows, ci), dtype=torch.float32, device=dev)
    # the scales, then as many amax words
    scales = torch.empty(2 * (3 * b * (1 if fullc else heads) + b * heads),
                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _absorbed_s8_kernel(fullc)(
            _DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(),
            w_qkv.data_ptr(), wo_p.data_ptr(), ws.data_ptr(), x8.data_ptr(),
            y.data_ptr(), q8.data_ptr(), k8.data_ptr(), v8t.data_ptr(),
            oh.data_ptr(), oh8.data_ptr(), scales.data_ptr(), b, t, c, ci,
            heads, f32(act_scale), float(scale), plans, int(partial), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def _absorbed_s8(fn, name, x, w_qkv, wo_q, w_scale, heads, scale,
                 act_scale, wo_p=None, partial=False):
    b, t, c = x.shape
    ci = w_qkv.shape[0] // 3
    if not absorbed_takes_kernel(t, ci, heads):
        fn.fallbacks += 1
        return absorbed_attention_s8_fallback(x, w_qkv, wo_q, w_scale, heads,
                                              scale, partial)
    if x.device.type == "cpu":
        out = absorbed_attention_s8_reference(
            x, w_qkv, wo_q, w_scale, heads, scale, act_scale,
            per_image=name == "K18", partial=partial)
    elif x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    else:
        out = _absorbed_s8_launch(name, x, w_qkv, wo_q, w_scale, heads,
                                  scale, act_scale, wo_p, partial)
        fn.launches += 1
    return out if partial else out.to(x.dtype)


def absorbed_self_attention_s8(x: torch.Tensor, w_qkv: torch.Tensor,
                               wo_q: torch.Tensor, w_scale: torch.Tensor,
                               heads: int, scale: float, act_scale: float,
                               wo_p: Optional[torch.Tensor] = None,
                               partial: bool = False) -> torch.Tensor:
    """K17: ``to_out(attention(x))`` without the ``to_out`` bias for ``x
    [B, T, C]`` (no gradient) on ``quantize_head_weights``' codes (``w_qkv
    [3C, C]``, ``wo_q [C, C]``, ``w_scale [4, H]``), x quantized with the
    static ``act_scale``; returned in x's dtype, the kernel's bf16 result
    cast as the JAX wrapper casts it. ``wo_p``: ``wo_q`` head-padded as
    :func:`head_padded_wo` makes it (a pack's, made once); on the card
    without it the wrapper pads per call.

    ``partial`` (a model axis: ``heads`` of this rank, ``w_qkv [3ci, C]``,
    ``wo_q [C, ci]``, ``w_scale [4, heads]``, ``ci = heads·d``): the fp32
    ``to_out`` sum over these heads alone, not rounded
    (``csrc/attention_s8.cu:ldmseg_attention_absorbed_s8``, ``partial``
    1). The
    scales are per (image, head) and x's is static, so a rank's heads need
    nothing of the others; the caller sums the ranks' partials over the
    model group and rounds once to bf16 (``models/unet.py:
    AbsorbedAttentionS8``)."""
    return _absorbed_s8(absorbed_self_attention_s8, "K17", x, w_qkv, wo_q,
                        w_scale, heads, scale, act_scale, wo_p, partial)


absorbed_self_attention_s8.launches = 0
absorbed_self_attention_s8.fallbacks = 0


def absorbed_fullc_self_attention_s8(x: torch.Tensor, w_qkv: torch.Tensor,
                                     wo_q: torch.Tensor,
                                     w_scale: torch.Tensor, heads: int,
                                     scale: float, act_scale: float,
                                     wo_p: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """K18 (an op): K17's function on ``quantize_fullc_weights``' codes and
    per-tensor scales (``w_scale [4]``), with the projections' dynamic
    scales per image; returned in x's dtype. ``wo_p`` as K17's."""
    return _absorbed_s8(absorbed_fullc_self_attention_s8, "K18", x, w_qkv,
                        wo_q, w_scale, heads, scale, act_scale, wo_p)


absorbed_fullc_self_attention_s8.launches = 0
absorbed_fullc_self_attention_s8.fallbacks = 0
