"""The SD-1.4 denoising UNet, NCHW (counterpart of
``ldmseg_tpu/models/unet.py``).

conv_in -> down blocks (resnets + Transformer2D) -> mid (resnet, attention,
resnet) -> up blocks with skip concatenation -> GN/SiLU/conv_out, with
sinusoidal time embeddings. Self-attention goes to K16
(``ops/attention.py:absorbed_self_attention``, the projections inside) when
``use_absorbed_attention`` is set, else to K14
(``fused_self_attention_packed``) when ``use_packed_attention`` is, else to
K1 (``fused_self_attention``) when ``use_fused_attention`` is, else to the
plain einsum path. Parameter names are the diffusers keys that
``ldmseg_tpu/models/torch_export.py:unet_sd_from_params`` emits.

The SD time embedding (``flip_sin_to_cos``, no frequency shift); K1/K2
make the fused self-attention differentiable. The reference surgery is
config, as in JAX (:9-25):

- ``use_cross_attention`` puts ``norm2`` + ``attn2`` between each block's
  self-attention and its FF (:485-489): ``attn2`` reads the context
  (``encoder_hidden_states`` ``[B, T, cross_attention_dim]``, after
  ``encoder_hid_proj`` when ``encoder_hid_dim`` > 0, or the learnable
  ``object_queries`` broadcast over the batch when ``num_object_queries``
  > 0, :862-868) with the plain einsum and an fp32 softmax (:328-331),
  never a kernel: JAX sends only self-attention to one. The port's
  default is without it, the trainer's ``image_descriptors: remove``; JAX's
  ``UNetConfig`` defaults to True. The context runs in the sample's dtype.
- ``separate_conv`` (:923-927): the input split in half along the
  channels, ``conv_in_seg`` on the first half plus ``conv_in`` on the
  second.
- ``separate_encoder`` (:884-922): the same split, ``conv_in`` on the
  first half and an image path (``conv_in_img`` and ``down_blocks_img``,
  the time embedding of ``timesteps_img``, 0 by default, through the
  shared MLP) on the second, whose outputs are added to the skips; with
  ``add_adaptor`` each of them passes a zero-initialised 3x3 conv
  (``adaptors``) first.
- ``upscaler_classes`` > 0 replaces ``conv_out`` with :class:`UpscalerHead`
  (:795-814), logits at twice the latent size.

The int8 UNet of ``sampling_kwargs.int8_inference`` is this class built with
``use_int8_conv`` (s8 resnet, Downsample and Upsample convs,
``ops/quant.py:QuantConv2d``) and the transformer flags the JAX trainer
sets (:163-176). The transformer block reads them as JAX's
``BasicTransformerBlock`` does (:456-503), from ``fuse_attn =
use_fused_norms and use_padded_attention`` and ``fuse_ff = use_fused_norms
and use_int8_ff and use_fused_ff``:

- ``fuse_attn``: the attention block is K3 (``x = K3(x)``); else ``x +
  attn1(norm1(x))`` with ``attn1``, the first that applies as in JAX's
  ``CrossAttention`` (:280-331): K11 under ``use_padded_attention`` (int8
  projections, attention and ``to_out`` in one kernel, on weights
  quantized per head); under ``use_absorbed_attention`` K16 (the four
  projections inside, bf16 or fp32), or K17 with ``use_int8_attention``
  (int8 weights quantized per head, dynamic scales per image and head);
  under ``use_packed_attention`` float projections around K14 on the
  ``[B, T, C]`` layout, or K15 with ``use_int8_attention``; under
  ``use_fused_attention`` K13 with ``use_int8_attention``, else K1; the
  plain path;
- ``fuse_ff``: the FF block is K4 (``x = K4(x)``); else ``x +
  ff(norm3(x))`` with ``use_int8_ff`` a ``FeedForwardS8`` (K12 with
  ``use_fused_ff``, else two QuantLinears around the exact gelu) or the
  float FF.

``use_fused_projs`` (taken only with ``use_fused_norms``, :547-560) moves
Transformer2D's 1x1 ``proj_in``/``proj_out`` into the two kernels: K8 (K3
with a bf16 ``proj_in`` prologue on the GroupNorm output) and K9 (K4 with a
bf16 ``proj_out`` epilogue); it needs ``fuse_attn`` and ``fuse_ff``. None of
the flags changes the parameter keys of a float UNet.

So with fused norms the packed and absorbed flags do nothing (K3 + K4
run), ``use_absorbed_attention`` wins over ``use_packed_attention`` and
both over ``use_fused_attention``, which the trainer sets by default.

The int8 UNet's s8 convs and linears hold the float convs' and linears'
weights (their keys; training through int8 runs them straight-through
before a prepare), its fused int8 blocks none (K11 and K17 keep their
attention's: they are its parameter keys): ``ops/quant.py:
prepare_int8_unet`` fills them from a float UNet.

Training: ``dropout`` drops or scales the UNet's input (unet.py:870-878;
``standard`` or ``gaussian``), with the mask or the noise handed in as
``forward(..., dropout=...)`` (:func:`draw_input_dropout` makes it from a
generator), outside every rematerialised block; ``gradient_checkpointing``
rematerialises each down and up block in the backward
(``torch.utils.checkpoint``, non-reentrant; JAX ``nn.remat``, :931-939,
:993-994; the mid block is not, as in JAX) with ``remat_policy`` mapped to
a selective checkpoint (:data:`REMAT_POLICIES`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (absorbed_self_attention, fused_self_attention,
                             fused_self_attention_packed)
from ..ops.attention_s8 import (absorbed_self_attention_s8,
                                fused_self_attention_packed_s8,
                                fused_self_attention_s8, ln_attention_s8,
                                ln_attention_s8_pin, pack_absorbed_attention,
                                pack_ln_attention, pack_padded_attention,
                                padded_attention_s8, with_proj_in)
from ..ops.geglu import (fused_geglu_s8, geglu_ln_s8, geglu_ln_s8_pout,
                         pack_geglu, pack_geglu_s8, with_proj_out)
from ..ops.quant import QuantConv2d, QuantLinear

# jax.checkpoint_policies names -> the aten ops whose outputs a remat site
# keeps (None: keep nothing, recompute everything; "all": keep everything)
_WEIGHT_PRODUCTS = ("mm", "addmm", "convolution")
REMAT_POLICIES = {
    None: None,
    "nothing_saveable": None,
    "everything_saveable": "all",
    "dots_saveable": _WEIGHT_PRODUCTS + ("bmm", "baddbmm"),
    "checkpoint_dots": _WEIGHT_PRODUCTS + ("bmm", "baddbmm"),
    "dots_with_no_batch_dims_saveable": _WEIGHT_PRODUCTS,
    "checkpoint_dots_with_no_batch_dims": _WEIGHT_PRODUCTS,
}


def remat_context_fn(policy: Optional[str]):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a
    ``remat_policy`` name (None for full recompute); an unknown name
    raises."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: the port maps "
                         f"{sorted(k for k in REMAT_POLICIES if k)}")
    keep = REMAT_POLICIES[policy]
    if keep is None:
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    ops = None if keep == "all" else {
        getattr(torch.ops.aten, name).default for name in keep}

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if ops is None or op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(create_selective_checkpoint_contexts,
                             policy_fn)


def draw_input_dropout(shape, rate: float, mode: str,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """The input dropout's draw: the keep mask (``u < 1 - rate``,
    ``standard``) or the standard normal noise (``gaussian``)."""
    if mode == "standard":
        return torch.rand(shape, generator=generator, device=device) < \
            1.0 - rate
    if mode == "gaussian":
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f"dropout_mode {mode!r}")


def input_dropout(sample: torch.Tensor, rate: float, mode: str,
                  draw: torch.Tensor) -> torch.Tensor:
    """unet.py:870-878: ``standard`` keeps ``sample / (1 - rate)`` where
    the mask is True; ``gaussian`` multiplies by ``1 + std * noise`` with
    ``p = rate / (1 - rate)``, ``std = sqrt(p / (1 - p))`` (the JAX
    formula, as it stands)."""
    if mode == "standard":
        return torch.where(draw.to(torch.bool), sample / (1.0 - rate),
                           torch.zeros_like(sample))
    p = rate / (1.0 - rate)
    std = (p / (1.0 - p)) ** 0.5
    return sample * (1.0 + std * draw.to(sample.dtype))
from .layers import (ConvTranspose2x, GroupNorm, LayerNorm, LayerNorm2d,
                     ResnetBlock, TimestepEmbedding, conv3x3,
                     timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.4 defaults; the fields of the JAX ``UNetConfig`` (its
    ``cond_channels`` is in ``in_channels`` here), among them flags that a
    caller sets only through ``unet_config``: the resnet norms'
    ``use_pallas_gn`` (K5) and ``int8_fuse_gn`` (K6, with
    ``use_int8_conv``), ``use_absorbed_attention`` (K16, K17),
    ``use_packed_attention`` (K14, K15), ``use_padded_attention`` (K11) and
    ``use_fused_projs`` (K8, K9). ``use_cross_attention`` defaults to
    False (JAX: True), the trainer's default descriptor ``remove``."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # = number of heads (SD v1 semantics)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    use_cross_attention: bool = False
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    # the surgery (unet.py:57-65)
    separate_conv: bool = False
    separate_encoder: bool = False
    add_adaptor: bool = False
    upscaler_classes: int = 0  # > 0 replaces conv_out with UpscalerHead
    upscaler_dim: int = 256
    num_object_queries: int = 0
    # > 0: encoder_hid_proj, Linear(encoder_hid_dim, cross_attention_dim),
    # on the context (JAX's nn.Dense infers this input width)
    encoder_hid_dim: int = 0
    use_fused_attention: bool = False
    # K16, the projections inside (K2 in its backward), K17 with
    # use_int8_attention; wins over use_packed_attention and
    # use_fused_attention, loses to use_padded_attention
    use_absorbed_attention: bool = False
    # K14 on [B, T, C] (K2 as its backward), K15 with use_int8_attention;
    # wins over use_fused_attention
    use_packed_attention: bool = False
    # K11 (inference only), or K3 with use_fused_norms
    use_padded_attention: bool = False
    # int8 inference (unet.py:79-94): s8 resnet/Down/Upsample convs and the
    # transformer flags as in JAX
    use_int8_conv: bool = False
    use_int8_attention: bool = False  # K13 (with use_fused_attention)
    use_int8_ff: bool = False         # s8 feed-forward
    use_fused_ff: bool = False        # K12, or K4 with use_fused_norms
    use_fused_norms: bool = False
    use_fused_projs: bool = False     # K8 + K9 (with use_fused_norms)
    int8_act_scale: Optional[float] = None       # None: dynamic amax
    # the q/k/v scale: None is 0.1 for K3, K8 and K11 (the input's scale)
    # and a dynamic amax for K13
    int8_attn_act_scale: Optional[float] = None
    # the resnets' GN + SiLU pairs (unet.py:70, :94): K5, and with
    # use_int8_conv K6 feeding the s8 convs (inference only)
    use_pallas_gn: bool = False
    int8_fuse_gn: bool = False
    # training: the input dropout (its draw passed to forward) and the
    # down/up blocks' rematerialisation with a jax.checkpoint_policies name
    dropout: float = 0.0
    dropout_mode: str = "standard"
    gradient_checkpointing: bool = False
    remat_policy: Optional[str] = None


class CrossAttention(nn.Module):
    """Multi-head attention (diffusers Attention), self-attention without a
    ``context``: q/k/v without bias, out projection with bias; the
    projections stay float (unet.py:290-327). ``context_dim`` (``attn2``)
    sizes ``to_k``/``to_v`` for the context; with a context the attention
    is the plain einsum with an fp32 softmax whatever the flags (JAX sends
    only self-attention to a kernel, :280-331).
    ``absorbed`` (float only) sends it to K16 with the four weights
    (``CrossAttention._absorbed``'s float branch, :209-216: the ``to_out``
    bias added outside, in the output's dtype); else ``packed`` to K14 on
    the projections' ``[B, T, C]``, or with ``int8`` to K15 (always dynamic
    scales); else ``use_fused`` to K1, or with ``int8`` to K13 with the
    static q/k/v scale ``int8_act_scale`` (None: a dynamic amax each).

    An int8 attention takes the calibration key ``to_q`` and ignores it:
    JAX records that scale (quant.py:607-613), but with float projections
    no quantized leaf holds it, so K13 keeps ``int8_act_scale`` and K15
    its dynamic scales.

    Every path takes its head count from the projections' width: under
    tensor parallelism (``parallel/tp.py:apply_tp``, where the axis
    divides the heads) they hold this rank's heads and ``tp_group`` (the
    model group's reductions and collectives, which ``apply_tp`` sets) is
    set. Then K13's and K15's dynamic scales take the amax over all the
    heads (``group.max``); K14 attends over the rank's heads between
    ``to_q``/``to_k``/``to_v`` kept local and the row-parallel ``to_out``,
    as K1 does; and K16, whose kernel reads the four weights itself (its
    ``to_out`` stays a plain ``Linear`` holding this rank's columns), runs
    its partial mode on x through ``copy_to`` (the gradient summed over the
    ranks), the ranks' fp32 partials summed with ``reduce_from`` (the
    gradient passes) and rounded once, then the bias. Where the axis does
    not divide the heads, q, k and v are gathered for K1, K13, K14 and K15,
    and an absorbed attention stays whole on every rank."""

    tp_group = None

    def __init__(self, query_dim: int, heads: int, use_fused: bool = False,
                 int8: bool = False, int8_act_scale: Optional[float] = None,
                 packed: bool = False, absorbed: bool = False,
                 context_dim: Optional[int] = None):
        super().__init__()
        if absorbed and int8:
            raise ValueError("the int8 absorbed attention is "
                             "AbsorbedAttentionS8 (K17)")
        self.heads = heads
        self.use_fused, self.packed = use_fused, packed
        self.absorbed = absorbed
        self.int8, self.int8_act_scale = int8, int8_act_scale
        if int8:
            self.act_scale_sites = {"to_q": None}
        kv_dim = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_v = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.heads
        scale = hd ** -0.5
        is_self = context is None
        if is_self and self.absorbed:
            ws = (self.to_q.weight, self.to_k.weight, self.to_v.weight,
                  self.to_out[0].weight)
            heads = ws[0].shape[0] // hd
            g = self.tp_group
            if g is None:
                out = absorbed_self_attention(x, *ws, heads, scale)
            else:
                part = absorbed_self_attention(g.copy_to(x), *ws, heads,
                                               scale, partial=True)
                out = g.reduce_from(part).to(x.dtype)
            return out + self.to_out[0].bias.to(out.dtype)
        if is_self and self.packed:
            q, k, v = (proj(x) for proj in (self.to_q, self.to_k, self.to_v))
            heads = q.shape[-1] // hd
            if self.int8:
                out = fused_self_attention_packed_s8(q, k, v, heads, scale,
                                                     self.tp_group)
            else:
                out = fused_self_attention_packed(q, k, v, heads, scale)
            return self.to_out[0](out)
        src = x if is_self else context
        q = self.to_q(x).reshape(b, t, -1, hd)
        k, v = (proj(src).reshape(b, src.shape[1], -1, hd)
                for proj in (self.to_k, self.to_v))
        if is_self and self.use_fused and self.int8:
            out = fused_self_attention_s8(q, k, v, scale,
                                          self.int8_act_scale,
                                          self.tp_group)
        elif is_self and self.use_fused:
            out = fused_self_attention(q, k, v, scale)
        else:
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.to_out[0](out.reshape(b, t, -1))


class PaddedAttentionS8(CrossAttention):
    """``attn1`` under ``use_padded_attention`` without fused norms
    (``CrossAttention._absorbed_padded`` without ``ln``, :218-277): K11 on
    the int8 codes of the four projections (``to_out`` without its bias,
    which is added here in the output's dtype). The float projections stay
    as parameters: the JAX tree keeps them. The int8 UNet packs K11's
    operands once per call (:meth:`prepare`, from the float masters);
    otherwise each forward quantizes its own weights, as JAX does in the
    graph, with the same values. The input's scale is the calibrated
    ``to_q`` site (``x_scale``), else ``act_scale``. Inference only: JAX
    has no gradient for K11, so a forward that autograd would record
    raises.

    Under tensor parallelism (``parallel/tp.py:apply_tp``, where the axis
    divides the heads) the four projections are plain ``Linear`` layers
    holding this rank's heads and ``tp_group`` is the model group: the pack
    takes the group's ``max(wos)``, K11 writes the int32 ``to_out`` partial
    of the rank's heads, summed over the group exactly and rounded once, as
    one rank's kernel rounds, then the bias. Where the axis does not divide
    the heads the attention stays whole on every rank, its pack made from
    the masters gathered whole (``tp.whole_attention``)."""

    act_scale_sites = {"to_q": "x_scale"}

    def __init__(self, query_dim: int, heads: int, act_scale: float):
        super().__init__(query_dim, heads)
        self.act_scale = act_scale
        self.x_scale: Optional[float] = None
        self.pack = None

    def _xs(self) -> float:
        return self.act_scale if self.x_scale is None else self.x_scale

    def prepare(self, src: CrossAttention) -> None:
        from ..parallel.tp import whole_attention
        if self.tp_group is None:
            src = whole_attention(src)
        self.pack = pack_padded_attention(src, self.heads, self._xs(),
                                          group=self.tp_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad
                                       for p in self.parameters())):
            raise RuntimeError(
                "use_padded_attention (K11) is inference only: run it under "
                "torch.no_grad() on weights that require no gradient")
        pack = (self.pack if self.pack is not None
                else pack_padded_attention(self, self.heads, self._xs(),
                                           group=self.tp_group))
        out = padded_attention_s8(x, pack, self.tp_group)
        return out + self.to_out[0].bias.to(out.dtype)


class AbsorbedAttentionS8(CrossAttention):
    """``attn1`` under ``use_absorbed_attention`` with
    ``use_int8_attention`` (``CrossAttention._absorbed``'s int8 branches,
    :187-208): K17 on the int8 codes of the four projections, quantized per
    head (``to_out`` without its bias, which is added here in the output's
    dtype). The float projections stay as parameters: the JAX tree keeps
    them. The int8 UNet packs K17's codes once per call (:meth:`prepare`,
    from the float masters); otherwise each forward quantizes its own
    weights, as JAX's in-graph branch does, with the same values.

    The input's scale is ``act_scale`` (``int8_attn_act_scale`` or 0.1),
    and the calibrated ``to_q`` site (``x_scale``) only with
    ``absorbed_storage``, which ``prepare_int8_unet(...,
    absorbed_attention=True)`` sets: JAX reads the site only from the
    prequantized leaves of ``prequantize_conv_tree(absorbed_attention=
    True)`` (branch 1), and its in-graph branch on float leaves, which the
    trainer's unfused int8 UNet takes, ignores it. Inference only: JAX has
    no gradient for K17, so a forward that autograd would record raises.

    Under tensor parallelism (``parallel/tp.py:apply_tp``, where the axis
    divides the heads) the four projections hold this rank's heads and
    ``tp_group`` is the model group: K17 runs its partial mode on them,
    the ranks' fp32 partials are summed (``group.sum``) and rounded once to
    bf16, as one rank's kernel rounds, then the bias."""

    act_scale_sites = {"to_q": "x_scale"}

    def __init__(self, query_dim: int, heads: int, act_scale: float):
        super().__init__(query_dim, heads)
        self.absorbed = True
        self.act_scale = act_scale
        self.x_scale: Optional[float] = None
        self.absorbed_storage = False
        self.pack = None

    def _xs(self) -> float:
        if self.absorbed_storage and self.x_scale is not None:
            return self.x_scale
        return self.act_scale

    def _local_heads(self, src: CrossAttention) -> int:
        """The heads ``src``'s projections hold (this rank's under tensor
        parallelism)."""
        return src.to_q.weight.shape[0] * self.heads // \
            src.to_q.weight.shape[1]

    def prepare(self, src: CrossAttention) -> None:
        self.pack = pack_absorbed_attention(src, self._local_heads(src),
                                            self._xs())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad
                                       for p in self.parameters())):
            raise RuntimeError(
                "use_absorbed_attention with use_int8_attention (K17) is "
                "inference only: run it under torch.no_grad() on weights "
                "that require no gradient")
        p = (self.pack if self.pack is not None
             else pack_absorbed_attention(self, self._local_heads(self),
                                          self._xs()))
        c = x.shape[-1]
        args = (x, p.w_qkv, p.wo_q, p.w_scale, p.heads,
                (c // self.heads) ** -0.5, p.xs, p.wo_p)
        if self.tp_group is None:
            out = absorbed_self_attention_s8(*args)
        else:
            part = absorbed_self_attention_s8(*args, partial=True)
            out = self.tp_group.sum(part).to(torch.bfloat16).to(x.dtype)
        return out + self.to_out[0].bias.to(out.dtype)


class GEGLU(nn.Module):
    """``h, gate = split(proj(x))``; ``h * gelu(gate)`` with the exact erf
    gelu (diffusers GEGLU). ``linear(in, out)`` builds ``proj``."""

    def __init__(self, dim: int, inner: int, linear=nn.Linear):
        super().__init__()
        self.proj = linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU to 4x the width and back (diffusers ``ff.net``); ``linear``
    builds both projections. Under tensor parallelism its GEGLU output
    holds a rank's columns and ``tp_group`` (set by ``apply_tp``) is the
    model group's reductions: the calibration takes that site's amax over
    the group."""

    tp_group = None

    def __init__(self, dim: int, linear=nn.Linear):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4, linear), nn.Identity(),
                                  linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class FeedForwardS8(FeedForward):
    """The s8 feed-forward of an int8 block without K4 (unet.py:396-437):
    ``fused``, K12 on the prepared codes of the two ``QuantLinear``s plus
    b2 in the activation dtype; else the ``QuantLinear``s (``QuantDense``)
    around the exact erf gelu. Sites (on the ``QuantLinear``s):
    ``net.0.proj`` (K12's input scale, else ``act_scale`` or 0.05) and
    ``net.2`` (K12's interior scale, else dynamic; the unfused proj_out
    quantizes with the static ``act_scale``). Under tensor parallelism
    (``tp_group``) K12 writes a rank's fp32 partial, summed over the group
    before b2."""

    def __init__(self, dim: int, act_scale: Optional[float], fused: bool):
        super().__init__(dim, functools.partial(QuantLinear,
                                                act_scale=act_scale))
        self.act_scale, self.fused = act_scale, fused
        self.pack = None

    def prepare(self, src: FeedForward) -> None:
        if not self.fused:
            return
        proj_in, proj_out = self.net[0].proj, self.net[2]
        xs = (proj_in.x_scale if proj_in.x_scale is not None
              else self.act_scale or 0.05)
        self.pack = pack_geglu_s8(proj_in, proj_out, src.net[0].proj,
                                  src.net[2], xs, proj_out.x_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return super().forward(x)
        y = fused_geglu_s8(x, self.pack, self.tp_group)
        return y + self.net[2].bias.to(y.dtype)


class LNAttentionS8(nn.Module):
    """``norm1`` + ``attn1`` + residual of an int8 block as K3, or with
    ``proj_in`` as K8 on the GroupNorm output. Its site ``to_q`` takes the
    calibrated scale of the LN1 output (``x_scale``); else ``act_scale``.
    Under tensor parallelism the pack holds a rank's heads and
    ``tp_group`` (set by ``apply_tp``) sums K3's or K8's partial ``to_out``
    products over the model group (K8's ``proj_in`` whole on every rank);
    where the axis does not divide the heads, no group: every rank runs the
    one-rank block on the whole pack."""

    act_scale_sites = {"to_q": "x_scale"}
    tp_group = None

    def __init__(self, heads: int, act_scale: float, proj_in: bool = False):
        super().__init__()
        self.heads, self.act_scale, self.proj_in = heads, act_scale, proj_in
        self.x_scale: Optional[float] = None
        self.pack = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pack is None:
            raise RuntimeError("int8 transformer block not prepared (run "
                               "prepare_int8_unet)")
        if self.proj_in:
            return ln_attention_s8_pin(x, self.pack, self.tp_group)
        return ln_attention_s8(x, self.pack, self.tp_group)


class LNFeedForwardS8(nn.Module):
    """``norm3`` + ``ff`` + residual of an int8 block as K4, or with
    ``proj_out`` as K9, which returns Transformer2D's ``proj_out`` of the
    block's output. Sites: ``net.0.proj`` (LN3 output, ``x_scale``, else
    ``act_scale``) and ``net.2`` (the gated interior, ``g_scale``, else
    dynamic). Under tensor parallelism the pack holds a rank's GEGLU
    columns and ``tp_group`` (set by ``apply_tp``) sums K4's partial
    outputs, and takes a dynamic interior amax, over the model group; K9
    then runs its ``proj_out`` stage (the whole weight) on the summed
    block output."""

    act_scale_sites = {"net.0.proj": "x_scale", "net.2": "g_scale"}
    tp_group = None

    def __init__(self, act_scale: float, proj_out: bool = False):
        super().__init__()
        self.act_scale, self.proj_out = act_scale, proj_out
        self.x_scale: Optional[float] = None
        self.g_scale: Optional[float] = None
        self.pack = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pack is None:
            raise RuntimeError("int8 transformer block not prepared (run "
                               "prepare_int8_unet)")
        if self.proj_out:
            return geglu_ln_s8_pout(x, self.pack, self.tp_group)
        return geglu_ln_s8(x, self.pack, self.tp_group)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attention -> residual, LN -> GEGLU FF -> residual, with
    the flags read as JAX reads them (unet.py:456-503): with ``fuse_attn =
    fused_norms and padded_attention`` the first three are K3 (an
    :class:`LNAttentionS8`, ``x = K3(x)``), else ``norm1`` + ``attn1`` with
    ``attn1`` K11 (``padded_attention``), K17 or K16
    (``absorbed_attention`` with or without ``int8_attention``), K15 or K14
    (``packed_attention``), K13 (``int8_attention`` with ``use_fused``), K1
    (``use_fused``) or the plain path; with ``fuse_ff =
    fused_norms and int8_ff and fused_ff`` the last three are K4 (an
    :class:`LNFeedForwardS8`), else ``norm3`` + a :class:`FeedForwardS8`
    (``int8_ff``) or a float FF; the LayerNorms stay float.
    ``fused_projs`` (from Transformer2D) makes them K8 and K9 and needs both
    fusions and no cross-attention (:469-470). With ``context_dim`` (the
    UNet's ``use_cross_attention``) ``norm2`` + ``attn2`` (a float
    :class:`CrossAttention`, the plain einsum on the context) and a
    residual come between the two halves in every variant: with fused
    norms, K3 -> ``attn2`` in the compute dtype -> K4 (:485-489).
    :meth:`prepare` packs K3's and K4's operands from a float block."""

    def __init__(self, dim: int, heads: int, use_fused: bool = False,
                 int8_attention: bool = False, int8_ff: bool = False,
                 fused_ff: bool = False, fused_norms: bool = False,
                 padded_attention: bool = False, fused_projs: bool = False,
                 packed_attention: bool = False,
                 absorbed_attention: bool = False,
                 int8_act_scale: Optional[float] = None,
                 int8_attn_act_scale: Optional[float] = None,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.fuse_attn = fused_norms and padded_attention
        self.fuse_ff = fused_norms and int8_ff and fused_ff
        if fused_projs and not (self.fuse_attn and self.fuse_ff):
            raise ValueError(
                "use_fused_projs needs the fused attention and FF blocks: "
                "use_fused_norms with use_padded_attention, use_int8_ff and "
                "use_fused_ff (sampling_kwargs.fused_ff)")
        if fused_projs and context_dim:
            raise ValueError("use_fused_projs takes no cross-attention "
                             "(unet.py:469-470)")
        attn_scale = int8_attn_act_scale or 0.1
        if self.fuse_attn:
            self.attn1 = LNAttentionS8(heads, attn_scale, fused_projs)
        else:
            self.norm1 = LayerNorm(dim)
            if padded_attention:
                self.attn1 = PaddedAttentionS8(dim, heads, attn_scale)
            elif absorbed_attention and int8_attention:
                self.attn1 = AbsorbedAttentionS8(dim, heads, attn_scale)
            else:
                self.attn1 = CrossAttention(
                    dim, heads, use_fused=use_fused, int8=int8_attention,
                    int8_act_scale=int8_attn_act_scale,
                    packed=packed_attention, absorbed=absorbed_attention)
        self.cross = bool(context_dim)
        if self.cross:
            self.norm2 = LayerNorm(dim)
            self.attn2 = CrossAttention(dim, heads, context_dim=context_dim)
        if self.fuse_ff:
            self.ff = LNFeedForwardS8(int8_act_scale or 0.05, fused_projs)
        else:
            self.norm3 = LayerNorm(dim)
            self.ff = (FeedForwardS8(dim, int8_act_scale, fused_ff)
                       if int8_ff else FeedForward(dim))

    def prepare(self, src: "BasicTransformerBlock") -> None:
        from ..parallel.tp import whole_attention
        a, f = self.attn1, self.ff
        if self.fuse_attn:
            xs = a.act_scale if a.x_scale is None else a.x_scale
            # a rank's heads where apply_tp gave K3 the group, else the
            # whole attention (the masters' cut gathered)
            attn = src.attn1 if a.tp_group is not None else \
                whole_attention(src.attn1)
            a.pack = pack_ln_attention(src.norm1, attn, self.heads, xs)
        if self.fuse_ff:
            xs = f.act_scale if f.x_scale is None else f.x_scale
            f.pack = pack_geglu(src.norm3, src.ff.net[0].proj, src.ff.net[2],
                                xs, f.g_scale)

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn1(x) if self.fuse_attn else x + self.attn1(self.norm1(x))
        if self.cross:
            x = x + self.attn2(self.norm2(x), context)
        return self.ff(x) if self.fuse_ff else x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN -> 1x1 conv in -> one transformer block over HW tokens -> 1x1
    conv out -> residual. The GN and the 1x1 convs stay float in the int8
    UNet, as in JAX (:561-569), except with ``fused_projs`` and
    ``fused_norms`` (:547-560): the block runs K8 on the GN output and K9,
    which returns ``proj_out``'s output; the convs' weights go into their
    packs (:meth:`prepare`) and the residual is added here."""

    def __init__(self, channels: int, heads: int, groups: int = 32,
                 use_fused: bool = False, int8: Optional[dict] = None,
                 fused_norms: bool = False, padded_attention: bool = False,
                 fused_projs: bool = False, packed_attention: bool = False,
                 absorbed_attention: bool = False,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        # JAX takes fused_projs only with fused_norms and without
        # cross-attention (:547-548)
        self.fused_projs = fused_projs and fused_norms and not context_dim
        block = BasicTransformerBlock(
            channels, heads, use_fused, fused_norms=fused_norms,
            padded_attention=padded_attention,
            fused_projs=self.fused_projs, packed_attention=packed_attention,
            absorbed_attention=absorbed_attention, context_dim=context_dim,
            **(int8 or {}))
        self.transformer_blocks = nn.ModuleList([block])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def prepare(self, src: "Transformer2D") -> None:
        # after the block's own prepare: prepare_int8_unet goes inner first;
        # K8's and K9's 1x1 convs are whole on every rank of a model axis
        # (the masters' cut gathered)
        from ..parallel.tp import whole_layer
        if self.fused_projs:
            blk = self.transformer_blocks[0]
            blk.attn1.pack = with_proj_in(blk.attn1.pack,
                                          whole_layer(src.proj_in))
            blk.ff.pack = with_proj_out(blk.ff.pack,
                                        whole_layer(src.proj_out))

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        if self.fused_projs:
            # the GN output's tokens view; K9 returns a channel-major one
            y = self.norm(x).reshape(b, c, h * w).transpose(1, 2)
            y = self.transformer_blocks[0](y)
            return y.transpose(1, 2).reshape(b, c, h, w) + x
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.transformer_blocks[0](y, context)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


def _sample_conv(channels: int, stride: int, use_int8: bool) -> nn.Module:
    # int8: the residual stream's dynamic per-tensor amax (unet.py:572-615)
    if use_int8:
        return QuantConv2d(channels, channels, stride)
    return conv3x3(channels, channels, stride=stride)


class Downsample(nn.Module):
    def __init__(self, channels: int, use_int8: bool = False):
        super().__init__()
        self.conv = _sample_conv(channels, 2, use_int8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, use_int8: bool = False):
        super().__init__()
        self.conv = _sample_conv(channels, 1, use_int8)

    def forward(self, x: torch.Tensor,
                target_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h, w = x.shape[-2:]
        if target_hw is not None and tuple(target_hw) != (2 * h, 2 * w):
            # odd skip sizes: nearest resize to the skip's resolution with
            # half-pixel centres, as jax.image.resize "nearest" does
            x = F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")
        else:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv(x)


class DownBlock(nn.Module):
    """``res_kw`` and ``attn_kw`` (from :class:`UNet2DCondition`) go to each
    ResnetBlock and Transformer2D; ``res_kw["use_int8"]`` also makes the
    Downsample int8."""

    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 has_attn: bool, heads: int, groups: int, eps: float,
                 add_downsample: bool, temb_channels: int, res_kw: dict,
                 attn_kw: dict):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels,
                        out_channels, groups, eps, temb_channels, **res_kw)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, heads, groups, **attn_kw)
            for _ in range(num_layers)] if has_attn else [])
        self.downsamplers = nn.ModuleList(
            [Downsample(out_channels, res_kw["use_int8"])]
            if add_downsample else [])

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                context: Optional[torch.Tensor] = None):
        res_outputs = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions:
                x = self.attentions[i](x, context)
            res_outputs.append(x)
        for down in self.downsamplers:
            x = down(x)
            res_outputs.append(x)
        return x, res_outputs


class UpBlock(nn.Module):
    """``skip_channels`` lists the channels of the skips the block consumes,
    in the order it pops them."""

    def __init__(self, in_channels: int, skip_channels: Sequence[int],
                 out_channels: int, has_attn: bool, heads: int, groups: int,
                 eps: float, add_upsample: bool, temb_channels: int,
                 res_kw: dict, attn_kw: dict):
        super().__init__()
        resnets = []
        for i, skip in enumerate(skip_channels):
            cin = (in_channels if i == 0 else out_channels) + skip
            resnets.append(ResnetBlock(cin, out_channels, groups, eps,
                                       temb_channels, **res_kw))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, heads, groups, **attn_kw)
            for _ in skip_channels] if has_attn else [])
        self.upsamplers = nn.ModuleList(
            [Upsample(out_channels, res_kw["use_int8"])]
            if add_upsample else [])

    def forward(self, x: torch.Tensor, res_samples: List[torch.Tensor],
                temb: torch.Tensor,
                upsample_size: Optional[Tuple[int, int]] = None,
                context: Optional[torch.Tensor] = None):
        res_samples = list(res_samples)
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_samples.pop()], dim=1), temb)
            if self.attentions:
                x = self.attentions[i](x, context)
        for up in self.upsamplers:
            x = up(x, upsample_size)
        return x


class MidBlockCrossAttn(nn.Module):
    def __init__(self, channels: int, heads: int, groups: int, eps: float,
                 temb_channels: int, res_kw: dict, attn_kw: dict):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, groups, eps, temb_channels,
                        **res_kw)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(channels, heads, groups, **attn_kw)])

    def forward(self, x: torch.Tensor, temb: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        return self.resnets[1](x, temb)


class ZeroConv2d(nn.Conv2d):
    """A 3x3 conv whose seeded init is zero (the adaptors' Flax
    ``kernel_init``/``bias_init``, unet.py:915-918)."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, padding=1)

    @torch.no_grad()
    def random_init_(self, gen: torch.Generator) -> None:
        self.weight.zero_()
        self.bias.zero_()


class ObjectQueries(nn.Module):
    """The learnable queries ``[N, cross_attention_dim]``, drawn from a
    standard normal at init (unet.py:866-867)."""

    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    @torch.no_grad()
    def random_init_(self, gen: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=gen)


class UpscalerHead(nn.Module):
    """``define_upscaler``'s head (unet.py:795-814): conv -> ConvTranspose
    2x -> LayerNorm2d -> SiLU -> conv -> GroupNorm (eps 1e-5) -> SiLU ->
    conv to ``num_classes``."""

    def __init__(self, in_channels: int, num_classes: int, dim: int = 256,
                 groups: int = 32):
        super().__init__()
        self.conv1 = conv3x3(in_channels, dim)
        self.convt = ConvTranspose2x(dim, dim)
        self.ln = LayerNorm2d(dim)
        self.conv2 = conv3x3(dim, dim)
        self.norm = GroupNorm(groups, dim, 1e-5)
        self.conv3 = conv3x3(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.ln(self.convt(self.conv1(x))))
        h = F.silu(self.norm(self.conv2(h)))
        return self.conv3(h)


class UNet2DCondition(nn.Module):
    """The denoiser: ``sample`` ``[B, C_in, H, W]``, ``timesteps`` an int, a
    0-d tensor or ``[B]`` -> ``[B, C_out, H, W]`` in the sample's dtype."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        chans = cfg.block_out_channels
        heads, groups, eps = (cfg.attention_head_dim, cfg.norm_num_groups,
                              cfg.norm_eps)
        int8 = dict(int8_attention=cfg.use_int8_attention,
                    int8_ff=cfg.use_int8_ff, fused_ff=cfg.use_fused_ff,
                    int8_act_scale=cfg.int8_act_scale,
                    int8_attn_act_scale=cfg.int8_attn_act_scale)
        opts = dict(res_kw=dict(use_int8=cfg.use_int8_conv,
                                int8_act_scale=cfg.int8_act_scale,
                                use_pallas_gn=cfg.use_pallas_gn,
                                int8_fuse_gn=cfg.int8_fuse_gn),
                    attn_kw=dict(use_fused=cfg.use_fused_attention,
                                 int8=int8,
                                 fused_norms=cfg.use_fused_norms,
                                 padded_attention=cfg.use_padded_attention,
                                 fused_projs=cfg.use_fused_projs,
                                 packed_attention=cfg.use_packed_attention,
                                 absorbed_attention=(
                                     cfg.use_absorbed_attention),
                                 context_dim=(cfg.cross_attention_dim
                                              if cfg.use_cross_attention
                                              else None)))
        c0 = chans[0]
        temb = c0 * 4
        split = cfg.separate_conv or cfg.separate_encoder
        if split and cfg.in_channels % 2:
            raise ValueError(
                f"separate_conv / separate_encoder split the input's "
                f"{cfg.in_channels} channels in half (jnp.split, "
                f"unet.py:886, :925): an even count is needed")
        cin0 = cfg.in_channels // 2 if split else cfg.in_channels
        self.conv_in = conv3x3(cin0, c0)
        if cfg.separate_conv and not cfg.separate_encoder:
            self.conv_in_seg = conv3x3(cin0, c0)
        self.time_embedding = TimestepEmbedding(c0, temb)
        if cfg.encoder_hid_dim > 0:
            self.encoder_hid_proj = nn.Linear(cfg.encoder_hid_dim,
                                              cfg.cross_attention_dim)
        if cfg.num_object_queries > 0:
            self.object_queries = ObjectQueries(cfg.num_object_queries,
                                                cfg.cross_attention_dim)

        def down_path():
            blocks, skips, cin = [], [c0], c0
            for i, cout in enumerate(chans):
                last = i == len(chans) - 1
                blocks.append(DownBlock(cin, cout, cfg.layers_per_block,
                                        cfg.attn_down[i], heads, groups, eps,
                                        not last, temb, **opts))
                skips += [cout] * (cfg.layers_per_block + (0 if last else 1))
                cin = cout
            return nn.ModuleList(blocks), skips

        self.down_blocks, skips = down_path()
        if cfg.separate_encoder:
            self.conv_in_img = conv3x3(cin0, c0)
            self.down_blocks_img, _ = down_path()
            if cfg.add_adaptor:
                # one per output of each image down block
                self.adaptors = nn.ModuleList([
                    nn.ModuleList([ZeroConv2d(cout) for _ in range(
                        len(blk.resnets) + len(blk.downsamplers))])
                    for blk, cout in zip(self.down_blocks_img, chans)])
        self.mid_block = MidBlockCrossAttn(chans[-1], heads, groups, eps,
                                           temb, **opts)
        up, cin = [], chans[-1]
        rev = list(reversed(chans))
        attn_up = tuple(reversed(cfg.attn_down))
        n_res = cfg.layers_per_block + 1
        for i, cout in enumerate(rev):
            taken, skips = skips[-n_res:], skips[:-n_res]
            up.append(UpBlock(cin, taken[::-1], cout, attn_up[i], heads,
                              groups, eps, i < len(rev) - 1, temb, **opts))
            cin = cout
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(groups, c0, eps)
        if cfg.upscaler_classes > 0:
            self.upscaler = UpscalerHead(c0, cfg.upscaler_classes,
                                         cfg.upscaler_dim, groups)
        else:
            self.conv_out = conv3x3(c0, cfg.out_channels)
        # an unknown policy raises whether or not remat is on, as in JAX
        context_fn = remat_context_fn(cfg.remat_policy)
        self._remat = None
        if cfg.gradient_checkpointing:
            from torch.utils.checkpoint import noop_context_fn
            self._remat = context_fn or noop_context_fn

    def _temb(self, timesteps, sample: torch.Tensor) -> torch.Tensor:
        b = sample.shape[0]
        if isinstance(timesteps, torch.Tensor):
            # no copy on the sample's device: a captured step reads its
            # timestep from the device
            t = timesteps.to(sample.device)
        elif isinstance(timesteps, int):
            t = torch.full((), timesteps, dtype=torch.long,
                           device=sample.device)
        else:
            # a [B] list or array: a host copy, outside any capture
            t = torch.as_tensor(timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(b)
        emb = timestep_embedding(t, self.config.block_out_channels[0])
        # sin/cos and MLP in fp32, then the activation dtype
        return self.time_embedding(emb).to(sample.dtype)

    def forward(self, sample: torch.Tensor, timesteps,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                timesteps_img=None,
                dropout: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``encoder_hidden_states``: the context ``[B, T, D]`` of
        ``attn2`` (``D`` = ``encoder_hid_dim`` with ``encoder_hid_proj``,
        else ``cross_attention_dim``; ignored with object queries, which
        replace it). ``timesteps_img``: the image branch's timestep under
        ``separate_encoder`` (default 0). ``dropout``: the input dropout's
        draw (:func:`draw_input_dropout`, the sample's shape), applied when
        ``config.dropout > 0``."""
        cfg = self.config
        b = sample.shape[0]
        emb = self._temb(timesteps, sample)
        context = encoder_hidden_states
        if context is not None:
            context = context.to(sample.dtype)
            if cfg.encoder_hid_dim > 0:
                context = self.encoder_hid_proj(context)
        if cfg.num_object_queries > 0:
            oq = self.object_queries.weight
            context = oq[None].expand((b,) + tuple(oq.shape))

        if cfg.dropout > 0 and dropout is not None:
            sample = input_dropout(sample, cfg.dropout, cfg.dropout_mode,
                                   dropout)
        remat = self._remat if (cfg.gradient_checkpointing
                                and torch.is_grad_enabled()) else None

        def run(block, *args, **kw):
            if remat is None:
                return block(*args, **kw)
            # the block's weights go in as inputs: the recompute in the
            # backward must read the tensors this forward read (a caller's
            # functional_call, the trainer's compute-dtype cast, has ended
            # by then)
            names, weights = zip(*block.named_parameters())
            n = len(args)

            def fn(*inputs):
                return torch.func.functional_call(
                    block, dict(zip(names, inputs[n:])), inputs[:n], kw)
            return torch.utils.checkpoint.checkpoint(
                fn, *args, *weights, use_reentrant=False, context_fn=remat)

        extra = None
        if cfg.separate_encoder:
            # the image half through its own conv_in and down path, its
            # residuals added to the skips (:884-922, :966-967)
            seg, img = sample.chunk(2, dim=1)
            emb_img = self._temb(0 if timesteps_img is None
                                 else timesteps_img, sample)
            x_img = self.conv_in_img(img)
            extra = [x_img]
            for i, block in enumerate(self.down_blocks_img):
                x_img, res = block(x_img, emb_img, context)
                if cfg.add_adaptor:
                    res = [conv(r) for conv, r in zip(self.adaptors[i], res)]
                extra.extend(res)
            x = self.conv_in(seg)
        elif cfg.separate_conv:
            seg, img = sample.chunk(2, dim=1)
            x = self.conv_in_seg(seg) + self.conv_in(img)
        else:
            x = self.conv_in(sample)
        res_stack = [x]
        for block in self.down_blocks:
            x, res = run(block, x, emb, context)
            res_stack.extend(res)
        if extra is not None:
            res_stack = [r + e for r, e in zip(res_stack, extra)]
        x = self.mid_block(x, emb, context)
        for block in self.up_blocks:
            n = len(block.resnets)
            res, res_stack = res_stack[-n:], res_stack[:-n]
            size = tuple(res_stack[-1].shape[-2:]) if res_stack else None
            x = run(block, x, res, emb, size, context)
        x = F.silu(self.conv_norm_out(x))
        if cfg.upscaler_classes > 0:
            return self.upscaler(x)
        return self.conv_out(x)
