"""The SD-1.4 denoising UNet, NCHW (counterpart of
``ldmseg_tpu/models/unet.py``).

conv_in -> down blocks (resnets + Transformer2D) -> mid (resnet, attention,
resnet) -> up blocks with skip concatenation -> GN/SiLU/conv_out, with
sinusoidal time embeddings. Self-attention goes to K1
(``ops/attention.py:fused_self_attention``) when ``use_fused_attention`` is
set, else to the plain einsum path. Parameter names are the diffusers keys
that ``ldmseg_tpu/models/torch_export.py:unet_sd_from_params`` emits.

The port holds the trainer's default UNet: no cross-attention, a plain
``conv_in``, the SD time embedding (``flip_sin_to_cos``, no frequency
shift). K1/K2 make the fused self-attention differentiable. The rest of
the reference surgery is a later slice.

The int8 UNet of ``sampling_kwargs.int8_inference`` is this class built with
``use_int8_conv`` (s8 resnet, Downsample and Upsample convs,
``ops/quant.py:QuantConv2d``) and the transformer flags the JAX trainer
sets (:163-176), read as JAX's ``BasicTransformerBlock`` reads them
(:467-502):

- ``use_fused_norms``: the attention block is K3 (``x = K3(x)``); with
  ``use_int8_ff`` and ``use_fused_ff`` the FF block is K4 (``x = K4(x)``),
  else ``x + FF(norm3(x))`` with the s8 ``FeedForwardS8`` (QuantLinear);
- without it: ``x + attn1(norm1(x))`` with float projections and, with
  ``use_int8_attention`` and ``use_fused_attention``, the attention on K13;
  ``x + ff(norm3(x))`` with ``use_int8_ff`` a ``FeedForwardS8`` (K12 with
  ``use_fused_ff``, else two QuantLinears around the exact gelu).

Its quantized modules hold no float weights:
``ops/quant.py:prepare_int8_unet`` fills them from a float UNet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_self_attention
from ..ops.attention_s8 import (fused_self_attention_s8, ln_attention_s8,
                                pack_ln_attention)
from ..ops.geglu import fused_geglu_s8, geglu_ln_s8, pack_geglu, pack_geglu_s8
from ..ops.quant import QuantConv2d, QuantLinear
from .layers import (GroupNorm, LayerNorm, ResnetBlock, TimestepEmbedding,
                     conv3x3, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.4 defaults; the fields of the JAX ``UNetConfig`` that the
    sampling path without cross-attention reads, among them the resnet norm
    flags ``use_pallas_gn`` (K5) and ``int8_fuse_gn`` (K6, with
    ``use_int8_conv``), which a caller sets through ``unet_config``."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8  # = number of heads (SD v1 semantics)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    use_fused_attention: bool = False
    # int8 inference (unet.py:79-94): s8 resnet/Down/Upsample convs; the
    # transformer flags as in JAX, where use_fused_norms is JAX's
    # use_fused_norms with use_padded_attention (K3); JAX's packed, absorbed
    # and fused-projs attention paths are not ported
    use_int8_conv: bool = False
    use_int8_attention: bool = False  # K13 (with use_fused_attention)
    use_int8_ff: bool = False         # s8 feed-forward
    use_fused_ff: bool = False        # K12, or K4 with use_fused_norms
    use_fused_norms: bool = False
    int8_act_scale: Optional[float] = None       # None: dynamic amax
    # the q/k/v scale: None is 0.1 for K3 and a dynamic amax for K13
    int8_attn_act_scale: Optional[float] = None
    # the resnets' GN + SiLU pairs (unet.py:70, :94): K5, and with
    # use_int8_conv K6 feeding the s8 convs (inference only)
    use_pallas_gn: bool = False
    int8_fuse_gn: bool = False


class CrossAttention(nn.Module):
    """Multi-head self-attention (diffusers Attention): q/k/v without bias,
    out projection with bias. ``use_fused`` sends it to K1, or with
    ``int8`` to K13 with the static q/k/v scale ``int8_act_scale`` (None: a
    dynamic amax each); the projections stay float (unet.py:290-327).

    An int8 attention takes the calibration key ``to_q`` and ignores it:
    JAX records that scale (quant.py:607-613), but with float projections
    no quantized leaf holds it, so K13 keeps ``int8_act_scale``."""

    def __init__(self, query_dim: int, heads: int, use_fused: bool = False,
                 int8: bool = False, int8_act_scale: Optional[float] = None):
        super().__init__()
        self.heads = heads
        self.use_fused = use_fused
        self.int8, self.int8_act_scale = int8, int8_act_scale
        if int8:
            self.act_scale_sites = {"to_q": None}
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(query_dim, query_dim, bias=False)
        self.to_v = nn.Linear(query_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.heads
        q, k, v = (proj(x).reshape(b, t, self.heads, hd)
                   for proj in (self.to_q, self.to_k, self.to_v))
        scale = hd ** -0.5
        if self.use_fused and self.int8:
            out = fused_self_attention_s8(q, k, v, scale,
                                          self.int8_act_scale)
        elif self.use_fused:
            out = fused_self_attention(q, k, v, scale)
        else:
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.to_out[0](out.reshape(b, t, c))


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
    builds both projections."""

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
    quantizes with the static ``act_scale``)."""

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
        y = fused_geglu_s8(x, self.pack)
        return y + self.net[2].bias.to(y.dtype)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attention -> residual, LN -> GEGLU FF -> residual. In the
    int8 UNet without fused norms the attention may be K13
    (``int8_attention``) and the FF a :class:`FeedForwardS8` (``int8_ff``);
    the LayerNorms stay float."""

    def __init__(self, dim: int, heads: int, use_fused: bool = False,
                 int8_attention: bool = False, int8_ff: bool = False,
                 fused_ff: bool = False,
                 int8_act_scale: Optional[float] = None,
                 int8_attn_act_scale: Optional[float] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, use_fused=use_fused,
                                    int8=int8_attention,
                                    int8_act_scale=int8_attn_act_scale)
        self.norm3 = LayerNorm(dim)
        self.ff = (FeedForwardS8(dim, int8_act_scale, fused_ff) if int8_ff
                   else FeedForward(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        return x + self.ff(self.norm3(x))


class LNAttentionS8(nn.Module):
    """``norm1`` + ``attn1`` + residual of an int8 block as K3. Its site
    ``to_q`` takes the calibrated scale of the LN1 output (``x_scale``);
    else ``act_scale``."""

    act_scale_sites = {"to_q": "x_scale"}

    def __init__(self, heads: int, act_scale: float):
        super().__init__()
        self.heads, self.act_scale = heads, act_scale
        self.x_scale: Optional[float] = None
        self.pack = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_attention_s8(x, self.pack)


class LNFeedForwardS8(nn.Module):
    """``norm3`` + ``ff`` + residual of an int8 block as K4. Sites:
    ``net.0.proj`` (LN3 output, ``x_scale``, else ``act_scale``) and
    ``net.2`` (the gated interior, ``g_scale``, else dynamic)."""

    act_scale_sites = {"net.0.proj": "x_scale", "net.2": "g_scale"}

    def __init__(self, act_scale: float):
        super().__init__()
        self.act_scale = act_scale
        self.x_scale: Optional[float] = None
        self.g_scale: Optional[float] = None
        self.pack = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return geglu_ln_s8(x, self.pack)


class FusedTransformerBlockS8(nn.Module):
    """The int8 UNet's transformer block with fused norms (unet.py:456-503
    with ``fused_norms``): ``x = K3(x)``, each kernel returning the new
    residual stream, then ``x = K4(x)`` with ``fused_ff`` (and ``int8_ff``),
    else ``x + ff(norm3(x))`` with a float LayerNorm and the unfused
    :class:`FeedForwardS8` (or a float FF without ``int8_ff``).
    :meth:`prepare` packs the kernels' operands from a float
    :class:`BasicTransformerBlock`."""

    def __init__(self, dim: int, heads: int,
                 int8_act_scale: Optional[float],
                 int8_attn_act_scale: Optional[float],
                 int8_ff: bool = True, fused_ff: bool = True,
                 int8_attention: bool = False):  # K3 takes the attention
        super().__init__()
        self.heads = heads
        self.attn1 = LNAttentionS8(heads, int8_attn_act_scale or 0.1)
        self.fuse_ff = int8_ff and fused_ff
        if self.fuse_ff:
            self.ff = LNFeedForwardS8(int8_act_scale or 0.05)
        else:
            self.norm3 = LayerNorm(dim)
            self.ff = (FeedForwardS8(dim, int8_act_scale, False) if int8_ff
                       else FeedForward(dim))

    def prepare(self, src: BasicTransformerBlock) -> None:
        a, f = self.attn1, self.ff
        xs_a = a.act_scale if a.x_scale is None else a.x_scale
        a.pack = pack_ln_attention(src.norm1, src.attn1, self.heads, xs_a)
        if self.fuse_ff:
            xs_f = f.act_scale if f.x_scale is None else f.x_scale
            f.pack = pack_geglu(src.norm3, src.ff.net[0].proj, src.ff.net[2],
                                xs_f, f.g_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.attn1.pack is None:
            raise RuntimeError("int8 transformer block not prepared (run "
                               "prepare_int8_unet)")
        x = self.attn1(x)
        return self.ff(x) if self.fuse_ff else x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN -> 1x1 conv in -> one transformer block over HW tokens -> 1x1
    conv out -> residual. The GN and the 1x1 convs stay float in the int8
    UNet, as in JAX (:561-569)."""

    def __init__(self, channels: int, heads: int, groups: int = 32,
                 use_fused: bool = False, int8: Optional[dict] = None,
                 fused_norms: bool = False):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        int8 = int8 or {}
        block = (FusedTransformerBlockS8(channels, heads, **int8)
                 if fused_norms
                 else BasicTransformerBlock(channels, heads, use_fused,
                                            **int8))
        self.transformer_blocks = nn.ModuleList([block])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.transformer_blocks[0](y)
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

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        res_outputs = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions:
                x = self.attentions[i](x)
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
                upsample_size: Optional[Tuple[int, int]] = None):
        res_samples = list(res_samples)
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_samples.pop()], dim=1), temb)
            if self.attentions:
                x = self.attentions[i](x)
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

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x)
        return self.resnets[1](x, temb)


class UNet2DCondition(nn.Module):
    """The denoiser: ``sample`` ``[B, C_in, H, W]``, ``timesteps`` an int or
    ``[B]`` -> ``[B, C_out, H, W]`` in the sample's dtype."""

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
                                 fused_norms=cfg.use_fused_norms))
        c0 = chans[0]
        temb = c0 * 4
        self.conv_in = conv3x3(cfg.in_channels, c0)
        self.time_embedding = TimestepEmbedding(c0, temb)

        skips = [c0]
        down, cin = [], c0
        for i, cout in enumerate(chans):
            last = i == len(chans) - 1
            down.append(DownBlock(cin, cout, cfg.layers_per_block,
                                  cfg.attn_down[i], heads, groups, eps,
                                  not last, temb, **opts))
            skips += [cout] * (cfg.layers_per_block + (0 if last else 1))
            cin = cout
        self.down_blocks = nn.ModuleList(down)
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
        self.conv_out = conv3x3(c0, cfg.out_channels)

    def forward(self, sample: torch.Tensor, timesteps) -> torch.Tensor:
        cfg = self.config
        b = sample.shape[0]
        t = torch.as_tensor(timesteps, device=sample.device)
        if t.dim() == 0:
            t = t.expand(b)
        emb = timestep_embedding(t, cfg.block_out_channels[0])
        # sin/cos and MLP in fp32, then the activation dtype
        emb = self.time_embedding(emb).to(sample.dtype)

        x = self.conv_in(sample)
        res_stack = [x]
        for block in self.down_blocks:
            x, res = block(x, emb)
            res_stack.extend(res)
        x = self.mid_block(x, emb)
        for block in self.up_blocks:
            n = len(block.resnets)
            res, res_stack = res_stack[-n:], res_stack[:-n]
            size = tuple(res_stack[-1].shape[-2:]) if res_stack else None
            x = block(x, res, emb, upsample_size=size)
        x = F.silu(self.conv_norm_out(x))
        return self.conv_out(x)
