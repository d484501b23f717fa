"""Shared building blocks, NCHW (counterpart of
``ldmseg_tpu/models/layers.py``).

Norms compute in fp32 and return the input dtype, as Flax's ``GroupNorm`` and
``LayerNorm`` do for bf16 inputs. Parameter names follow the diffusers /
reference state-dict keys that ``ldmseg_tpu/models/torch_export.py`` emits.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_self_attention
from ..ops.groupnorm_silu import group_norm_silu, group_norm_silu_quant
from ..ops.quant import (QuantConv2d, int8_matmul, quantize_activation,
                         quantize_weight)


class GroupNorm(nn.Module):
    """GroupNorm computed in fp32 (Flax ``nn.GroupNorm``; its default eps is
    1e-6, torch's 1e-5, so eps is always given)."""

    def __init__(self, num_groups: int, channels: int, eps: float):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(x).to(x.dtype)


class GroupNormSiLU(GroupNorm):
    """GN + SiLU, the JAX ``GroupNormSiLU`` (:58-84) with its precedence:
    ``quantize`` (K6, ``ops/groupnorm_silu.py:group_norm_silu_quant``;
    returns ``(q int8, s [B])`` for a ``QuantConv2d``, inference only), then
    ``use_pallas`` (K5, ``group_norm_silu``), then ``lowp`` for a non-fp32
    input (the int8 UNet's resnets, :67-78: fp32 group statistics, then a
    per-(image, channel) affine ``x·w + b`` and the SiLU in the input
    dtype), else fp32."""

    def __init__(self, num_groups: int, channels: int, eps: float,
                 lowp: bool = False, use_pallas: bool = False,
                 quantize: bool = False):
        super().__init__(num_groups, channels, eps)
        self.lowp = lowp
        self.use_pallas = use_pallas
        self.quantize = quantize

    def forward(self, x: torch.Tensor):
        # the kernels take contiguous NCHW; a convolution may hand over
        # channels-last strides (a copy then, else nothing)
        if self.quantize:
            return group_norm_silu_quant(x.contiguous(), self.weight,
                                         self.bias, self.num_groups, self.eps)
        if self.use_pallas:
            return group_norm_silu(x.contiguous(), self.weight, self.bias,
                                   self.num_groups, self.eps)
        if not (self.lowp and x.dtype != torch.float32):
            return F.silu(self.normalize(x)).to(x.dtype)
        b, c = x.shape[:2]
        g = self.num_groups
        mean, var = self.group_stats(x.reshape(b, g, -1).float())
        w = self.weight.float().reshape(g, -1) * torch.rsqrt(var + self.eps)
        shift = self.bias.float().reshape(g, -1) - mean * w  # [B, G, C/G]
        y = (x * w.reshape(b, c, 1, 1).to(x.dtype)
             + shift.reshape(b, c, 1, 1).to(x.dtype))
        return F.silu(y)


    def group_stats(self, xr: torch.Tensor):
        """The lowp path's fp32 mean and variance ``[B, G, 1]`` of each
        (image, group) of ``xr [B, G, n]``."""
        mean = xr.mean(-1, keepdim=True)
        return mean, (xr - mean).square().mean(-1, keepdim=True)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, computed in fp32 (Flax ``nn.LayerNorm``,
    eps 1e-6 by default)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class LayerNorm2d(LayerNorm):
    """Per-pixel LayerNorm over the channel axis of NCHW (reference
    vae.py:310-323, detectron2 style)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def conv3x3(cin: int, cout: int, stride: int = 1,
            padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding)


class ResnetBlock(nn.Module):
    """diffusers ResnetBlock2D: GN-SiLU-conv twice plus a skip, with the
    time-embedding bias between the halves when ``temb_channels`` is set.
    ``use_int8`` (inference) makes ``conv1``/``conv2`` s8 convs with the
    static ``int8_act_scale`` (or a calibrated per-site scale) and the norms
    ``lowp``; ``conv_shortcut`` stays a float conv, as in JAX.
    ``use_pallas_gn`` puts both norms on K5; ``int8_fuse_gn`` with
    ``use_int8`` on K6, whose codes and per-image scales feed the s8 convs
    directly (:101-137)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 32,
                 eps: float = 1e-6, temb_channels: Optional[int] = None,
                 use_int8: bool = False,
                 int8_act_scale: Optional[float] = None,
                 use_pallas_gn: bool = False, int8_fuse_gn: bool = False):
        super().__init__()
        if use_int8:
            def conv(cin, cout):
                return QuantConv2d(cin, cout, act_scale=int8_act_scale)
        else:
            conv = conv3x3
        norm = functools.partial(GroupNormSiLU, groups, eps=eps,
                                 lowp=use_int8, use_pallas=use_pallas_gn,
                                 quantize=use_int8 and int8_fuse_gn)
        self.norm1 = norm(in_channels)
        self.conv1 = conv(in_channels, out_channels)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = norm(out_channels)
        self.conv2 = conv(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t.to(h.dtype)[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock2D(nn.Module):
    """Single-head spatial self-attention over HW tokens (the diffusers VAE
    mid-block attention, JAX :148-183). ``use_fused`` sends it to K1
    (``fused_self_attention``; at the SD width one head of D = 512, K1's
    wide class on the card), else the plain einsum of the JAX module."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6,
                 num_heads: int = 1, use_fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_fused = use_fused
        self.group_norm = GroupNorm(groups, channels, eps)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # [B, HW, C]
        hd = c // self.num_heads
        q, k, v = (proj(y).reshape(b, h * w, self.num_heads, hd)
                   for proj in (self.to_q, self.to_k, self.to_v))
        if self.use_fused:
            y = fused_self_attention(q, k, v, 1.0 / math.sqrt(hd))
        else:
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            attn = torch.softmax(attn, dim=-1)
            y = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        y = self.to_out[0](y.reshape(b, h * w, c))
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class MidBlock2D(nn.Module):
    """diffusers UNetMidBlock2D without cross-attention: resnet, optional
    self-attention, resnet. ``use_int8`` makes both resnets int8 (the image
    VAE encoder's ``mid_resnet0``/``mid_resnet1``)."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6,
                 add_attention: bool = False, use_fused: bool = False,
                 use_int8: bool = False,
                 int8_act_scale: Optional[float] = None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, groups, eps, use_int8=use_int8,
                        int8_act_scale=int8_act_scale) for _ in range(2)])
        self.attentions = nn.ModuleList(
            [AttentionBlock2D(channels, groups, eps, use_fused=use_fused)]
            if add_attention else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        for attn in self.attentions:
            x = attn(x)
        return self.resnets[1](x)


class ConvTranspose2x(nn.ConvTranspose2d):
    """ConvTranspose 2x2, stride 2. The JAX module computes it as one matmul
    plus a pixel shuffle on its ``[2, 2, Cin, Cout]`` kernel; the weight here
    is torch's ``[Cin, Cout, 2, 2]`` with the taps flipped
    (``models/convert.py``).

    ``use_int8`` (inference only, JAX :240-300) runs the matmul as a 1x1 s8
    product to ``4·Cout`` columns (``torch._int_mm``, as ``s8_conv2d``; no
    Pallas kernel computes it in JAX): the weight with one scale per
    ``(tap, channel)`` column, as JAX's ``int8_dot`` quantizes a float
    kernel (the JAX trainer's form: it prequantizes no VAE), the input per
    tensor (``act_scale``, else its amax), ``float(int32)·(xs·col_scale)``
    in the input dtype, then the pixel shuffle and the bias. The codes are
    those of the weight's JAX layout, column ``(kh, kw, o)`` holding tap
    ``(kh, kw)`` after JAX's flip, which is the torch weight's own tap
    ``(kh, kw)``. :meth:`prepare` fills them once from a float module;
    unprepared, each call quantizes the weight again (the same codes)."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_int8: bool = False,
                 act_scale: Optional[float] = None):
        super().__init__(in_channels, out_channels, 2, stride=2)
        self.use_int8 = use_int8
        self.act_scale = act_scale
        self.register_buffer("w_q", None, persistent=False)
        self.register_buffer("w_scale", None, persistent=False)

    @staticmethod
    def _codes(weight: torch.Tensor):
        """``[4·Cout, Cin]`` int8 rows (column order (kh, kw, o)) and the
        per-column scales."""
        q, s = quantize_weight(weight, dims=(0,))
        cin, o = weight.shape[:2]
        return (q.permute(2, 3, 1, 0).reshape(-1, cin).contiguous(),
                s.reshape(o, 4).t().reshape(-1).contiguous())

    @torch.no_grad()
    def prepare(self, src: nn.ConvTranspose2d) -> None:
        self.w_q, self.w_scale = self._codes(src.weight)

    def input_scale(self, x: torch.Tensor):
        """The input's int8 scale: ``act_scale`` (None: its amax)."""
        return self.act_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_int8:
            return super().forward(x)
        b, c, h, w = x.shape
        o = self.out_channels
        if self.w_q is None:
            w_q, col_scale = self._codes(self.weight.detach())
        else:
            w_q, col_scale = self.w_q, self.w_scale
        x_q, xs = quantize_activation(x.permute(0, 2, 3, 1).reshape(-1, c),
                                      self.input_scale(x))
        y = int8_matmul(x_q, w_q)
        y = (y.float() * (xs * col_scale)).to(x.dtype)
        y = y.reshape(b, h, w, 2, 2, o).permute(0, 5, 1, 3, 2, 4)
        y = y.reshape(b, o, 2 * h, 2 * w)
        return y + self.bias.to(y.dtype)[:, None, None]


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding in fp32 with the SD flags (diffusers
    ``get_timestep_embedding``, flip_sin_to_cos=True, no frequency shift):
    ``[cos, sin]`` of ``t * 10000^(-i / (dim/2))``."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer MLP over the sinusoidal embedding. It runs in the dtype of
    its input (fp32 in the UNet) with the weights cast to it, as Flax
    promotes fp32 inputs against bf16 weights."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        def dense(layer, x):
            return F.linear(x, layer.weight.to(x.dtype),
                            layer.bias.to(x.dtype))
        return dense(self.linear_2, F.silu(dense(self.linear_1, emb)))


@torch.no_grad()
def init_random_(module: nn.Module, gen: torch.Generator) -> None:
    """Seeded random weights: LeCun-normal convs and linears (Flax's
    default), zero biases, unit norm scales; a module with its own
    ``random_init_(gen)`` (the seg VAE's codebook) fills itself."""
    for m in module.modules():
        if hasattr(m, "random_init_"):
            m.random_init_(gen)
            continue
        params = dict(m.named_parameters(recurse=False))
        if not params:
            continue
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = (w.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else w.shape[1]) * w[0, 0].numel()
            w.normal_(0.0, fan_in ** -0.5, generator=gen)
        else:
            params["weight"].fill_(1.0)
        if params.get("bias") is not None:
            params["bias"].zero_()
