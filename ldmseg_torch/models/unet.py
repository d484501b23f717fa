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
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import fused_self_attention
from .layers import (GroupNorm, LayerNorm, ResnetBlock, TimestepEmbedding,
                     conv3x3, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-1.4 defaults; the fields of the JAX ``UNetConfig`` that the
    sampling path without cross-attention reads."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8  # = number of heads (SD v1 semantics)
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    attn_down: Tuple[bool, ...] = (True, True, True, False)
    use_fused_attention: bool = False


class CrossAttention(nn.Module):
    """Multi-head self-attention (diffusers Attention): q/k/v without bias,
    out projection with bias. ``use_fused`` sends it to K1."""

    def __init__(self, query_dim: int, heads: int, use_fused: bool = False):
        super().__init__()
        self.heads = heads
        self.use_fused = use_fused
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
        if self.use_fused:
            out = fused_self_attention(q, k, v, scale)
        else:
            attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.to_out[0](out.reshape(b, t, c))


class GEGLU(nn.Module):
    """``h, gate = split(proj(x))``; ``h * gelu(gate)`` with the exact erf
    gelu (diffusers GEGLU)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU to 4x the width and back (diffusers ``ff.net``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """LN -> self-attention -> residual, LN -> GEGLU FF -> residual."""

    def __init__(self, dim: int, heads: int, use_fused: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, use_fused=use_fused)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN -> 1x1 conv in -> one transformer block over HW tokens -> 1x1
    conv out -> residual."""

    def __init__(self, channels: int, heads: int, groups: int = 32,
                 use_fused: bool = False):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, use_fused)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = self.transformer_blocks[0](y)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

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
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 has_attn: bool, heads: int, groups: int, eps: float,
                 add_downsample: bool, temb_channels: int,
                 use_fused: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels,
                        out_channels, groups, eps, temb_channels)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, heads, groups, use_fused)
            for _ in range(num_layers)] if has_attn else [])
        self.downsamplers = nn.ModuleList(
            [Downsample(out_channels)] if add_downsample else [])

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
                 use_fused: bool = False):
        super().__init__()
        resnets = []
        for i, skip in enumerate(skip_channels):
            cin = (in_channels if i == 0 else out_channels) + skip
            resnets.append(ResnetBlock(cin, out_channels, groups, eps,
                                       temb_channels))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, heads, groups, use_fused)
            for _ in skip_channels] if has_attn else [])
        self.upsamplers = nn.ModuleList(
            [Upsample(out_channels)] if add_upsample else [])

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
                 temb_channels: int, use_fused: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, groups, eps, temb_channels)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(channels, heads, groups, use_fused)])

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
        fused = cfg.use_fused_attention
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
                                  not last, temb, fused))
            skips += [cout] * (cfg.layers_per_block + (0 if last else 1))
            cin = cout
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlockCrossAttn(chans[-1], heads, groups, eps,
                                           temb, fused)
        up, cin = [], chans[-1]
        rev = list(reversed(chans))
        attn_up = tuple(reversed(cfg.attn_down))
        n_res = cfg.layers_per_block + 1
        for i, cout in enumerate(rev):
            taken, skips = skips[-n_res:], skips[:-n_res]
            up.append(UpBlock(cin, taken[::-1], cout, attn_up[i], heads,
                              groups, eps, i < len(rev) - 1, temb, fused))
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
