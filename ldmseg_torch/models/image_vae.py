"""The SD AutoencoderKL image encoder, NCHW (counterpart of
``ldmseg_tpu/models/image_vae.py``).

Four down blocks of two resnets with asymmetric-padded stride-2
downsamples, an attention mid block, GN/SiLU/conv to 2x4 moments and the 1x1
quant conv. The sampling path runs the encoder only, as the trainer builds
it (``decoder_enabled=False``); the decoder is a later slice. Parameter
names are the AutoencoderKL keys of ``torch_export.image_vae_sd_from_params``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import GroupNorm, MidBlock2D, ResnetBlock, conv3x3
from .seg_vae import DiagonalGaussian


class _Downsample(nn.Module):
    """diffusers VAE downsample: pad (0, 1) on H and W, then a stride-2
    conv without padding (the UNet's pads symmetrically)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, add_downsample: bool = True,
                 groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels,
                        out_channels, groups, 1e-6)
            for i in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [_Downsample(out_channels)] if add_downsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for down in self.downsamplers:
            x = down(x)
        return x


class VAEEncoder(nn.Module):
    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512,
                                                              512),
                 latent_channels: int = 4, layers_per_block: int = 2,
                 groups: int = 32, use_fused_attention: bool = False,
                 in_channels: int = 3):
        super().__init__()
        chans = tuple(block_out_channels)
        self.conv_in = conv3x3(in_channels, chans[0])
        cin, blocks = chans[0], []
        for i, cout in enumerate(chans):
            blocks.append(DownEncoderBlock(cin, cout, layers_per_block,
                                           i < len(chans) - 1, groups))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock2D(chans[-1], groups, 1e-6,
                                    add_attention=True,
                                    use_fused=use_fused_attention)
        self.conv_norm_out = GroupNorm(groups, chans[-1], 1e-6)
        self.conv_out = conv3x3(chans[-1], 2 * latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class ImageVAE(nn.Module):
    """AutoencoderKL encoder + quant conv. ``encode`` returns a
    :class:`DiagonalGaussian`; the caller multiplies the latents by the
    config's ``image_scaling_factor`` (0.18215)."""

    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512,
                                                              512),
                 latent_channels: int = 4, decoder_enabled: bool = False,
                 groups: int = 32, use_fused_attention: bool = False):
        super().__init__()
        if decoder_enabled:
            raise NotImplementedError(
                "ImageVAE decoder_enabled=True: the image-VAE decoder is not "
                "ported yet")
        self.encoder = VAEEncoder(block_out_channels, latent_channels,
                                  groups=groups,
                                  use_fused_attention=use_fused_attention)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels,
                                    1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))
