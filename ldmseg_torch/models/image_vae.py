"""The SD AutoencoderKL image VAE, NCHW (counterpart of
``ldmseg_tpu/models/image_vae.py``).

Encoder: four down blocks of two resnets with asymmetric-padded stride-2
downsamples, an attention mid block (one head over all channels:
``use_fused_attention`` puts it on K1, D = 512 at the SD width), GN/SiLU/conv
to 2x4 moments and the 1x1 quant conv. Decoder: the 1x1 post-quant conv,
conv_in, a mid block whose attention is the plain einsum (as in JAX), four
up blocks of three resnets with nearest 2x upsamples and a conv, GN/SiLU and
conv_out to RGB. The sampling path runs the encoder only, as the trainer
builds it (``decoder_enabled=False``, the port's default here; JAX's module
defaults to True).

``use_int8`` (inference only, JAX :28-109) makes the encoder's resnet convs
and downsamples s8 convs (:class:`~..ops.quant.QuantConv2d`): the resnets
with the static ``int8_act_scale`` and the ``lowp`` GroupNorm of the int8
UNet's resnets (not K6: the VAE leaves ``int8_fuse_gn`` off), the
downsample with the dynamic per-tensor amax of its input, as JAX's
``QuantConv`` there takes no act scale. ``conv_in``, ``conv_out``, the
shortcuts and the attention stay float. :func:`~..ops.quant.
prepare_int8_vae` fills the codes once from the module's own float weights.

Parameter names are the AutoencoderKL keys of
``torch_export.image_vae_sd_from_params``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantConv2d
from .layers import GroupNorm, MidBlock2D, ResnetBlock, conv3x3
from .seg_vae import DiagonalGaussian


class _Downsample(nn.Module):
    """diffusers VAE downsample: pad (0, 1) on H and W, then a stride-2
    conv without padding (the UNet's pads symmetrically); int8, the s8
    conv with that padding."""

    def __init__(self, channels: int, use_int8: bool = False):
        super().__init__()
        self.use_int8 = use_int8
        if use_int8:
            self.conv = QuantConv2d(channels, channels, stride=2,
                                    padding=((0, 1), (0, 1)))
        else:
            self.conv = conv3x3(channels, channels, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_int8:
            return self.conv(x)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv (``nearest_upsample_2x`` + ``upsample``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class DownEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, add_downsample: bool = True,
                 groups: int = 32, use_int8: bool = False,
                 int8_act_scale: Optional[float] = None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels,
                        out_channels, groups, 1e-6, use_int8=use_int8,
                        int8_act_scale=int8_act_scale)
            for i in range(num_layers)])
        self.downsamplers = nn.ModuleList(
            [_Downsample(out_channels, use_int8)] if add_downsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for down in self.downsamplers:
            x = down(x)
        return x


class UpDecoderBlock(nn.Module):
    """Three resnets, then (but the last block) the nearest 2x + conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 3, add_upsample: bool = True,
                 groups: int = 32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if i == 0 else out_channels,
                        out_channels, groups, 1e-6)
            for i in range(num_layers)])
        self.upsamplers = nn.ModuleList(
            [_Upsample(out_channels)] if add_upsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        for up in self.upsamplers:
            x = up(x)
        return x


class VAEEncoder(nn.Module):
    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512,
                                                              512),
                 latent_channels: int = 4, layers_per_block: int = 2,
                 groups: int = 32, use_fused_attention: bool = False,
                 in_channels: int = 3, use_int8: bool = False,
                 int8_act_scale: Optional[float] = None):
        super().__init__()
        chans = tuple(block_out_channels)
        self.conv_in = conv3x3(in_channels, chans[0])
        cin, blocks = chans[0], []
        for i, cout in enumerate(chans):
            blocks.append(DownEncoderBlock(cin, cout, layers_per_block,
                                           i < len(chans) - 1, groups,
                                           use_int8, int8_act_scale))
            cin = cout
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = MidBlock2D(chans[-1], groups, 1e-6,
                                    add_attention=True,
                                    use_fused=use_fused_attention,
                                    use_int8=use_int8,
                                    int8_act_scale=int8_act_scale)
        self.conv_norm_out = GroupNorm(groups, chans[-1], 1e-6)
        self.conv_out = conv3x3(chans[-1], 2 * latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEDecoder(nn.Module):
    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512,
                                                              512),
                 latent_channels: int = 4, layers_per_block: int = 3,
                 out_channels: int = 3, groups: int = 32):
        super().__init__()
        rev = tuple(reversed(block_out_channels))
        self.conv_in = conv3x3(latent_channels, rev[0])
        self.mid_block = MidBlock2D(rev[0], groups, 1e-6, add_attention=True)
        cin, blocks = rev[0], []
        for i, cout in enumerate(rev):
            blocks.append(UpDecoderBlock(cin, cout, layers_per_block,
                                         i < len(rev) - 1, groups))
            cin = cout
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = GroupNorm(groups, rev[-1], 1e-6)
        self.conv_out = conv3x3(rev[-1], out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class ImageVAE(nn.Module):
    """AutoencoderKL with the SD quant convs. ``encode`` returns a
    :class:`DiagonalGaussian`; the caller multiplies the latents by the
    config's ``image_scaling_factor`` (0.18215). ``decode`` and ``forward``
    need ``decoder_enabled``."""

    def __init__(self, block_out_channels: Tuple[int, ...] = (128, 256, 512,
                                                              512),
                 latent_channels: int = 4, out_channels: int = 3,
                 decoder_enabled: bool = False, groups: int = 32,
                 use_fused_attention: bool = False, use_int8: bool = False,
                 int8_act_scale: Optional[float] = None):
        super().__init__()
        self.block_out_channels = tuple(block_out_channels)
        self.encoder = VAEEncoder(block_out_channels, latent_channels,
                                  groups=groups,
                                  use_fused_attention=use_fused_attention,
                                  use_int8=use_int8,
                                  int8_act_scale=int8_act_scale)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels,
                                    1)
        self.decoder_enabled = decoder_enabled
        if decoder_enabled:
            self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels,
                                             1)
            self.decoder = VAEDecoder(block_out_channels, latent_channels,
                                      out_channels=out_channels,
                                      groups=groups)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_moments(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if not self.decoder_enabled:
            raise RuntimeError("ImageVAE.decode: built with "
                               "decoder_enabled=False")
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, sample_posterior: bool = False,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """Encode, take the posterior's mode (or with ``sample_posterior`` a
        sample: ``noise`` or a draw from ``generator``), decode. Returns
        ``(reconstruction, posterior)``."""
        posterior = self.encode(x)
        z = (posterior.sample(generator, noise) if sample_posterior
             else posterior.mode())
        return self.decode(z), posterior
