"""The standalone latent upscaler, NCHW (counterpart of
``ldmseg_tpu/models/upscaler.py``; reference ldmseg/models/upscaler.py:
19-130): the segmentation VAE's decoder as a model of its own, decoding
diffusion latents straight to instance logits, with the RGB latent
concatenated to its input under ``fuse_rgb``.

``decode(interpolate=True)`` resizes the logits by
``interpolation_factor`` = ``downsample_factor / 2**num_upscalers`` as
``jax.image.resize(..., "linear")`` does: the host-built weight matrices of
:func:`~..ops.resize.resize_weight_matrix` contracted along H and W.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.resize import resize_weight_matrix
from .seg_vae import decoder_layers


class Upscaler(nn.Module):
    """Defaults as the JAX ``Upscaler``. The decoder's keys are the seg VAE
    decoder's (``decoder.<i>``, :func:`~.seg_vae.decoder_plan`); its input
    has ``latent_channels`` channels, twice that with ``fuse_rgb``."""

    def __init__(self, latent_channels: int = 4, int_channels: int = 256,
                 upscaler_channels: int = 256, out_channels: int = 128,
                 num_mid_blocks: int = 0, num_upscalers: int = 1,
                 fuse_rgb: bool = False, downsample_factor: int = 8,
                 norm_num_groups: int = 32):
        super().__init__()
        self.fuse_rgb = fuse_rgb
        self.num_upscalers = num_upscalers
        self.downsample_factor = downsample_factor
        self.decoder = decoder_layers(
            latent_channels * (2 if fuse_rgb else 1), int_channels,
            out_channels, norm_num_groups, num_mid_blocks, num_upscalers,
            upscaler_channels)

    @property
    def interpolation_factor(self) -> int:
        return self.downsample_factor // (2 ** self.num_upscalers)

    def decode(self, z: torch.Tensor, interpolate: bool = True
               ) -> torch.Tensor:
        x = self.decoder(z)
        f = self.interpolation_factor
        if interpolate and f != 1:
            h, w = x.shape[-2:]
            wh, ww = (torch.from_numpy(resize_weight_matrix(n, n * f)).to(
                x.device, torch.float32) for n in (h, w))
            x = torch.einsum("bchw,hH,wW->bcHW", x.float(), wh, ww).to(
                x.dtype)
        return x

    def forward(self, z: torch.Tensor, interpolate: bool = False,
                z_rgb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if z_rgb is not None and self.fuse_rgb:
            z = torch.cat([z, z_rgb], dim=1)
        return self.decode(z, interpolate=interpolate)
