"""The segmentation VAE's decoder, NCHW (counterpart of
``ldmseg_tpu/models/seg_vae.py``).

The sampling path needs the posterior's mode (for the image VAE) and
``SegVAE.decode``: latent -> per-instance logits, then bilinear x
``interpolation_factor``. The decoder is an ``nn.Sequential`` whose indices
are the reference ``GeneralVAESeg`` keys (``decoder.<i>``, vae.py:124-173)
that ``torch_export.seg_vae_sd_from_params`` emits. The encoder and the
other bottlenecks are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import bilinear_upsample_2x
from .layers import ConvTranspose2x, GroupNorm, LayerNorm2d, conv3x3


@dataclasses.dataclass
class DiagonalGaussian:
    """Diagonal Gaussian posterior; moments split on the channel axis."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    def mode(self) -> torch.Tensor:
        return self.mean


# ``vae_model_kwargs`` the decoder does not read (the encoder's settings,
# and the latent scale the trainer applies): accepted so that a whole
# config builds the decoder
_UNREAD_KEYS = frozenset({
    "in_channels", "num_latents", "parametrization", "act_fn",
    "clamp_output", "freeze_codebook", "fuse_rgb", "resize_input",
    "skip_encoder", "image_encoder", "num_embeddings", "scaling_factor"})


class SegVAE(nn.Module):
    """Decoder half of the stage-1 segmentation VAE."""

    def __init__(self, int_channels: int = 256, out_channels: int = 128,
                 block_out_channels: Tuple[int, ...] = (32, 64, 128, 256),
                 latent_channels: int = 4, norm_num_groups: int = 32,
                 num_mid_blocks: int = 0, num_upscalers: int = 1,
                 upscale_channels: int = 256, **unread):
        super().__init__()
        unknown = set(unread) - _UNREAD_KEYS
        if unknown:
            raise TypeError(f"SegVAE: unknown arguments {sorted(unknown)}")
        if num_mid_blocks:
            raise NotImplementedError(
                "SegVAE num_mid_blocks > 0: the decoder mid blocks are not "
                "ported yet")
        self.block_out_channels = tuple(block_out_channels)
        self.num_upscalers = num_upscalers
        layers = [conv3x3(latent_channels, int_channels), nn.Identity()]
        ch = int_channels
        for _ in range(num_upscalers):
            layers += [ConvTranspose2x(ch, upscale_channels),
                       LayerNorm2d(upscale_channels), nn.SiLU()]
            ch = upscale_channels
        # the decoder head uses torch's GroupNorm eps (vae.py:163)
        layers += [GroupNorm(norm_num_groups, ch, 1e-5), nn.SiLU(),
                   conv3x3(ch, out_channels)]
        self.decoder = nn.Sequential(*layers)

    @property
    def interpolation_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1) // \
            2 ** self.num_upscalers

    def decode(self, z: torch.Tensor, interpolate: bool = True
               ) -> torch.Tensor:
        """Latent ``[B, 4, h, w]`` -> logits ``[B, out_channels, H, W]``,
        bilinearly upsampled by ``interpolation_factor`` when
        ``interpolate``."""
        x = self.decoder(z)
        f = self.interpolation_factor
        if interpolate and f != 1:
            if f == 2:
                x = bilinear_upsample_2x(x)
            else:
                x = F.interpolate(x, scale_factor=f, mode="bilinear",
                                  align_corners=False)
        return x
