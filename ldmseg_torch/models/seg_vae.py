"""The segmentation VAE, NCHW (counterpart of
``ldmseg_tpu/models/seg_vae.py``).

Sampling needs ``SegVAE.decode``: latent -> per-instance logits, then
bilinear x ``interpolation_factor``. Training needs ``SegVAE.encode``: the
analog-bits panoptic map -> a diagonal Gaussian over the 4-channel latent at
1/8 resolution. Encoder and decoder are ``nn.Sequential``s whose indices are
the reference ``GeneralVAESeg`` keys (``encoder.<i>`` / ``decoder.<i>``,
vae.py:124-245) that ``torch_export.seg_vae_sd_from_params`` emits.

The port holds the default topology: the shallow conv encoder, no mid
blocks, the Gaussian bottleneck without range mapping or clamping. The other
bottlenecks (auto, gumbel-softmax, codebook) and encoder modes
(``resize_input``, ``skip_encoder``, the shared image encoder, RGB fusion)
raise ``NotImplementedError`` naming themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * noise; ``noise`` (standard normal, the mean's shape)
        replaces the draw from ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator,
                                device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + torch.exp(0.5 * self.logvar) * noise

    def kl(self) -> torch.Tensor:
        """KL to N(0, I), summed over all but the batch axis."""
        return 0.5 * torch.sum(
            self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar,
            dim=tuple(range(1, self.mean.dim())))


# ``vae_model_kwargs`` that do not change the modules built here: the latent
# scale (the trainer applies it) and the codebook settings of the discrete
# bottlenecks, which are refused below
_UNREAD_KEYS = frozenset({"scaling_factor", "freeze_codebook",
                          "num_embeddings"})

# (key, value the port takes, what else would be asked for)
_ONLY = (
    ("parametrization", "gaussian", "the auto / discrete bottlenecks"),
    ("act_fn", "none", "the bottleneck range mapping"),
    ("clamp_output", False, "the bottleneck output clamp"),
    ("resize_input", False, "the resize_input encoder"),
    ("skip_encoder", False, "the skip_encoder encoder"),
    ("image_encoder", False, "the shared SD image encoder"),
    ("fuse_rgb", False, "the RGB fusion of the stage-1 pass"),
)


def _encoder_layers(in_channels: int, block_out_channels: Tuple[int, ...],
                    int_channels: int, out_channels: int,
                    norm_num_groups: int) -> list:
    """The shallow conv encoder (vae.py:175-245): conv, SiLU, then per
    stage a conv and a stride-2 conv and SiLU, then conv to int_channels,
    (no mid block), GroupNorm(eps 1e-6), SiLU, conv to the moments."""
    chans = block_out_channels
    layers = [conv3x3(in_channels, chans[0]), nn.SiLU()]
    for cin, cout in zip(chans[:-1], chans[1:]):
        layers += [conv3x3(cin, cin), conv3x3(cin, cout, stride=2),
                   nn.SiLU()]
    layers += [conv3x3(chans[-1], int_channels), nn.Identity(),
               GroupNorm(norm_num_groups, int_channels, 1e-6), nn.SiLU(),
               conv3x3(int_channels, out_channels)]
    return layers


class SegVAE(nn.Module):
    """The stage-1 segmentation VAE: encoder and decoder."""

    def __init__(self, in_channels: int = 16, int_channels: int = 256,
                 out_channels: int = 128,
                 block_out_channels: Tuple[int, ...] = (32, 64, 128, 256),
                 latent_channels: int = 4, norm_num_groups: int = 32,
                 num_mid_blocks: int = 0, num_latents: int = 2,
                 num_upscalers: int = 1, upscale_channels: int = 256,
                 **options):
        super().__init__()
        unknown = set(options) - _UNREAD_KEYS - {k for k, _, _ in _ONLY}
        if unknown:
            raise TypeError(f"SegVAE: unknown arguments {sorted(unknown)}")
        for key, ours, what in _ONLY:
            if options.get(key, ours) != ours:
                raise NotImplementedError(
                    f"SegVAE {key}={options[key]!r} is not ported yet "
                    f"({what})")
        if num_mid_blocks:
            raise NotImplementedError(
                "SegVAE num_mid_blocks > 0: the encoder/decoder mid blocks "
                "are not ported yet")
        self.block_out_channels = tuple(block_out_channels)
        self.num_upscalers = num_upscalers
        self.encoder = nn.Sequential(*_encoder_layers(
            in_channels, self.block_out_channels, int_channels,
            latent_channels * num_latents, norm_num_groups))
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

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """Bits ``[B, in_channels, H, W]`` -> posterior over
        ``[B, latent_channels, H/8, W/8]``."""
        return DiagonalGaussian.from_moments(self.encoder(x))

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
