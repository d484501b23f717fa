"""The segmentation VAE of stage 1, NCHW (counterpart of
``ldmseg_tpu/models/seg_vae.py``; reference ``GeneralVAESeg``,
vae.py:42-570).

Analog-bits panoptic maps (with the RGB frame under ``fuse_rgb``) -> a
posterior over a 4-channel latent at 1/8 resolution -> per-instance logits.
Every option of the JAX ``SegVAE``:

* encoders: the shallow conv encoder (vae.py:175-245), ``resize_input``
  (conv to ``int_channels``, the bilinear /8 of ``jax.image.resize``),
  ``skip_encoder`` (one 8x8 stride-8 conv), ``image_encoder`` (the SD
  AutoencoderKL encoder topology, without its quant conv), each with
  ``num_mid_blocks`` resnet mid blocks before the head;
* bottlenecks: ``gaussian``, ``auto``, ``discrete_gumbel_softmax`` and
  ``discrete_codebook``, with ``act_fn`` and ``clamp_output``; the codebook
  is a parameter, or under ``freeze_codebook`` a constant buffer (JAX's
  ``"constants"`` collection);
* the decoder: conv, a mid block, ConvTranspose upscalers with LayerNorm2d,
  GroupNorm head, and the bilinear x ``interpolation_factor`` of
  ``decode``.

Encoder and decoder (but the image encoder) are ``nn.Sequential``s whose
indices are the reference keys (``encoder.<i>`` / ``decoder.<i>``) that
``torch_export.seg_vae_sd_from_params`` emits; :func:`encoder_plan` and
:func:`decoder_plan` list, per index, the JAX module it holds, for
``models/convert.py``. The mid blocks sit at the reference's placeholder
index (an ``nn.Identity`` without them). The random draws of a sample
(Gaussian or Gumbel noise) come from a ``torch.Generator`` or are handed in
(``noise``). The int8 decoder (``use_int8``, inference only, JAX
:230-276) runs ``in_conv`` and ``out_conv`` as s8 convs
(:class:`~..ops.quant.QuantConv2d`) and the upscalers as int8
:class:`~.layers.ConvTranspose2x`, all with ``int8_act_scale`` (None: each
input's own amax); the mid block stays float, as in JAX. Its parameters are
the float decoder's; :func:`~..ops.quant.prepare_int8_vae` fills the codes
(the upscalers' with one scale per (tap, channel) column, as the JAX
trainer's float kernels are quantized).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.quant import QuantConv2d
from ..ops.resize import bilinear_upsample_2x, resize_weight_matrix
from .layers import (ConvTranspose2x, GroupNorm, LayerNorm2d, MidBlock2D,
                     conv3x3)

PARAMETRIZATIONS = ("gaussian", "auto", "discrete_gumbel_softmax",
                    "discrete_codebook")


def to_range(x: torch.Tensor, act_fn: str, clip_range: float = 1.0
             ) -> torch.Tensor:
    """The bottleneck's range mapping (vae.py:340-352) on the channel
    axis."""
    if act_fn == "sigmoid":
        return 2.0 * torch.sigmoid(x) - 1.0
    if act_fn == "tanh":
        return torch.tanh(x)
    if act_fn == "clip":
        return x.clamp(-clip_range, clip_range)
    if act_fn == "l2":
        return x / torch.linalg.vector_norm(x, dim=1,
                                            keepdim=True).clamp_min(1e-12)
    if act_fn == "none":
        return x
    raise NotImplementedError(act_fn)


def _sum_but_batch(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=tuple(range(1, x.dim())))


@dataclasses.dataclass
class DiagonalGaussian:
    """Diagonal Gaussian posterior (vae.py:371-425); moments split on the
    channel axis."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor, clamp_output: bool = False,
                     act_fn: str = "none") -> "DiagonalGaussian":
        if clamp_output:
            moments = moments.clamp(-5.0, 5.0)
        mean, logvar = moments.chunk(2, dim=1)
        return cls(mean=to_range(mean, act_fn),
                   logvar=logvar.clamp(-30.0, 20.0))

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
        return self.mean + torch.exp(0.5 * self.logvar) * noise.to(
            self.mean.dtype)

    def kl(self) -> torch.Tensor:
        """KL to N(0, I), summed over all but the batch axis."""
        return 0.5 * _sum_but_batch(
            self.mean ** 2 + torch.exp(self.logvar) - 1.0 - self.logvar)


@dataclasses.dataclass
class AutoBottleneck:
    """Plain AE bottleneck (vae.py:326-368): the range-mapped moments;
    ``kl`` is their L2 penalty."""

    mean: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor, clamp_output: bool = False,
                     act_fn: str = "none") -> "AutoBottleneck":
        return cls(mean=to_range(moments, act_fn, clip_range=5.0))

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, generator=None, noise=None) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return _sum_but_batch(self.mean ** 2)


def _project(one_hot: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``[B, N, h, w] x [N, D] -> [B, D, h, w]``."""
    return torch.einsum("bnhw,nd->bdhw", one_hot, codebook.to(one_hot.dtype))


def _one_hot(logits: torch.Tensor) -> torch.Tensor:
    idx = logits.argmax(dim=1)
    return F.one_hot(idx, logits.shape[1]).permute(0, 3, 1, 2).to(
        logits.dtype)


@dataclasses.dataclass
class CodebookBottleneck:
    """Hard argmax over the codebook with straight-through gradients
    (vae.py:500-570); ``kl`` is KL(q || uniform), the mean over pixels."""

    logits: torch.Tensor
    codebook: torch.Tensor

    @classmethod
    def from_moments(cls, moments, codebook, clamp_output=False):
        if clamp_output:
            moments = moments.clamp(-5.0, 5.0)
        return cls(logits=moments, codebook=codebook)

    def mode(self) -> torch.Tensor:
        return _project(_one_hot(self.logits), self.codebook)

    def sample(self, generator=None, noise=None) -> torch.Tensor:
        y = (_one_hot(self.logits) - self.logits).detach() + self.logits
        return _project(y, self.codebook)

    def kl(self) -> torch.Tensor:
        n = self.logits.shape[1]
        logq = F.log_softmax(self.logits, dim=1)
        return torch.sum(logq.exp() * (logq - torch.log(
            torch.tensor(1.0 / n, dtype=logq.dtype))), dim=1).mean()


@dataclasses.dataclass
class GumbelSoftmaxBottleneck(CodebookBottleneck):
    """Straight-through Gumbel-softmax over the codebook (vae.py:428-497),
    temperature 0.2. ``noise`` is the Gumbel noise (the logits' shape);
    without it ``-log(-log(u))`` of a uniform draw from ``generator``."""

    temp: float = 0.2

    def sample(self, generator=None, noise=None) -> torch.Tensor:
        if noise is None:
            u = torch.rand(self.logits.shape, generator=generator,
                           device=self.logits.device,
                           dtype=self.logits.dtype)
            noise = -torch.log(-torch.log(
                u.clamp_min(torch.finfo(u.dtype).tiny)))
        y_soft = torch.softmax(
            (self.logits + noise.to(self.logits.dtype)) / self.temp, dim=1)
        y = _one_hot(y_soft) + y_soft - y_soft.detach()
        return _project(y, self.codebook)


class Resize(nn.Module):
    """``jax.image.resize(..., "linear")`` of NCHW to ``1/factor`` of the
    size: the triangle kernel widened by the scale (antialias), as two
    weight-matrix contractions (:func:`~..ops.resize.resize_weight_matrix`)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        wh, ww = (torch.from_numpy(resize_weight_matrix(n, n // self.factor)
                                   ).to(x.device, x.dtype) for n in (h, w))
        return torch.einsum("bchw,hH,wW->bcHW", x, wh, ww)


class Codebook(nn.Module):
    """The ``[num_embeddings, latent_channels]`` codebook: a parameter, or
    with ``frozen`` a buffer (the orthonormal Q of a QR, JAX's
    ``"constants"`` variable; the port makes its own from seed 42, the JAX
    one is carried across by ``models/convert.py``)."""

    def __init__(self, num_embeddings: int, dim: int, frozen: bool):
        super().__init__()
        self.frozen = frozen
        if frozen:
            self.register_buffer("weight", torch.empty(num_embeddings, dim))
        else:
            self.weight = nn.Parameter(torch.empty(num_embeddings, dim))

    @torch.no_grad()
    def random_init_(self, gen: torch.Generator) -> None:
        if self.frozen:
            g = torch.Generator(device=self.weight.device).manual_seed(42)
            q, _ = torch.linalg.qr(torch.randn(
                self.weight.shape, generator=g, device=self.weight.device))
            self.weight.copy_(q)
        else:
            self.weight.normal_(0.0, 1.0, generator=gen)


# (JAX module name or None, kind) per Sequential index
Plan = List[Tuple[Optional[str], Optional[str]]]


def _mid(plan: Plan, num_mid_blocks: int, kind: str) -> None:
    plan.append(("mid", kind) if num_mid_blocks else (None, None))


def encoder_plan(block_out_channels=(32, 64, 128, 256),
                 num_mid_blocks: int = 0, resize_input: bool = False,
                 skip_encoder: bool = False) -> Plan:
    """The shallow encoder's Sequential, index by index: the JAX module of
    each (``in_conv``, ``down{i}_conv1``/``_conv2``, ``out_conv1``, the
    mid blocks ``mid{j}`` at the placeholder index, ``norm``,
    ``out_conv2``; ``skip_conv`` alone under ``skip_encoder``) and its kind
    (``conv``, ``norm``; ``mids`` for the ``nn.Sequential`` of the JAX
    ``mid0``, ``mid1``, ...; None for a layer without weights)."""
    if skip_encoder:
        return [("skip_conv", "conv")]
    plan: Plan = [("in_conv", "conv"), (None, None)]
    if resize_input:
        plan.append((None, None))
    else:
        for i in range(len(block_out_channels) - 1):
            plan += [(f"down{i}_conv1", "conv"), (f"down{i}_conv2", "conv"),
                     (None, None)]
    plan.append(("out_conv1", "conv"))
    _mid(plan, num_mid_blocks, "mids")
    return plan + [("norm", "norm"), (None, None), ("out_conv2", "conv")]


def decoder_plan(num_upscalers: int = 1, num_mid_blocks: int = 0) -> Plan:
    """The decoder's Sequential: ``in_conv``, the one mid block (kind
    ``mid``, JAX ``mid``) or the placeholder, per upscaler ``up{i}_convt`` / ``up{i}_ln`` / SiLU,
    ``norm``, SiLU, ``out_conv``."""
    plan: Plan = [("in_conv", "conv")]
    _mid(plan, num_mid_blocks, "mid")
    for i in range(num_upscalers):
        plan += [(f"up{i}_convt", "convt"), (f"up{i}_ln", "ln2d"),
                 (None, None)]
    return plan + [("norm", "norm"), (None, None), ("out_conv", "conv")]


def decoder_layers(latent_channels: int, int_channels: int,
                   out_channels: int, groups: int, num_mid_blocks: int = 0,
                   num_upscalers: int = 1, upscale_channels: int = 256,
                   use_int8: bool = False,
                   int8_act_scale: Optional[float] = None) -> nn.Sequential:
    """The decoder of :func:`decoder_plan` (JAX ``SegDecoder``), shared by
    :class:`SegVAE` and :class:`~.upscaler.Upscaler`; ``use_int8`` makes
    its convs and upscalers s8 (inference only)."""
    if use_int8:
        def conv(cin, cout):
            return QuantConv2d(cin, cout, act_scale=int8_act_scale)
    else:
        conv = conv3x3
    ic = int_channels
    layers = [conv(latent_channels, ic),
              MidBlock2D(ic, groups, 1e-6) if num_mid_blocks
              else nn.Identity()]
    ch = ic
    for _ in range(num_upscalers):
        layers += [ConvTranspose2x(ch, upscale_channels, use_int8,
                                   int8_act_scale),
                   LayerNorm2d(upscale_channels), nn.SiLU()]
        ch = upscale_channels
    # the decoder head uses torch's GroupNorm eps (vae.py:163)
    layers += [GroupNorm(groups, ch, 1e-5), nn.SiLU(),
               conv(ch, out_channels)]
    return nn.Sequential(*layers)


def _mid_blocks(n: int, channels: int, groups: int) -> nn.Module:
    return nn.Sequential(*[MidBlock2D(channels, groups, 1e-6)
                           for _ in range(n)]) if n else nn.Identity()


class SegVAE(nn.Module):
    """The stage-1 segmentation (V)AE; defaults as the JAX ``SegVAE``."""

    def __init__(self, in_channels: int = 16, int_channels: int = 256,
                 out_channels: int = 128,
                 block_out_channels: Tuple[int, ...] = (32, 64, 128, 256),
                 latent_channels: int = 4, norm_num_groups: int = 32,
                 scaling_factor: float = 0.2, num_mid_blocks: int = 0,
                 num_latents: int = 2, num_upscalers: int = 1,
                 upscale_channels: int = 256,
                 parametrization: str = "gaussian", act_fn: str = "none",
                 clamp_output: bool = False, freeze_codebook: bool = False,
                 fuse_rgb: bool = False, resize_input: bool = False,
                 skip_encoder: bool = False, image_encoder: bool = False,
                 num_embeddings: int = 128, use_int8: bool = False,
                 int8_act_scale: Optional[float] = None):
        super().__init__()
        if parametrization not in PARAMETRIZATIONS:
            raise NotImplementedError(parametrization)
        self.block_out_channels = tuple(block_out_channels)
        self.num_upscalers = num_upscalers
        self.parametrization = parametrization
        self.act_fn = act_fn
        self.clamp_output = clamp_output
        self.downsample_factor = 2 ** (len(self.block_out_channels) - 1)
        discrete = parametrization.startswith("discrete")
        latents = 1 if parametrization == "auto" else num_latents
        enc_out = num_embeddings if discrete else latent_channels * latents
        self.codebook = (Codebook(num_embeddings, latent_channels,
                                  freeze_codebook) if discrete else None)
        cin = in_channels + (3 if fuse_rgb else 0)
        g, ic = norm_num_groups, int_channels
        if image_encoder:
            if parametrization != "gaussian" or num_latents != 2:
                raise ValueError("image_encoder implies gaussian moments "
                                 "(2x latent)")
            from .image_vae import VAEEncoder
            self.encoder = VAEEncoder(latent_channels=latent_channels,
                                      in_channels=cin)
        else:
            self.encoder = nn.Sequential(*self._encoder_layers(
                cin, ic, enc_out, g, num_mid_blocks, resize_input,
                skip_encoder))
        self.decoder = decoder_layers(
            latent_channels, ic, out_channels, g, num_mid_blocks,
            num_upscalers, upscale_channels, use_int8, int8_act_scale)

    def _encoder_layers(self, cin, ic, enc_out, g, num_mid_blocks,
                        resize_input, skip_encoder) -> list:
        f = self.downsample_factor
        if skip_encoder:
            return [nn.Conv2d(cin, enc_out, f, stride=f)]
        chans = self.block_out_channels
        if resize_input:
            layers = [conv3x3(cin, ic), nn.SiLU(), Resize(f)]
            width = ic
        else:
            layers = [conv3x3(cin, chans[0]), nn.SiLU()]
            for c, cout in zip(chans[:-1], chans[1:]):
                layers += [conv3x3(c, c), conv3x3(c, cout, stride=2),
                           nn.SiLU()]
            width = chans[-1]
        return layers + [conv3x3(width, ic),
                         _mid_blocks(num_mid_blocks, ic, g),
                         GroupNorm(g, ic, 1e-6), nn.SiLU(),
                         conv3x3(ic, enc_out)]

    @property
    def interpolation_factor(self) -> int:
        return self.downsample_factor // 2 ** self.num_upscalers

    def make_posterior(self, moments: torch.Tensor):
        p = self.parametrization
        if p == "gaussian":
            return DiagonalGaussian.from_moments(moments, self.clamp_output,
                                                 self.act_fn)
        if p == "auto":
            return AutoBottleneck.from_moments(moments, self.clamp_output,
                                               self.act_fn)
        cls = (GumbelSoftmaxBottleneck if p == "discrete_gumbel_softmax"
               else CodebookBottleneck)
        return cls.from_moments(moments, self.codebook.weight,
                                self.clamp_output)

    def encode(self, x: torch.Tensor):
        """``[B, Cin, H, W]`` -> posterior over ``[B, latent, H/8, W/8]``."""
        return self.make_posterior(self.encoder(x))

    def decode(self, z: torch.Tensor, interpolate: bool = True
               ) -> torch.Tensor:
        """Latent ``[B, 4, h, w]`` -> logits ``[B, out_channels, H, W]``,
        bilinearly upsampled by ``interpolation_factor`` when
        ``interpolate``."""
        x = self.decoder(z)
        return self.upsample(x) if interpolate else x

    def upsample(self, x: torch.Tensor) -> torch.Tensor:
        """The bilinear x ``interpolation_factor`` of :meth:`decode`."""
        f = self.interpolation_factor
        if f == 1:
            return x
        if f == 2:
            return bilinear_upsample_2x(x)
        return F.interpolate(x, scale_factor=f, mode="bilinear",
                             align_corners=False)

    def forward(self, sample: torch.Tensor, sample_posterior: bool = True,
                rgb_sample: Optional[torch.Tensor] = None,
                valid_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """The whole pass (vae.py:274-307): encode (the RGB frame
        concatenated under ``fuse_rgb``), sample (``noise`` or a draw from
        ``generator``) or take the mode, zero the latent where
        ``valid_mask`` ``[B, h, w]`` is 0, decode without the final
        upsample. Returns ``(logits, posterior)``."""
        x = sample
        if rgb_sample is not None:
            x = torch.cat([x, rgb_sample], dim=1)
        posterior = self.encode(x)
        z = (posterior.sample(generator, noise) if sample_posterior
             else posterior.mode())
        if valid_mask is not None:
            z = z * valid_mask[:, None].to(z.dtype)
        return self.decoder(z), posterior
