"""Stage-2 latent-diffusion sampling (counterpart of
``ldmseg_tpu/train/trainer_ldm.py:TrainerDiffusion``, its sampling half).

``sample_panoptic`` runs the serving path: RGB frames -> frozen SD image-VAE
encoder (posterior mode x 0.18215) -> DDIM with self-conditioning over the
UNet -> seg-VAE decode to per-instance logits. Batches and results are NHWC
at this boundary, as in the JAX package; the models run NCHW.

Training, EMA, classifier-free guidance, text descriptors, clip sampling,
the DPM-Solver++ sampler and int8 inference are later slices: a config that
asks for one of them raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import torch
from torch import nn

from ..diffusion.ddim import make_ddim_schedule
from ..diffusion.sampler import ddim_sample
from ..models.convert import (image_vae_state_dict_from_jax,
                              seg_vae_state_dict_from_jax,
                              unet_state_dict_from_jax)
from ..models.image_vae import ImageVAE
from ..models.layers import init_random_
from ..models.seg_vae import SegVAE
from ..models.unet import UNet2DCondition, UNetConfig

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _refuse_later_slices(p: Mapping) -> None:
    tk, sk, mk = p["train_kwargs"], p["sampling_kwargs"], p["model_kwargs"]
    later = {
        "model_kwargs.separate_conv": (
            mk.get("separate_conv", False), "the separate seg/image conv_in"),
        "model_kwargs.separate_encoder": (
            mk.get("separate_encoder", False), "the separate image encoder"),
        "model_kwargs.add_adaptor": (
            mk.get("add_adaptor", False), "the image-encoder adaptors"),
        "train_kwargs.image_descriptors": (
            tk.get("image_descriptors", "remove") != "remove",
            "text/CLIP descriptors, cross-attention and guidance"),
        "train_kwargs.sample_posterior_rgb": (
            tk.get("sample_posterior_rgb", False),
            "sampling the RGB posterior"),
        "sampling_kwargs.sampler": (
            sk.get("sampler", "ddim") != "ddim",
            "the DPM-Solver++ sampler"),
        "sampling_kwargs.int8_inference": (
            sk.get("int8_inference", False), "int8 inference"),
        "ema_on": (p.get("ema_on", False), "EMA weights"),
        "spatial_parallel": (p.get("spatial_parallel", False),
                             "spatial parallelism"),
        "tensor_parallel": (p.get("tensor_parallel", False),
                            "tensor parallelism"),
    }
    for key, (asked, what) in later.items():
        if asked:
            raise NotImplementedError(
                f"config {key}: {what} is not ported yet")


class TrainerDiffusion:
    """Builds the UNet, the image VAE and the seg VAE from the config as the
    JAX trainer does, on ``device`` (``"cuda"`` unless the caller asks for
    the CPU). Call :meth:`init_params` or :meth:`load_jax_params` before
    :meth:`sample_panoptic`."""

    def __init__(self, p: dict, unet_config: Optional[UNetConfig] = None,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TrainerDiffusion: device 'cuda' asked for but "
                "torch.cuda.is_available() is False; pass "
                "device=torch.device('cpu') to run the plain PyTorch path")
        _refuse_later_slices(p)
        self.device = device
        tk, mk, sk, ek = (p["train_kwargs"], p["model_kwargs"],
                          p["sampling_kwargs"], p["eval_kwargs"])

        vk = dict(p["vae_model_kwargs"])
        vk.pop("pretrained_path", None)
        vk["block_out_channels"] = tuple(vk["block_out_channels"])
        self.vae_seg_kwargs = vk
        ivk = dict(p.get("image_vae_kwargs") or {})
        ivk.setdefault("decoder_enabled", False)
        if "block_out_channels" in ivk:
            ivk["block_out_channels"] = tuple(ivk["block_out_channels"])
        self.seg_scale = vk.get("scaling_factor", 0.2)
        self.img_scale = p.get("image_scaling_factor", 0.18215)
        self.num_classes = vk["out_channels"]
        self.ignore_label = p["ignore_label"]

        self.self_condition = tk.get("self_condition", False)
        cond_channels = mk.get("cond_channels", 0)
        if self.self_condition and cond_channels == 0:
            # the reference trains self_condition with cond_channels=4
            cond_channels = 4
        if unet_config is None:
            unet_config = UNetConfig(
                in_channels=mk.get("in_channels", 8) + cond_channels,
                use_fused_attention=tk.get("fused_attention", True))
        self.unet_config = unet_config
        # bf16 covers the reference's float16 AMP dtype, as in JAX
        self.compute_dtype = (torch.bfloat16 if tk.get("weight_dtype") in
                              ("bfloat16", "float16") else torch.float32)
        # built without storage; init_params / load_jax_params fill them
        with torch.device("meta"):
            self.unet = UNet2DCondition(unet_config)
            self.vae_img = ImageVAE(**ivk)
            self.vae_seg = SegVAE(**vk)
        self._unet_infer: Optional[nn.Module] = None

        self.sched = make_ddim_schedule(**p["noise_scheduler_kwargs"],
                                        device=device)
        self.num_inference_steps = sk.get("num_inference_steps", 50)
        self.seed = sk.get("seed", 0)
        self.mask_th = ek.get("mask_th", 0.5)
        self.count_th = ek.get("count_th", 512)
        self.overlap_th = ek.get("overlap_th", 0.5)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights for the three models."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for model in (self.vae_img, self.vae_seg, self.unet):
            model.to_empty(device=self.device)
            init_random_(model, gen)
        self._frozen_ready()

    def load_jax_params(self, unet: Mapping, vae_img: Mapping,
                        vae_seg: Mapping) -> None:
        """Adopt the JAX package's parameter trees (nested dicts of numpy
        arrays): the UNet's, the image VAE's encoder tree and the seg VAE's."""
        pairs = (
            (self.unet, unet_state_dict_from_jax(unet, self.unet_config)),
            (self.vae_img, image_vae_state_dict_from_jax(vae_img)),
            (self.vae_seg, seg_vae_state_dict_from_jax(
                vae_seg, self.vae_seg_kwargs)))
        for model, sd in pairs:
            model.to_empty(device=self.device)
            model.load_state_dict(sd, strict=True)
        self._frozen_ready()

    def _frozen_ready(self) -> None:
        # frozen towers run entirely in the compute dtype (cast once); the
        # UNet keeps fp32 masters and samples on a working copy
        for model in (self.unet, self.vae_img, self.vae_seg):
            model.eval().requires_grad_(False)
        self.vae_img.to(self.compute_dtype)
        self.vae_seg.to(self.compute_dtype)
        self._unet_infer = (self.unet if self.compute_dtype == torch.float32
                            else copy.deepcopy(self.unet).to(
                                self.compute_dtype))

    def inference_unet(self) -> nn.Module:
        """Refresh the compute-dtype working copy from the fp32 masters:
        once per call, outside the step loop."""
        if self._unet_infer is None:
            raise RuntimeError("TrainerDiffusion: call init_params or "
                               "load_jax_params first")
        if self._unet_infer is not self.unet:
            with torch.no_grad():
                for dst, src in zip(self._unet_infer.parameters(),
                                    self.unet.parameters()):
                    dst.copy_(src)
        return self._unet_infer

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _encode_rgb(self, image) -> torch.Tensor:
        """ImageNet-normalised NHWC frames -> scaled RGB latents, NCHW
        fp32."""
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
        rgb = 2.0 * (x * std + mean).clamp(0.0, 1.0).to(
            self.compute_dtype) - 1.0
        rgb = rgb.permute(0, 3, 1, 2).contiguous()
        lat = self.vae_img.encode(rgb).mode()
        return lat.float() * self.img_scale

    def _unet_apply(self, unet: nn.Module, latents: torch.Tensor,
                    rgb_latents: torch.Tensor,
                    condition: Optional[torch.Tensor], t: int
                    ) -> torch.Tensor:
        parts = [latents, rgb_latents]
        if condition is not None:
            parts.append(condition)
        inputs = torch.cat(parts, dim=1).to(self.compute_dtype)
        return unet(inputs, t).float()

    def _sample_decode(self, unet: nn.Module, rgb_latents: torch.Tensor,
                       generator: Optional[torch.Generator],
                       init_noise=None, num_inference_steps: int = 50):
        b, _, lh, lw = rgb_latents.shape
        if init_noise is not None:
            init = torch.as_tensor(init_noise, dtype=torch.float32,
                                   device=self.device)
            if tuple(init.shape) != (b, lh, lw, 4):
                raise ValueError(f"init_noise must be [B, h, w, 4] = "
                                 f"{(b, lh, lw, 4)}, got {tuple(init.shape)}")
            init = init.permute(0, 3, 1, 2).contiguous()
        else:
            init = torch.randn((b, 4, lh, lw), generator=generator,
                               device=self.device)

        def model_fn(latents, condition, t):
            return self._unet_apply(unet, latents, rgb_latents, condition, t)

        x0 = ddim_sample(self.sched, model_fn, init,
                         num_inference_steps=num_inference_steps,
                         self_condition=self.self_condition)
        z = (x0 * (1.0 / self.seg_scale)).to(self.compute_dtype)
        logits = self.vae_seg.decode(z, True).float()
        return logits, x0

    def sample_panoptic(self, batch: Mapping,
                        generator: Optional[torch.Generator] = None,
                        init_noise=None,
                        num_inference_steps: Optional[int] = None):
        """``batch["image"]`` ``[B, H, W, 3]`` (ImageNet-normalised) ->
        (logits ``[B, H, W, C]`` fp32, x0 latents ``[B, H/8, W/8, 4]``).
        ``init_noise`` (NHWC) replaces the draw of the initial noise from
        ``generator``; with neither, the generator is seeded from
        ``sampling_kwargs.seed``."""
        unet = self.inference_unet()
        if generator is None and init_noise is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed)
        with torch.inference_mode():
            rgb_latents = self._encode_rgb(batch["image"])
            logits, x0 = self._sample_decode(
                unet, rgb_latents, generator, init_noise,
                num_inference_steps or self.num_inference_steps)
        return (logits.permute(0, 2, 3, 1).contiguous(),
                x0.permute(0, 2, 3, 1).contiguous())
