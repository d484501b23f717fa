"""The reference's torch checkpoint format, written from the port's modules
(counterpart of ``ldmseg_tpu/models/torch_export.py``).

The port's modules carry the reference's own keys (the diffusers names of
the UNet and of the AutoencoderKL encoder, the ``GeneralVAESeg``
Sequential indices of the seg VAE) and layouts (``[out, in, kh, kw]``
convs, ``[out, in]`` linears), so a state dict is written as it is, in
fp32, in the key order of the JAX exporter: :func:`unet_keys`,
:func:`image_vae_keys` and :func:`seg_vae_keys` give that order and pick
the keys a model of the port uses out of a larger state dict (a diffusers
UNet's cross-attention unless the config has ``use_cross_attention``, a
VAE's decoder), which ``torch_import`` reads with them.

``export_reference_ldm`` writes the reference's stage-2 save dict ``{step,
epoch, vae_image, vae_semseg, unet, ema?}`` (reference
``construct_save_dict``), the EMA as a diffusers ``EMAModel``
``{"shadow_params": [...]}`` ordered like ``unet``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

StateDict = Dict[str, torch.Tensor]
_WB = ("weight", "bias")


def _pair(keys: List[str], name: str) -> None:
    keys += [f"{name}.{s}" for s in _WB]


def _resnet(keys: List[str], sd: Mapping, pfx: str) -> None:
    for part in ("norm1", "conv1", "norm2", "conv2"):
        _pair(keys, f"{pfx}.{part}")
    for part in ("time_emb_proj", "conv_shortcut"):
        if f"{pfx}.{part}.weight" in sd:
            _pair(keys, f"{pfx}.{part}")


def _attention(keys: List[str], pfx: str) -> None:
    keys += [f"{pfx}.{q}.weight" for q in ("to_q", "to_k", "to_v")]
    _pair(keys, f"{pfx}.to_out.0")


def _transformer(keys: List[str], sd: Mapping, pfx: str,
                 cross: bool) -> None:
    for part in ("norm", "proj_in", "proj_out"):
        _pair(keys, f"{pfx}.{part}")
    i = 0
    while f"{pfx}.transformer_blocks.{i}.norm1.weight" in sd:
        bp = f"{pfx}.transformer_blocks.{i}"
        _pair(keys, f"{bp}.norm1")
        _attention(keys, f"{bp}.attn1")
        _pair(keys, f"{bp}.norm3")
        _pair(keys, f"{bp}.ff.net.0.proj")
        _pair(keys, f"{bp}.ff.net.2")
        if cross:  # after the FF, as the JAX exporter writes them
            _pair(keys, f"{bp}.norm2")
            _attention(keys, f"{bp}.attn2")
        i += 1


def unet_keys(sd: Mapping, config) -> List[str]:
    """The UNet's keys in the JAX exporter's order (``unet_sd_from_params``:
    conv_in, time_embedding, conv_norm_out, conv_out, then the blocks),
    with each block's ``norm2``/``attn2`` when ``config.use_cross_attention``
    (JAX :88-90); the optional parts (``time_emb_proj``, ``conv_shortcut``,
    the transformer blocks) as ``sd`` has them. The surgery's other
    parameters are not in the reference's format, as in JAX."""
    keys: List[str] = []
    for name in ("conv_in", "time_embedding.linear_1",
                 "time_embedding.linear_2", "conv_norm_out", "conv_out"):
        _pair(keys, name)
    n_blocks = len(config.block_out_channels)
    lpb = config.layers_per_block
    cross = bool(getattr(config, "use_cross_attention", False))
    for i in range(n_blocks):
        for j in range(lpb):
            _resnet(keys, sd, f"down_blocks.{i}.resnets.{j}")
            if config.attn_down[i]:
                _transformer(keys, sd, f"down_blocks.{i}.attentions.{j}",
                             cross)
        if i < n_blocks - 1:
            _pair(keys, f"down_blocks.{i}.downsamplers.0.conv")
    _resnet(keys, sd, "mid_block.resnets.0")
    _transformer(keys, sd, "mid_block.attentions.0", cross)
    _resnet(keys, sd, "mid_block.resnets.1")
    attn_up = tuple(reversed(config.attn_down))
    for i in range(n_blocks):
        for j in range(lpb + 1):
            _resnet(keys, sd, f"up_blocks.{i}.resnets.{j}")
            if attn_up[i]:
                _transformer(keys, sd, f"up_blocks.{i}.attentions.{j}",
                             cross)
        if i < n_blocks - 1:
            _pair(keys, f"up_blocks.{i}.upsamplers.0.conv")
    return keys


def image_vae_keys(sd: Mapping, decoder: bool = False) -> List[str]:
    """The AutoencoderKL encoder's keys and ``quant_conv`` in the JAX
    exporter's order (``image_vae_sd_from_params``), with ``decoder`` then
    the decoder's and ``post_quant_conv``; blocks and resnets as many as
    ``sd`` has."""
    keys: List[str] = []
    for name in ("encoder.conv_in", "encoder.conv_norm_out",
                 "encoder.conv_out"):
        _pair(keys, name)
    i = 0
    while f"encoder.down_blocks.{i}.resnets.0.norm1.weight" in sd:
        j = 0
        while f"encoder.down_blocks.{i}.resnets.{j}.norm1.weight" in sd:
            _resnet(keys, sd, f"encoder.down_blocks.{i}.resnets.{j}")
            j += 1
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            _pair(keys, f"encoder.down_blocks.{i}.downsamplers.0.conv")
        i += 1
    _resnet(keys, sd, "encoder.mid_block.resnets.0")
    _resnet(keys, sd, "encoder.mid_block.resnets.1")
    at = "encoder.mid_block.attentions.0"
    _pair(keys, f"{at}.group_norm")
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        _pair(keys, f"{at}.{name}")
    _pair(keys, "quant_conv")
    if not decoder:
        return keys
    for name in ("decoder.conv_in", "decoder.conv_norm_out",
                 "decoder.conv_out"):
        _pair(keys, name)
    i = 0
    while f"decoder.up_blocks.{i}.resnets.0.norm1.weight" in sd:
        j = 0
        while f"decoder.up_blocks.{i}.resnets.{j}.norm1.weight" in sd:
            _resnet(keys, sd, f"decoder.up_blocks.{i}.resnets.{j}")
            j += 1
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            _pair(keys, f"decoder.up_blocks.{i}.upsamplers.0.conv")
        i += 1
    _resnet(keys, sd, "decoder.mid_block.resnets.0")
    _resnet(keys, sd, "decoder.mid_block.resnets.1")
    at = "decoder.mid_block.attentions.0"
    _pair(keys, f"{at}.group_norm")
    for name in ("to_q", "to_k", "to_v", "to_out.0"):
        _pair(keys, f"{at}.{name}")
    _pair(keys, "post_quant_conv")
    return keys


def seg_vae_keys(block_out_channels=(32, 64, 128, 256),
                 num_upscalers: int = 1) -> List[str]:
    """The seg VAE's keys in the order of ``seg_vae_key_map``."""
    from .torch_import import seg_vae_key_map
    keys: List[str] = []
    for name in seg_vae_key_map(block_out_channels, num_upscalers):
        _pair(keys, name)
    return keys


def _ordered(sd: Mapping, keys: List[str]) -> StateDict:
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} keys, e.g. "
                       f"{missing[:3]}")
    return {k: sd[k].detach().to("cpu", torch.float32).contiguous().clone()
            for k in keys}


def export_reference_ldm(path: str, unet: Mapping, vae_image: Mapping,
                         vae_semseg: Mapping, unet_config,
                         block_out_channels=(32, 64, 128, 256),
                         num_upscalers: int = 1,
                         ema: Optional[Mapping] = None, step: int = 0,
                         epoch: int = 0) -> None:
    """Write the reference's stage-2 save dict from the port's state dicts
    (the UNet's, the image VAE's encoder, the seg VAE's and, with ``ema``,
    the EMA UNet's), what ``ldmseg_tpu``'s ``export_reference_ldm`` writes
    from the same weights."""
    keys = unet_keys(unet, unet_config)
    payload = {
        "step": step,
        "epoch": epoch,
        "unet": _ordered(unet, keys),
        "vae_image": _ordered(vae_image, image_vae_keys(
            vae_image, "post_quant_conv.weight" in vae_image)),
        "vae_semseg": _ordered(vae_semseg, seg_vae_keys(
            block_out_channels, num_upscalers)),
    }
    if ema is not None:
        shadows = _ordered(ema, keys)
        payload["ema"] = {"shadow_params": [shadows[k] for k in keys]}
    torch.save(payload, path)


def export_reference_ae(path: str, vae_semseg: Mapping, config: Mapping,
                        step: int = 0) -> None:
    """Write the reference's stage-1 save dict ``{'vae': <GeneralVAESeg
    state dict>, 'step'}`` from the port seg VAE's state dict, what
    ``ldmseg_tpu``'s ``TrainerAE.export_reference`` writes. ``config`` is
    the ``vae_model_kwargs``; the reference's keys cover the default
    topology only (JAX's ``seg_vae_key_map`` asserts the same), so the
    other encoders, mid blocks and the discrete bottlenecks raise."""
    other = {k: config.get(k) for k in ("resize_input", "skip_encoder",
                                         "image_encoder", "num_mid_blocks")
             if config.get(k)}
    if config.get("parametrization", "gaussian") != "gaussian":
        other["parametrization"] = config["parametrization"]
    if other:
        raise NotImplementedError(
            f"export of a seg VAE with {other}: the reference keys cover the "
            "default topology only")
    keys = seg_vae_keys(tuple(config.get("block_out_channels",
                                         (32, 64, 128, 256))),
                        config.get("num_upscalers", 1))
    torch.save({"vae": _ordered(vae_semseg, keys), "step": int(step)}, path)

