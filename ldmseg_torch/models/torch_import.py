"""Reading the reference's torch checkpoints into the port's state dicts
(counterpart of ``ldmseg_tpu/models/torch_import.py``).

Reads LOCAL files only: a diffusers model directory
(``<dir>/unet/diffusion_pytorch_model.{safetensors,bin}``, ``<dir>/vae/...``),
the reference's stage-2 save dict and its stage-1 ``{'vae': ...}`` dict.
The port's modules carry the reference's keys and layouts, so a state dict is
read by picking the keys the model uses (:mod:`.torch_export`'s key lists: a
diffusers UNet's cross-attention ``attn2``/``norm2`` only with the config's
``use_cross_attention``, as JAX's ``torch_import.py:108-110``, and a VAE's
decoder only when ``decoder_enabled`` asks for it), in fp32; ``module.``
prefixes are stripped.
``.bin`` files and save dicts load with ``torch.load(weights_only=True)``;
``.safetensors`` files are parsed here (an 8-byte little-endian header length,
a JSON header, then the raw buffers), with no ``safetensors`` package.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .torch_export import (StateDict, _ordered, image_vae_keys, seg_vae_keys,
                           unet_keys)

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, as CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != size * int(np.prod(info["shape"], dtype=np.int64)):
            raise ValueError(f"{path}: {name} spans {end - begin} bytes for "
                             f"shape {info['shape']} of {info['dtype']}")
        flat = (torch.frombuffer(data, dtype=dtype, count=(end - begin)
                                 // size, offset=begin)
                if end > begin else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"]).clone()
    return out


def _strip(sd: Mapping) -> StateDict:
    return {k.replace("module.", ""): torch.as_tensor(v)
            for k, v in sd.items()}


def _diffusers_state_dict(model_dir: str, subdir: str) -> StateDict:
    base = os.path.join(model_dir, subdir)
    for name in ("diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin"):
        path = os.path.join(base, name)
        if os.path.exists(path):
            if name.endswith(".safetensors"):
                return read_safetensors(path)
            return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no diffusers weights under {base}")


def unet_state_dict(sd: Mapping, config) -> StateDict:
    """The port UNet's state dict (``config`` its ``UNetConfig``) out of a
    diffusers UNet state dict."""
    sd = _strip(sd)
    return _ordered(sd, unet_keys(sd, config))


def image_vae_state_dict(sd: Mapping, decoder_enabled: bool = False
                         ) -> StateDict:
    """The port ImageVAE's state dict (the encoder and ``quant_conv``; with
    ``decoder_enabled`` also the decoder and ``post_quant_conv``, JAX
    ``torch_import.py:196-245``) out of an AutoencoderKL state dict; the
    legacy attention names (``query``, ``key``, ``value``, ``proj_attn``)
    read as ``to_q``, ``to_k``, ``to_v``, ``to_out.0``."""
    legacy = {".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.",
              ".proj_attn.": ".to_out.0."}
    renamed = {}
    for k, v in _strip(sd).items():
        for old, new in legacy.items():
            if ".attentions." in k and old in k:
                k = k.replace(old, new)
        renamed[k] = v
    return _ordered(renamed, image_vae_keys(renamed, decoder_enabled))


def load_diffusers_unet(model_dir: str, config) -> StateDict:
    """The port UNet's state dict from ``<model_dir>/unet``: the SD-1.4
    UNet's, with its pretrained ``attn2``/``norm2`` when
    ``config.use_cross_attention`` and without them otherwise (its
    ``conv_in`` still 4 channels: :func:`expand_conv_in` widens it)."""
    return unet_state_dict(_diffusers_state_dict(model_dir, "unet"), config)


def load_diffusers_vae(model_dir: str,
                       decoder_enabled: bool = False) -> StateDict:
    """The port ImageVAE's state dict from ``<model_dir>/vae``, the decoder
    too with ``decoder_enabled`` (for ``ImageVAE(decoder_enabled=True)``;
    the trainer's image VAE is the encoder only, the port's default)."""
    return image_vae_state_dict(_diffusers_state_dict(model_dir, "vae"),
                                decoder_enabled)


def _expand_slice(base: np.ndarray, mode: str, rng: np.random.RandomState,
                  fan_in: int) -> np.ndarray:
    """One 4-channel slice of the widened kernel, ``base`` in the JAX
    layout ``[kh, kw, 4, out]`` (``ldmseg_tpu/models/unet.py:
    _expand_slice``)."""
    if mode == "copy":
        return base.copy()
    if mode == "div":
        return base / 2.0
    if mode == "mean":
        return np.repeat(base.mean(axis=2, keepdims=True), base.shape[2],
                         axis=2)
    if mode == "zero":
        return np.zeros_like(base)
    if mode == "random":
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, size=base.shape).astype(base.dtype)
    raise NotImplementedError(f"init mode {mode!r}")


def expand_conv_in(sd: Mapping, init_mode_seg: str = "copy",
                   init_mode_image: str = "zero", cond_channels: int = 0,
                   init_mode_cond: str = "zero", seed: int = 0) -> StateDict:
    """Widen a pretrained 4-channel ``conv_in`` to ``8 + cond_channels``
    input channels (reference ``modify_encoder``; ``ldmseg_tpu``'s
    ``expand_conv_in``, the same numpy draws): the seg slice, the image
    slice and the condition slices by their init modes. The bias is
    kept. Returns a new state dict."""
    out = dict(sd)
    w = sd["conv_in.weight"]
    if w.shape[1] != 4:
        raise ValueError(f"conv_in must start from the SD 4-channel kernel, "
                         f"got {tuple(w.shape)}")
    kernel = w.detach().float().permute(2, 3, 1, 0).numpy()  # [3, 3, 4, O]
    rng = np.random.RandomState(seed)
    fan_in = (8 + cond_channels) * kernel.shape[0] * kernel.shape[1]
    parts = [_expand_slice(kernel, init_mode_seg, rng, fan_in),
             _expand_slice(kernel, init_mode_image, rng, fan_in)]
    if cond_channels > 0:
        cond = _expand_slice(kernel, init_mode_cond, rng, fan_in)
        reps = -(-cond_channels // 4)
        parts.append(np.tile(cond, (1, 1, reps, 1))[:, :, :cond_channels])
    new = np.concatenate(parts, axis=2).astype(np.float32)
    out["conv_in.weight"] = torch.from_numpy(
        np.ascontiguousarray(new.transpose(3, 2, 0, 1)))
    return out


def seg_vae_key_map(block_out_channels=(32, 64, 128, 256),
                    num_upscalers: int = 1,
                    num_mid_blocks: int = 0) -> Dict[str, tuple]:
    """The reference ``GeneralVAESeg``'s Sequential indices
    (``encoder.<i>`` / ``decoder.<i>``) -> ``(group, name, kind)`` of the
    JAX SegVAE (own copy of ``ldmseg_tpu``'s ``seg_vae_key_map``); the
    port's SegVAE uses the indices as its keys. The default topology only
    (no mid blocks)."""
    if num_mid_blocks:
        raise NotImplementedError("seg VAE mid blocks are not ported")
    m: Dict[str, tuple] = {"encoder.0": ("encoder", "in_conv", "conv")}
    idx = 2
    for i in range(len(block_out_channels) - 1):
        m[f"encoder.{idx}"] = ("encoder", f"down{i}_conv1", "conv")
        m[f"encoder.{idx + 1}"] = ("encoder", f"down{i}_conv2", "conv")
        idx += 3  # conv, conv, SiLU
    m[f"encoder.{idx}"] = ("encoder", "out_conv1", "conv")
    idx += 2  # conv + Identity (no mid blocks)
    m[f"encoder.{idx}"] = ("encoder", "norm", "norm")
    m[f"encoder.{idx + 2}"] = ("encoder", "out_conv2", "conv")
    m["decoder.0"] = ("decoder", "in_conv", "conv")
    idx = 2  # conv_in + Identity (no mid blocks)
    for i in range(num_upscalers):
        m[f"decoder.{idx}"] = ("decoder", f"up{i}_convt", "convt")
        m[f"decoder.{idx + 1}"] = ("decoder", f"up{i}_ln", "ln2d")
        idx += 3  # convT, LayerNorm2d, SiLU
    m[f"decoder.{idx}"] = ("decoder", "norm", "norm")
    m[f"decoder.{idx + 2}"] = ("decoder", "out_conv", "conv")
    return m


def seg_vae_state_dict(sd: Mapping, block_out_channels=(32, 64, 128, 256),
                       num_upscalers: int = 1) -> StateDict:
    """The port SegVAE's state dict out of a ``GeneralVAESeg`` one."""
    return _ordered(_strip(sd), seg_vae_keys(block_out_channels,
                                             num_upscalers))


def load_reference_seg_vae(path: str, block_out_channels=(32, 64, 128, 256),
                           num_upscalers: int = 1,
                           state_key: str = "vae") -> StateDict:
    """The port SegVAE's state dict from a reference stage-1 checkpoint
    (``torch.save({'vae': ...})``, or the bare state dict)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    sd = data[state_key] if isinstance(data, dict) and state_key in data \
        else data
    return seg_vae_state_dict(sd, block_out_channels, num_upscalers)


def load_reference_ldm(path: str, unet_config,
                       block_out_channels=(32, 64, 128, 256),
                       num_upscalers: int = 1,
                       image_vae_decoder: bool = False) -> dict:
    """The reference's stage-2 save dict ``{step, epoch, vae_image,
    vae_semseg, unet, ema?, ...}`` as the port's state dicts: ``{"unet",
    "vae_image", "vae_semseg", "ema" (or None), "step"}``. The EMA's
    ``shadow_params`` list is read in the order of the file's ``unet``
    keys (a dict of named tensors is read by name). ``image_vae_decoder``
    also reads ``vae_image``'s decoder and ``post_quant_conv``."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    raw_unet = _strip(data["unet"])
    out = {"unet": unet_state_dict(raw_unet, unet_config),
           "vae_image": image_vae_state_dict(data["vae_image"],
                                             image_vae_decoder),
           "vae_semseg": seg_vae_state_dict(
               data["vae_semseg"], block_out_channels, num_upscalers),
           "ema": None,
           "step": int(data.get("step") or 0)}
    ema: Optional[Mapping] = data.get("ema")
    if ema:
        shadows = ema.get("shadow_params", ema)
        if isinstance(shadows, Mapping):
            ema_sd = _strip(shadows)
        else:
            ema_sd = dict(zip(raw_unet.keys(), shadows))
        out["ema"] = unet_state_dict(ema_sd, unet_config)
    return out
