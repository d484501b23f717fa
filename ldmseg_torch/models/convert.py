"""JAX parameter trees -> the port's ``state_dict``s.

Takes the Flax trees of the JAX package as nested dicts of arrays (numpy, or
anything ``numpy.asarray`` reads) and returns ``{key: torch.Tensor}`` dicts
that the port's modules load with ``strict=True``. The keys and leaf
conventions are those of ``ldmseg_tpu/models/torch_export.py`` (its own
copy here):

  * conv ``[kh, kw, in, out]`` -> ``[out, in, kh, kw]``;
  * dense ``[in, out]`` -> ``[out, in]``;
  * conv-transpose ``[kh, kw, in, out]`` -> taps flipped,
    ``[in, out, kh, kw]``;
  * norm ``scale``/``bias`` -> ``weight``/``bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(sd: StateDict, name: str, leaf) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{name}.bias"] = _t(leaf["bias"])


def _conv_transpose(sd: StateDict, name: str, leaf) -> None:
    k = np.asarray(leaf["kernel"])[::-1, ::-1]  # undo the correlation flip
    sd[f"{name}.weight"] = _t(k.transpose(2, 3, 0, 1))
    sd[f"{name}.bias"] = _t(leaf["bias"])


def _dense(sd: StateDict, name: str, leaf) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).transpose(1, 0))
    if "bias" in leaf:
        sd[f"{name}.bias"] = _t(leaf["bias"])


def _norm(sd: StateDict, name: str, leaf) -> None:
    sd[f"{name}.weight"] = _t(leaf["scale"])
    sd[f"{name}.bias"] = _t(leaf["bias"])


def _resnet(sd: StateDict, pfx: str, node) -> None:
    _norm(sd, f"{pfx}.norm1", node["norm1"])
    _conv(sd, f"{pfx}.conv1", node["conv1"])
    _norm(sd, f"{pfx}.norm2", node["norm2"])
    _conv(sd, f"{pfx}.conv2", node["conv2"])
    if "time_emb_proj" in node:
        _dense(sd, f"{pfx}.time_emb_proj", node["time_emb_proj"])
    if "conv_shortcut" in node:
        _conv(sd, f"{pfx}.conv_shortcut", node["conv_shortcut"])


def _attention(sd: StateDict, pfx: str, node) -> None:
    for ours in ("to_q", "to_k", "to_v"):
        _dense(sd, f"{pfx}.{ours}", node[ours])
    _dense(sd, f"{pfx}.to_out.0", node["to_out"])


def _transformer(sd: StateDict, pfx: str, node) -> None:
    _norm(sd, f"{pfx}.norm", node["norm"])
    _conv(sd, f"{pfx}.proj_in", node["proj_in"])
    _conv(sd, f"{pfx}.proj_out", node["proj_out"])
    i = 0
    while f"block{i}" in node:
        bp, blk = f"{pfx}.transformer_blocks.{i}", node[f"block{i}"]
        _norm(sd, f"{bp}.norm1", blk["norm1"])
        _attention(sd, f"{bp}.attn1", blk["attn1"])
        if "attn2" in blk:  # use_cross_attention
            _norm(sd, f"{bp}.norm2", blk["norm2"])
            _attention(sd, f"{bp}.attn2", blk["attn2"])
        _norm(sd, f"{bp}.norm3", blk["norm3"])
        _dense(sd, f"{bp}.ff.net.0.proj", blk["ff"]["proj_in"])
        _dense(sd, f"{bp}.ff.net.2", blk["ff"]["proj_out"])
        i += 1


def _root(params: Mapping) -> Mapping:
    return params["params"] if "params" in params else params


def _down_blocks(sd: StateDict, p: Mapping, config, ours: str,
                 theirs: str) -> None:
    n_blocks = len(config.block_out_channels)
    for i in range(n_blocks):
        blk = p[f"{theirs}{i}"]
        for j in range(config.layers_per_block):
            _resnet(sd, f"{ours}.{i}.resnets.{j}", blk[f"resnet{j}"])
            if config.attn_down[i]:
                _transformer(sd, f"{ours}.{i}.attentions.{j}",
                             blk[f"attn{j}"])
        if i < n_blocks - 1:
            _conv(sd, f"{ours}.{i}.downsamplers.0.conv",
                  blk["downsample"]["conv"])


def _upscaler_head(sd: StateDict, pfx: str, node) -> None:
    _conv(sd, f"{pfx}.conv1", node["conv1"])
    _conv_transpose(sd, f"{pfx}.convt", node["convt"])
    _norm(sd, f"{pfx}.ln", node["ln"]["ln"])
    _conv(sd, f"{pfx}.conv2", node["conv2"])
    _norm(sd, f"{pfx}.norm", node["norm"])
    _conv(sd, f"{pfx}.conv3", node["conv3"])


def unet_state_dict_from_jax(params: Mapping, config) -> StateDict:
    """JAX ``UNet2DCondition`` tree -> :class:`~.unet.UNet2DCondition` state
    dict. ``config`` is a ``UNetConfig`` of either package (its sizes);
    the optional parts are read as the tree has them: ``norm2``/``attn2``,
    ``encoder_hid_proj``, ``object_queries`` (``object_queries.weight``),
    ``conv_in_seg``, ``conv_in_img``, ``down_blocks_img{i}``
    (``down_blocks_img.{i}``), ``adaptor{i}_{j}`` (``adaptors.{i}.{j}``)
    and the ``upscaler`` head in place of ``conv_out``."""
    p = _root(params)
    n_blocks = len(config.block_out_channels)
    lpb = config.layers_per_block
    sd: StateDict = {}
    _conv(sd, "conv_in", p["conv_in"])
    for name in ("conv_in_seg", "conv_in_img"):
        if name in p:
            _conv(sd, name, p[name])
    _dense(sd, "time_embedding.linear_1", p["time_embedding"]["linear_1"])
    _dense(sd, "time_embedding.linear_2", p["time_embedding"]["linear_2"])
    if "encoder_hid_proj" in p:
        _dense(sd, "encoder_hid_proj", p["encoder_hid_proj"])
    if "object_queries" in p:
        sd["object_queries.weight"] = _t(p["object_queries"])
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    if "upscaler" in p:
        _upscaler_head(sd, "upscaler", p["upscaler"])
    else:
        _conv(sd, "conv_out", p["conv_out"])
    _down_blocks(sd, p, config, "down_blocks", "down_blocks")
    if "down_blocks_img0" in p:
        _down_blocks(sd, p, config, "down_blocks_img", "down_blocks_img")
    for key in p:
        if key.startswith("adaptor"):
            i, j = key[len("adaptor"):].split("_")
            _conv(sd, f"adaptors.{i}.{j}", p[key])
    mid = p["mid_block"]
    _resnet(sd, "mid_block.resnets.0", mid["resnet0"])
    _transformer(sd, "mid_block.attentions.0", mid["attn"])
    _resnet(sd, "mid_block.resnets.1", mid["resnet1"])
    attn_up = tuple(reversed(config.attn_down))
    for i in range(n_blocks):
        blk = p[f"up_blocks{i}"]
        for j in range(lpb + 1):
            _resnet(sd, f"up_blocks.{i}.resnets.{j}", blk[f"resnet{j}"])
            if attn_up[i]:
                _transformer(sd, f"up_blocks.{i}.attentions.{j}",
                             blk[f"attn{j}"])
        if i < n_blocks - 1:
            _conv(sd, f"up_blocks.{i}.upsamplers.0.conv",
                  blk["upsample"]["conv"])
    return sd


def upscaler_state_dict_from_jax(params: Mapping, num_upscalers: int = 1,
                                num_mid_blocks: int = 0) -> StateDict:
    """JAX ``Upscaler`` tree -> :class:`~.upscaler.Upscaler` state dict:
    its ``decoder`` under the seg VAE decoder's Sequential indices."""
    from .seg_vae import decoder_plan
    sd: StateDict = {}
    _plan(sd, "decoder", _root(params)["decoder"],
          decoder_plan(num_upscalers, num_mid_blocks))
    return sd


def _vae_encoder(sd: StateDict, pfx: str, enc: Mapping) -> None:
    """The AutoencoderKL encoder topology (``VAEEncoder``)."""
    _conv(sd, f"{pfx}.conv_in", enc["conv_in"])
    _norm(sd, f"{pfx}.conv_norm_out", enc["norm_out"])
    _conv(sd, f"{pfx}.conv_out", enc["conv_out"])
    i = 0
    while f"down{i}" in enc:
        blk = enc[f"down{i}"]
        j = 0
        while f"resnet{j}" in blk:
            _resnet(sd, f"{pfx}.down_blocks.{i}.resnets.{j}",
                    blk[f"resnet{j}"])
            j += 1
        if "downsample" in blk:
            _conv(sd, f"{pfx}.down_blocks.{i}.downsamplers.0.conv",
                  blk["downsample"])
        i += 1
    _resnet(sd, f"{pfx}.mid_block.resnets.0", enc["mid_resnet0"])
    _resnet(sd, f"{pfx}.mid_block.resnets.1", enc["mid_resnet1"])
    at = enc["mid_attn"]
    _norm(sd, f"{pfx}.mid_block.attentions.0.group_norm", at["group_norm"])
    _attention(sd, f"{pfx}.mid_block.attentions.0", at)


def _vae_decoder(sd: StateDict, pfx: str, dec: Mapping) -> None:
    """The AutoencoderKL decoder topology (``VAEDecoder``)."""
    _conv(sd, f"{pfx}.conv_in", dec["conv_in"])
    _norm(sd, f"{pfx}.conv_norm_out", dec["norm_out"])
    _conv(sd, f"{pfx}.conv_out", dec["conv_out"])
    i = 0
    while f"up{i}" in dec:
        blk = dec[f"up{i}"]
        j = 0
        while f"resnet{j}" in blk:
            _resnet(sd, f"{pfx}.up_blocks.{i}.resnets.{j}",
                    blk[f"resnet{j}"])
            j += 1
        if "upsample" in blk:
            _conv(sd, f"{pfx}.up_blocks.{i}.upsamplers.0.conv",
                  blk["upsample"])
        i += 1
    _resnet(sd, f"{pfx}.mid_block.resnets.0", dec["mid_resnet0"])
    _resnet(sd, f"{pfx}.mid_block.resnets.1", dec["mid_resnet1"])
    at = dec["mid_attn"]
    _norm(sd, f"{pfx}.mid_block.attentions.0.group_norm", at["group_norm"])
    _attention(sd, f"{pfx}.mid_block.attentions.0", at)


def image_vae_state_dict_from_jax(params: Mapping) -> StateDict:
    """JAX ``ImageVAE`` tree -> :class:`~.image_vae.ImageVAE` state dict:
    the encoder and ``quant_conv`` (the tree ``ImageVAE.encode``
    initialises), and where the tree has them the decoder and
    ``post_quant_conv`` (``decoder_enabled``)."""
    p = _root(params)
    sd: StateDict = {}
    _vae_encoder(sd, "encoder", p["encoder"])
    _conv(sd, "quant_conv", p["quant_conv"])
    if "decoder" in p:
        _vae_decoder(sd, "decoder", p["decoder"])
        _conv(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def _mid_block(sd: StateDict, pfx: str, node) -> None:
    _resnet(sd, f"{pfx}.resnets.0", node["resnet0"])
    _resnet(sd, f"{pfx}.resnets.1", node["resnet1"])


def _plan(sd: StateDict, group: str, tree: Mapping, plan) -> None:
    for i, (name, kind) in enumerate(plan):
        pfx = f"{group}.{i}"
        if kind == "conv":
            _conv(sd, pfx, tree[name])
        elif kind == "convt":
            _conv_transpose(sd, pfx, tree[name])
        elif kind == "norm":
            _norm(sd, pfx, tree[name])
        elif kind == "ln2d":
            _norm(sd, pfx, tree[name]["ln"])
        elif kind == "mid":
            _mid_block(sd, pfx, tree[name])
        elif kind == "mids":
            j = 0
            while f"mid{j}" in tree:
                _mid_block(sd, f"{pfx}.{j}", tree[f"mid{j}"])
                j += 1


def seg_vae_state_dict_from_jax(params: Mapping, config: Mapping
                                ) -> StateDict:
    """JAX ``SegVAE`` variables -> :class:`~.seg_vae.SegVAE` state dict, for
    every option: the Sequential indices of
    :func:`~.seg_vae.encoder_plan`/:func:`~.seg_vae.decoder_plan` (the
    reference's keys), the image encoder's AutoencoderKL keys, and the
    codebook (``codebook.weight``): the ``codebook`` parameter, or under
    ``freeze_codebook`` the ``"constants"`` variable, which ``params`` must
    then hold beside ``"params"``. ``config`` is the ``vae_model_kwargs``
    the model was built from."""
    from .seg_vae import decoder_plan, encoder_plan
    root = _root(params)
    sd: StateDict = {}
    n_mid = config.get("num_mid_blocks", 0)
    if config.get("image_encoder", False):
        _vae_encoder(sd, "encoder", root["encoder"])
    else:
        _plan(sd, "encoder", root["encoder"], encoder_plan(
            config.get("block_out_channels", (32, 64, 128, 256)), n_mid,
            config.get("resize_input", False),
            config.get("skip_encoder", False)))
    _plan(sd, "decoder", root["decoder"],
          decoder_plan(config.get("num_upscalers", 1), n_mid))
    if config.get("parametrization", "gaussian").startswith("discrete"):
        if config.get("freeze_codebook", False):
            if "constants" not in params:
                raise KeyError("a frozen codebook needs the JAX variables' "
                               "'constants' collection")
            sd["codebook.weight"] = _t(params["constants"]["codebook"])
        else:
            sd["codebook.weight"] = _t(root["codebook"])
    return sd


def pose_state_dict_from_jax(params: Mapping,
                             output_exp: bool = False) -> StateDict:
    """JAX ``PoseExpNet`` tree -> :class:`~.posenet.PoseExpNet` state dict,
    with the ``upconv*`` and ``predict_mask*`` leaves when ``output_exp``.
    A tree trained with ``output_exp`` converts for a model without it
    (those leaves dropped, as Flax ignores them); any other missing or
    extra leaf raises."""
    from .posenet import DECODER_PREFIXES, PLANES, UP_PLANES
    root = _root(params)
    encoder = [f"conv{i + 1}" for i in range(len(PLANES))] + ["pose_pred"]
    decoder = ([f"upconv{5 - i}" for i in range(len(UP_PLANES))]
               + [f"predict_mask{4 - i}" for i in range(len(UP_PLANES) - 1)])
    want = set(encoder) | (set(decoder) if output_exp else set())
    have = {k for k in root if output_exp or not k.startswith(
        DECODER_PREFIXES)}
    if have != want:
        raise KeyError(f"PoseExpNet tree: missing {sorted(want - have)}, "
                       f"extra {sorted(have - want)}")
    sd: StateDict = {}
    for name in encoder:
        _conv(sd, name, root[name])
    if output_exp:
        for name in decoder:
            (_conv_transpose if name.startswith("upconv") else _conv)(
                sd, name, root[name])
    return sd
