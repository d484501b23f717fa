"""Batch panoptic inference from the command line (counterpart of
``ldmseg_tpu/tools/predict.py``): per frame ``<stem>_cat.png`` and
``<stem>_ins.png`` (uint8, the frame's size), the layout the DVPQ
evaluator reads, ``stem`` the meta's ``image_id`` on 12 digits.

    python -m ldmseg_torch.tools.predict [datasets=synthetic]
        [out_dir=predictions] [checkpoint=run/checkpoints/step_N]
        [data_prefix=...] [image_only=True] [max_batches=N] [config=...]
        [device=cpu] [sampling_kwargs.num_inference_steps=50]
        [key.sub=value ...]

Per batch: RGB -> image-VAE encoder -> DDIM (a CUDA graph on the card) ->
seg-VAE decode -> the bilinear resize to the frame's size and the panoptic
post-process under the batch's mask. The segments are class-agnostic
instances: ``ins`` is the panoptic id (0 where none), ``cat`` is 0. The
UNet and its conditioning (``train_kwargs.image_descriptors``,
``descriptor_pretrained_path``; with a context ``sampling_kwargs.
guidance_scale`` runs classifier-free guidance) are built as ``main_ldm``
builds them, from the same overrides; a
``checkpoint`` of ``main_ldm`` is resumed (its EMA with ``ema_on``).
With ``clips=T`` the val frames are grouped into T-frame clips (stride T)
and sampled by ``sample_panoptic_clip``: clip-shared noise, and with a pose
net of ``main_pose`` (``pose_model_kwargs.pretrained_path``) the
pose-warped blend refined by a DDIM tail; the pairs are written per frame.
"""

from __future__ import annotations

import os
import sys

import numpy as np
from PIL import Image


def main(argv=None):
    """Write the prediction pairs; returns how many."""
    from ..data import make_loader
    from ..train.trainer_ldm import TrainerDiffusion
    from ..utils.config import load_config, merge_dicts, parse_dot_overrides
    from .main_ae import DATASET_PRESETS, build_datasets
    from .main_ldm import (attach_pose_from_config, build_unet_config,
                           descriptor_from_config, load_weights)

    from ..parallel.multihost import initialize_from_env

    overrides = parse_dot_overrides(sys.argv[1:] if argv is None else argv)
    dataset = overrides.pop("datasets", "synthetic")
    config_path = overrides.pop("config", None)
    prefix = overrides.pop("data_prefix", None)
    out_dir = overrides.pop("out_dir", "predictions")
    checkpoint = overrides.pop("checkpoint", None)
    max_batches = overrides.pop("max_batches", None)
    image_only = bool(overrides.pop("image_only", False))
    device = overrides.pop("device", "cuda")
    # one rank a GPU under torchrun or SLURM; one process without them
    device = initialize_from_env(device=device)["device"]
    clip_len = overrides.pop("clips", None)

    cfg = load_config(config_path)
    cfg = merge_dicts(cfg, DATASET_PRESETS.get(dataset, {}))
    cfg = merge_dicts(cfg, overrides)
    os.makedirs(out_dir, exist_ok=True)
    _, val_ds = build_datasets(
        cfg, prefix, val_kwargs={"image_only": True} if image_only else None)
    if clip_len:
        from ..data.video import ClipDataset
        val_ds = ClipDataset(val_ds, clip_len=int(clip_len),
                             stride=int(clip_len))
    desc = descriptor_from_config(cfg)
    trainer = TrainerDiffusion(cfg, unet_config=build_unet_config(cfg, desc),
                               device=device, val_dataset=val_ds,
                               descriptor=desc)
    load_weights(trainer, cfg)
    if clip_len:
        attach_pose_from_config(trainer, cfg)
    if checkpoint:
        trainer.resume(checkpoint)

    import torch
    # each rank writes its share of the frames, each frame once
    loader = make_loader(val_ds, cfg["eval_kwargs"].get("batch_size", 8),
                         shuffle=False, drop_last=False, pad=False)
    generator = torch.Generator(device=trainer.device).manual_seed(
        cfg["sampling_kwargs"].get("seed", 0))
    written = 0
    batches = loader.epoch(0)
    try:
        for bi, batch in enumerate(batches):
            if clip_len:
                from ..data.video import flatten_clip_batch
                logits, _ = trainer.sample_panoptic_clip(batch, generator)
                batch = flatten_clip_batch(batch)
            else:
                logits, _ = trainer.sample_panoptic(batch, generator)
            # the frames' size: image_only batches have no ground truth
            h, w = batch["image"].shape[-3:-1]
            cleaned = trainer.restore_resized(logits, (h, w), batch["mask"])
            for i, meta in enumerate(batch["meta"]):
                stem = f"{meta['image_id']:012d}"
                ins = np.maximum(cleaned[i], 0).astype(np.uint8)
                cat = np.zeros_like(ins)
                Image.fromarray(cat).save(
                    os.path.join(out_dir, f"{stem}_cat.png"))
                Image.fromarray(ins).save(
                    os.path.join(out_dir, f"{stem}_ins.png"))
                written += 1
            if max_batches is not None and bi + 1 >= int(max_batches):
                break
    finally:
        batches.close()
    print(f"wrote {written} prediction pairs to {out_dir}", flush=True)
    return written


if __name__ == "__main__":
    main()
