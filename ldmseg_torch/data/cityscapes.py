"""Cityscapes-DVPS reader, the port's own copy (numpy and PIL) of
``ldmseg_tpu/data/cityscapes.py:CityscapesDVPS``.

Cityscapes-DVPS dataset.

Reference: ldmseg/data/cityscapes.py:23-366. Layout:
``{scene}_{frame}_..._{leftImg8bit|instanceTrainIds|depth}.png``; the
panoptic map is a single ``instanceTrainIds`` id image, remapped with the
size-aware random remap (min_pixels=10, :293-366) and encoded as 16
analog-bit channels with ignore=127 (:218-220, num_classes=128).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from PIL import Image

from .mask_generator import MaskingGenerator
from .remap import remap_contiguous, remap_random
from .transforms import (
    resize_rgb, normalize_imagenet, resize_label, resize_depth)
from .transforms import encode_bits_host


class CityscapesDVPS:
    def __init__(
        self,
        prefix: str,
        split: str = "train",
        size: Tuple[int, int] = (192, 640),
        num_classes: int = 128,
        num_bits: int = 16,
        ignore_label: int = 127,
        fill_value: float = 0.5,
        inpainting_strength: float = 0.0,
        inpaint_mask_size: Tuple[int, int] = (64, 64),
        encoding_mode: str = "bits",
        remap_labels: bool = True,
        min_pixels: int = 10,
        flip: bool = False,
        crop_mode: str | None = None,
        keep_fullres_gt: bool = False,
        seed: int = 0,
        normalize_params: dict | None = None,
    ):
        assert split in ("train", "val", "test")
        # train-time augmentation (reference get_train_transforms)
        self.flip = flip and split == "train"
        self.crop_mode = crop_mode if split == "train" else None
        # original-resolution GT in meta for per-image eval restore
        # (reference compute_pq, trainers_ldm_cond.py:1264-1284)
        self.keep_fullres_gt = keep_fullres_gt
        self.root = prefix
        self.split = split
        self.size = size
        self.num_classes = num_classes
        self.num_bits = num_bits
        self.ignore_label = ignore_label
        self.fill_value = fill_value
        self.encoding_mode = encoding_mode
        self.remap_labels = remap_labels
        self.min_pixels = min_pixels if split == "train" else 0
        self.seed = seed
        self.inpainting_strength = inpainting_strength
        np_ = normalize_params or {}
        self.norm_mean, self.norm_std = np_.get("mean"), np_.get("std")
        self.maskgen = MaskingGenerator(input_size=inpaint_mask_size,
                                        mode="random_local")
        from .base import get_metadata
        self.meta_data = get_metadata(num_classes, root=prefix)
        self.samples = self._index(os.path.join(prefix, split))

    @staticmethod
    def _index(image_dir: str) -> list:
        """Group by (scene, frame); type is the last name part
        (cityscapes.py:122-146)."""
        table: dict = {}
        if not os.path.isdir(image_dir):
            return []
        for file in sorted(os.listdir(image_dir)):
            base, ext = os.path.splitext(file)
            if ext.lower() != ".png":
                continue
            parts = base.split("_")
            if len(parts) < 5:
                continue
            scene, frame, typ = parts[0], parts[1], parts[-1]
            table.setdefault(scene, {}).setdefault(frame, {})[typ] = \
                os.path.join(image_dir, file)
        samples = []
        for scene in table.values():
            for frame in scene.values():
                if all(k in frame for k in
                       ("leftImg8bit", "instanceTrainIds", "depth")):
                    samples.append(frame)
        return samples

    def get_class_names(self):
        from .base import CITYSCAPES_CATEGORY_NAMES
        return CITYSCAPES_CATEGORY_NAMES

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int, epoch: int = 0) -> dict:
        paths = self.samples[idx]
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        h, w = self.size

        rgb_img = Image.open(paths["leftImg8bit"])
        from .transforms import square_crop_box
        box = square_crop_box(rgb_img.size, self.crop_mode, rng)

        image = normalize_imagenet(resize_rgb(rgb_img, self.size, box=box),
                                   self.norm_mean, self.norm_std)
        pan_raw = resize_label(Image.open(paths["instanceTrainIds"]),
                               self.size, dtype=np.int32, box=box)
        depth = resize_depth(Image.open(paths["depth"]), self.size, box=box)

        def _remap(arr):
            if self.remap_labels:
                return remap_random(arr, self.num_classes,
                                    self.ignore_label, rng,
                                    min_pixels=self.min_pixels)[0]
            return remap_contiguous(arr, self.ignore_label)[0]

        sem_full = mask_full = None
        if self.keep_fullres_gt:
            pan_pil = Image.open(paths["instanceTrainIds"])
            if box is not None:
                pan_pil = pan_pil.crop(box)
            pan_full_raw = np.asarray(pan_pil).astype(np.int32)
            sem_full = _remap(pan_full_raw).astype(np.int32)
            mask_full = (sem_full <= 128).astype(np.uint8)
            semseg = resize_label(Image.fromarray(sem_full, mode="I"),
                                  self.size)
        else:
            semseg = _remap(pan_raw)
        assert semseg.max() < self.num_classes

        mask = np.ones((h, w), dtype=np.uint8)
        mask[semseg > 128] = 0  # (cityscapes.py:215-216)

        sample = {
            "image": image,
            "semseg": semseg.astype(np.int32),
            "depth": depth,
            "mask": mask,
            "text": "",
        }
        if self.encoding_mode == "bits":
            bits = encode_bits_host(semseg, self.num_bits,
                                     ignore_label=self.ignore_label,
                                     fill_value=self.fill_value)
            sample["image_semseg"] = bits
        else:
            sample["image_semseg"] = np.repeat(
                semseg[..., None].astype(np.float32) / self.num_classes, 3,
                axis=-1)

        sample["inpainting_mask"] = self.maskgen(
            t=self.inpainting_strength, rng=rng).astype(bool)

        base = os.path.basename(paths["leftImg8bit"]).split("_")
        try:
            image_id = int(base[0]) * 10000 + int(base[1])
        except ValueError:
            image_id = idx
        sample["meta"] = {
            "im_size": (h, w),
            "image_file": paths["leftImg8bit"],
            "image_id": image_id,
            "gt_cat": pan_raw.astype(np.int32),
        }
        if self.keep_fullres_gt:
            sample["meta"]["gt_sem"] = sem_full
            sample["meta"]["gt_mask"] = mask_full
            sample["meta"]["im_size"] = sem_full.shape
        if self.flip and rng.random() < 0.5:
            from .transforms import hflip_sample
            sample = hflip_sample(sample)
        return sample

    def __str__(self):
        return f"CityscapesDVPS(split={self.split}, n={len(self)})"
