"""COCO panoptic reader, the port's own copy (numpy and PIL) of
``ldmseg_tpu/data/coco.py:CocoPanoptic``.

COCO panoptic dataset (the original LDMSeg dataset).

Reference: ldmseg/data/coco.py:24-624. Panoptic annotations come as the
standard COCO panoptic format: a json with per-image ``segments_info`` and
RGB-encoded id PNGs (``id = R + 256*G + 256^2*B``). Per sample:

  * segments are filtered (crowd regions and segments smaller than
    ``pixel_threshold`` px are dropped to ignore, coco.py:494-508),
  * remaining segment ids are randomly remapped into [1, num_classes)
    (:321-352) — or contiguously when ``remap_labels=False``,
  * the id map is encoded into 7 analog-bit channels (:378-391, 460-463),
  * captions (when a captions json is given) feed the text conditioning
    path (:239-258); caption_dropout blanks them.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from .mask_generator import MaskingGenerator
from .remap import remap_contiguous, remap_random
from .transforms import resize_rgb, normalize_imagenet, resize_label
from .transforms import encode_bits_host


def rgb_to_id(arr: np.ndarray) -> np.ndarray:
    """COCO panoptic RGB id encoding (panopticapi convention)."""
    arr = arr.astype(np.int64)
    return arr[..., 0] + 256 * arr[..., 1] + 256 * 256 * arr[..., 2]


class CocoPanoptic:
    def __init__(
        self,
        prefix: str,
        split: str = "train",
        size: Tuple[int, int] = (512, 512),
        num_classes: int = 128,
        num_bits: int = 7,
        ignore_label: int = 0,
        fill_value: float = 0.5,
        remap_labels: bool = True,
        pixel_threshold: int = 100,
        caption_dropout: float = 0.0,
        inpainting_strength: float = 0.0,
        panoptic_json: Optional[str] = None,
        captions_json: Optional[str] = None,
        flip: bool = False,
        crop_mode: Optional[str] = None,
        seed: int = 0,
        normalize_params: Optional[dict] = None,
    ):
        # train-time augmentation (reference get_train_transforms)
        self.flip = flip and split == "train"
        np_ = normalize_params or {}
        self.norm_mean, self.norm_std = np_.get("mean"), np_.get("std")
        self.crop_mode = crop_mode if split == "train" else None
        self.root = prefix
        self.split = split
        self.size = size
        self.num_classes = num_classes
        self.num_bits = num_bits
        self.ignore_label = ignore_label
        self.fill_value = fill_value
        self.remap_labels = remap_labels
        self.pixel_threshold = pixel_threshold if split == "train" else 0
        self.caption_dropout = caption_dropout
        self.seed = seed
        self.inpainting_strength = inpainting_strength
        self.maskgen = MaskingGenerator(input_size=(64, 64),
                                        mode="random_local")

        year = "2017"
        self.image_dir = os.path.join(prefix, f"{split}{year}")
        self.panoptic_dir = os.path.join(prefix,
                                         f"panoptic_{split}{year}")
        pj = panoptic_json or os.path.join(
            prefix, "annotations", f"panoptic_{split}{year}.json")
        self.annotations = []
        self.captions: dict = {}
        if os.path.exists(pj):
            with open(pj) as f:
                data = json.load(f)
            self.annotations = data.get("annotations", [])
            self.categories = {c["id"]: c for c in data.get("categories",
                                                            [])}
        cj = captions_json or os.path.join(
            prefix, "annotations", f"captions_{split}{year}.json")
        if os.path.exists(cj):
            with open(cj) as f:
                for ann in json.load(f).get("annotations", []):
                    self.captions.setdefault(ann["image_id"], []).append(
                        ann["caption"])

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, idx: int, epoch: int = 0) -> dict:
        ann = self.annotations[idx]
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))
        h, w = self.size

        pan_png = os.path.join(self.panoptic_dir, ann["file_name"])
        pan_rgb = np.asarray(Image.open(pan_png).convert("RGB"))
        pan_ids = rgb_to_id(pan_rgb)

        # segment filtering (coco.py:494-508): crowd + small -> ignore
        id_map = np.full_like(pan_ids, self.ignore_label)
        kept = []
        for seg in ann.get("segments_info", []):
            m = pan_ids == seg["id"]
            if seg.get("iscrowd", 0):
                continue
            if self.pixel_threshold and m.sum() < self.pixel_threshold:
                continue
            kept.append((seg, m))
        for new_id, (seg, m) in enumerate(kept, start=1):
            id_map[m] = new_id

        from .transforms import square_crop_box
        box = square_crop_box((pan_ids.shape[1], pan_ids.shape[0]),
                              self.crop_mode, rng)
        id_map = resize_label(Image.fromarray(id_map.astype(np.int32),
                                              mode="I"), self.size, box=box)

        if self.remap_labels:
            semseg, _ = remap_random(id_map, self.num_classes,
                                     self.ignore_label, rng)
        else:
            semseg, _ = remap_contiguous(id_map, self.ignore_label)

        img_name = ann["file_name"].replace(".png", ".jpg")
        img_path = os.path.join(self.image_dir, img_name)
        image = normalize_imagenet(resize_rgb(Image.open(img_path),
                                              self.size, box=box),
                                   self.norm_mean, self.norm_std)

        bits = encode_bits_host(semseg, self.num_bits,
                                 ignore_label=self.ignore_label,
                                 fill_value=self.fill_value)

        text = ""
        caps = self.captions.get(ann["image_id"], [])
        if caps and rng.random() >= self.caption_dropout:
            text = caps[int(rng.integers(len(caps)))]

        sample = {
            "image": image,
            "semseg": semseg.astype(np.int32),
            "mask": (semseg != self.ignore_label).astype(np.uint8),
            "image_semseg": bits,
            "inpainting_mask": self.maskgen(
                t=self.inpainting_strength, rng=rng).astype(bool),
            "text": text,
            "meta": {
                "im_size": (h, w),
                "image_file": img_path,
                "image_id": ann["image_id"],
                "gt_cat": id_map.astype(np.int32),
            },
        }
        if self.flip and rng.random() < 0.5:
            from .transforms import hflip_sample
            sample = hflip_sample(sample)
        return sample

    def __str__(self):
        return f"CocoPanoptic(split={self.split}, n={len(self)})"
