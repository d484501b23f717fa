"""SemKITTI-DVPS reader, the port's own copy (numpy and PIL) of
``ldmseg_tpu/data/kitti.py:KittiDVPS``; it reuses the port's
``mask_generator.py`` and ``ops/color.py``.

SemKITTI-DVPS dataset (video_sequence layout).

Reference: ldmseg/data/kitti.py:62-539 and dataset/semKITTI_dataset.py.
File layout per split directory:
  ``{scene}_{frame}_leftImg8bit.png``, ``{scene}_{frame}_gtFine_class.png``,
  ``{scene}_{frame}_gtFine_instance.png``,
  ``{scene}_{frame}_depth_{focal}.png``  (kitti.py:161-194).

Per sample (all channels-last numpy):
  * image        [H, W, 3] float32, ImageNet-normalized (kitti.py:120-125)
  * semseg       [H, W] int32, remapped class ids, ignore=0
  * instance     [H, W] int32, compacted to 0..K (kitti.py:419-424)
  * depth        [H, W] float32 (bilinear; kitti.py:370)
  * mask         [H, W] uint8: 0 where raw class in {0, 255}
    (kitti.py:375-378)
  * image_semseg [H, W, 10] float32: 5-bit semantic + 5-bit instance analog
    bits (kitti.py:431-437)
  * inpainting_mask [h, w] bool (kitti.py:413-414)
  * meta: image_id = scene*10000 + frame, gt_cat / gt_ins at label res,
    focal length parsed from the depth filename
    (semKITTI_dataset.py:117)

Deviations (documented fixes, SURVEY §7):
  * per-scene deterministic id remap option replaces the reference's
    per-sample order-of-appearance remap (kitti.py:350-358) so ids are
    stable across a video clip;
  * the precomputed ``pop_gt`` colorized target (kitti.py:381-387, an
    external-notebook artifact) is reproduced on the fly via
    ops.color.colorize_panoptic_np when ``with_color_target`` is set.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from .mask_generator import MaskingGenerator
from .remap import remap_contiguous, remap_per_scene
from .transforms import (
    resize_rgb, normalize_imagenet, resize_label, resize_depth)
from .transforms import encode_bits_host

_DEPTH_RE = re.compile(r"depth_([0-9]+(?:\.[0-9]+)?)")


class KittiDVPS:
    """SemKITTI-DVPS loader. ``num_bits=5`` per map -> 10 bit channels."""

    NUM_THING_PLUS_STUFF = 19  # cityscapes-style 19 classes (kitti.py:63-83)

    def __init__(
        self,
        prefix: str,
        split: str = "train",
        size: Tuple[int, int] = (192, 640),
        num_classes: int = 30,
        num_bits: int = 5,
        num_bits_instance: int | None = None,
        ignore_label: int = 0,
        fill_value: float = 0.5,
        inpainting_strength: float = 0.0,
        inpaint_mask_size: Tuple[int, int] = (64, 64),
        encoding_mode: str = "bits",
        remap_mode: str = "per_sample",  # 'per_sample' | 'per_scene'
        with_color_target: bool = False,
        flip: bool = False,
        crop_mode: Optional[str] = None,  # None | 'centre' | 'random'
        keep_fullres_gt: bool = False,
        seed: int = 0,
        normalize_params: Optional[dict] = None,
        image_only: bool = False,
    ):
        # image_only: index frames that have ONLY the RGB PNG (no GT /
        # depth required) — deployment-mode inference on unlabeled video.
        # Samples then carry image + mask(=1) + depth(0 if absent) + meta;
        # sample_panoptic needs nothing else (the reference sampler also
        # consumes only RGB latents, trainers_ldm_cond.py:1234-1242).
        self.image_only = image_only
        # keep_fullres_gt: carry original-resolution remapped GT in meta
        # so eval can restore each prediction to its own im_size
        # (reference compute_pq, trainers_ldm_cond.py:1264-1284)
        self.keep_fullres_gt = keep_fullres_gt
        assert split in ("train", "val", "test")
        assert encoding_mode in ("bits", "none")
        # train-time augmentation (reference get_train_transforms:
        # RandomHorizontalFlip p=0.5 + CropResize, dataset_base.py:17-33)
        self.flip = flip and split == "train"
        self.crop_mode = crop_mode if split == "train" else None
        self.root = prefix
        self.split = split
        self.size = size
        self.num_classes = num_classes
        self.num_bits = num_bits
        # the video variant uses 5-bit semantics + 6-bit instances -> 11
        # channels (dataset/semKITTI_dataset.py:200-203)
        self.num_bits_instance = (num_bits_instance if num_bits_instance
                                  is not None else num_bits)
        self.ignore_label = ignore_label
        self.fill_value = fill_value
        self.encoding_mode = encoding_mode
        self.remap_mode = remap_mode
        self.with_color_target = with_color_target
        self.seed = seed
        self.inpainting_strength = inpainting_strength
        # RGB normalize stats (transformation_kwargs.normalize_params;
        # reference dataset_base.py:19-42 / kitti.py:123-125)
        np_ = normalize_params or {}
        self.norm_mean = np_.get("mean")
        self.norm_std = np_.get("std")
        self.maskgen = MaskingGenerator(input_size=inpaint_mask_size,
                                        mode="random_local")
        from .base import get_metadata
        self.meta_data = get_metadata(num_classes, root=prefix)
        self.samples = self._index(os.path.join(prefix, split),
                                   image_only=image_only)
        self._scene_tables: dict = {}

    @staticmethod
    def _index(image_dir: str, image_only: bool = False) -> list:
        """Group files into complete (rgb, class, instance, depth) frames
        (kitti.py:155-194); ``image_only`` keeps RGB-only frames."""
        table: dict = {}
        if not os.path.isdir(image_dir):
            return []
        for file in sorted(os.listdir(image_dir)):
            base, ext = os.path.splitext(file)
            if ext.lower() != ".png":
                continue
            parts = base.split("_")
            if len(parts) >= 4 and parts[2] == "gtFine":
                scene, frame, typ = parts[0], parts[1], parts[3]
            elif len(parts) == 3 and parts[2] == "leftImg8bit":
                scene, frame, typ = parts[0], parts[1], "leftImg8bit"
            elif len(parts) >= 4 and parts[2] == "depth":
                scene, frame, typ = parts[0], parts[1], "depth"
            else:
                continue
            table.setdefault(scene, {}).setdefault(frame, {})[typ] = \
                os.path.join(image_dir, file)
        samples = []
        need = ("leftImg8bit",) if image_only else (
            "leftImg8bit", "class", "instance", "depth")
        for scene in table.values():
            for frame in scene.values():
                if all(k in frame for k in need):
                    samples.append(frame)
        return samples

    def get_class_names(self):
        from .base import CITYSCAPES_CATEGORY_NAMES
        return CITYSCAPES_CATEGORY_NAMES

    def __len__(self):
        return len(self.samples)

    def _rng(self, idx: int, epoch: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx]))

    def scene_frame(self, idx: int) -> tuple[int, int]:
        base = os.path.basename(self.samples[idx]["leftImg8bit"])
        parts = base.split("_")
        return int(parts[0]), int(parts[1])

    def __getitem__(self, idx: int, epoch: int = 0) -> dict:
        paths = self.samples[idx]
        rng = self._rng(idx, epoch)
        h, w = self.size

        rgb_img = Image.open(paths["leftImg8bit"])
        from .transforms import square_crop_box
        box = square_crop_box(rgb_img.size, self.crop_mode, rng)

        image = resize_rgb(rgb_img, self.size, box=box)
        image = normalize_imagenet(image, self.norm_mean, self.norm_std)

        if "class" not in paths:
            # image-only frame (deployment inference): no GT to load.
            # depth/focal ride along when the file exists (pose-warped
            # clip sampling can still run on unlabeled video).
            scene, frame = self.scene_frame(idx)
            depth = (resize_depth(Image.open(paths["depth"]), self.size,
                                  box=box) if "depth" in paths
                     else np.zeros((h, w), np.float32))
            focal = None
            if "depth" in paths:
                m = _DEPTH_RE.search(os.path.basename(paths["depth"]))
                focal = float(m.group(1)) if m else None
            return {
                "image": image,
                "mask": np.ones((h, w), dtype=np.uint8),
                "depth": depth,
                "text": "",
                "meta": {
                    "im_size": (rgb_img.size[1], rgb_img.size[0]),
                    "image_file": paths["leftImg8bit"],
                    "image_id": scene * 10000 + frame,
                    "scene": scene,
                    "frame": frame,
                    "focal": focal,
                },
            }

        sem_raw = resize_label(Image.open(paths["class"]), self.size,
                               box=box)
        inst_raw = resize_label(Image.open(paths["instance"]), self.size,
                                box=box)
        depth = resize_depth(Image.open(paths["depth"]), self.size, box=box)

        scene, frame = self.scene_frame(idx)

        # validity: raw class 0/255 are unlabeled (kitti.py:375-378)
        mask = np.ones((h, w), dtype=np.uint8)
        mask[(sem_raw == 0) | (sem_raw == 255)] = 0

        # id remap into [0, num_classes)
        def _remap_sem(arr):
            if self.remap_mode == "per_scene":
                table = self._scene_tables.setdefault(("sem", scene), {})
                return remap_per_scene(arr, table, self.num_classes,
                                       self.ignore_label)
            return remap_contiguous(arr, self.ignore_label)[0]

        # instance compaction to 0..K (kitti.py:419-424)
        def _remap_ins(arr):
            nbi = self.num_bits_instance
            if self.remap_mode == "per_scene":
                table = self._scene_tables.setdefault(("ins", scene), {})
                out = remap_per_scene(arr, table, 2**nbi, 0)
            else:
                out = remap_contiguous(arr, 0)[0]
            return np.minimum(out, 2**nbi - 2)

        sem_full = inst_full = mask_full = None
        if self.keep_fullres_gt:
            # remap at ORIGINAL resolution, then derive the model-res maps
            # by nearest downsample so pred/GT share one id table
            sem_pil = Image.open(paths["class"])
            inst_pil = Image.open(paths["instance"])
            if box is not None:
                sem_pil, inst_pil = sem_pil.crop(box), inst_pil.crop(box)
            sem_full_raw = np.asarray(sem_pil).astype(np.int32)
            inst_full_raw = np.asarray(inst_pil).astype(np.int32)
            sem_full = _remap_sem(sem_full_raw).astype(np.int32)
            inst_full = _remap_ins(inst_full_raw).astype(np.int32)
            mask_full = np.ones(sem_full.shape, dtype=np.uint8)
            mask_full[(sem_full_raw == 0) | (sem_full_raw == 255)] = 0
            semseg = resize_label(
                Image.fromarray(sem_full, mode="I"), self.size)
            instance = resize_label(
                Image.fromarray(inst_full, mode="I"), self.size)
        else:
            semseg = _remap_sem(sem_raw)
            instance = _remap_ins(inst_raw)
        assert semseg.max() < self.num_classes

        sample = {
            "image": image,
            "semseg": semseg.astype(np.int32),
            "instance": instance.astype(np.int32),
            "depth": depth,
            "mask": mask,
            "text": "",
        }

        if self.encoding_mode == "bits":
            seg_bits = encode_bits_host(semseg, self.num_bits,
                                         ignore_label=self.ignore_label,
                                         fill_value=self.fill_value)
            ins_bits = encode_bits_host(instance,
                                         self.num_bits_instance,
                                         ignore_label=None)
            sample["image_semseg"] = np.concatenate([seg_bits, ins_bits],
                                                    axis=-1)
        else:
            sample["image_semseg"] = np.repeat(
                semseg[..., None].astype(np.float32) / self.num_classes, 3,
                axis=-1)

        if self.with_color_target:
            from ..ops.color import random_color_map, colorize_panoptic_np
            cmap = random_color_map(20)
            pop = semseg.astype(np.int64) * 100 + instance.astype(np.int64)
            sample["color_target"] = colorize_panoptic_np(pop, cmap)

        sample["inpainting_mask"] = self.maskgen(
            t=self.inpainting_strength, rng=rng).astype(bool)

        focal = None
        m = _DEPTH_RE.search(os.path.basename(paths["depth"]))
        if m:
            focal = float(m.group(1))
        sample["meta"] = {
            "im_size": (h, w),
            "image_file": paths["leftImg8bit"],
            "image_id": scene * 10000 + frame,
            "scene": scene,
            "frame": frame,
            "focal": focal,
            "gt_cat": sem_raw.astype(np.int32),
            "gt_ins": inst_raw.astype(np.int32),
        }
        if self.keep_fullres_gt:
            sample["meta"]["gt_sem"] = sem_full
            sample["meta"]["gt_inst"] = inst_full
            sample["meta"]["gt_mask"] = mask_full
            sample["meta"]["im_size"] = sem_full.shape
        if self.flip and rng.random() < 0.5:
            from .transforms import hflip_sample
            sample = hflip_sample(sample)
        return sample

    def __str__(self):
        return f"KittiDVPS(split={self.split}, n={len(self)})"
