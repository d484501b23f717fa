"""Synthetic DVPS dataset — random panoptic scenes for tests and benches
(own copy of ``ldmseg_tpu/data/synthetic.py``; the same samples for the same
seed).

Generates the same sample schema as :class:`KittiDVPS` without any files:
random blobs of semantic classes with per-blob instance ids, a smooth
depth ramp, and a plausible RGB rendering. Deterministic per (seed, idx).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .mask_generator import MaskingGenerator
from .transforms import encode_bits, normalize_imagenet


class SyntheticDVPS:
    def __init__(
        self,
        length: int = 64,
        size: Tuple[int, int] = (192, 640),
        num_classes: int = 20,
        num_bits: int = 5,
        ignore_label: int = 0,
        fill_value: float = 0.5,
        num_blobs: int = 12,
        frames_per_scene: int = 8,
        seed: int = 0,
    ):
        self.length = length
        self.size = size
        self.num_classes = num_classes
        self.num_bits = num_bits
        self.ignore_label = ignore_label
        self.fill_value = fill_value
        self.num_blobs = num_blobs
        self.frames_per_scene = frames_per_scene
        self.seed = seed
        self.maskgen = MaskingGenerator(input_size=(64, 64),
                                        mode="random_local")
        # the blob render + bit encode are deterministic per
        # (scene, frame) — only the RGB photo noise and inpainting mask
        # vary per epoch. Caching the scene render makes repeated epochs
        # (bench/dress-rehearsal loops, long tests) pay ~10 ms/sample
        # instead of ~300 ms; tiny vs host RAM (~8 MB per 256x512 frame)
        self._scene_cache: dict = {}

    def __len__(self):
        return self.length

    def _render(self, scene: int, frame: int):
        h, w = self.size
        key = (scene, frame)
        hit = self._scene_cache.get(key)
        if hit is not None:
            return hit
        # blobs belong to the scene; the frame shifts them slightly so
        # consecutive frames look like video
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, scene]))

        semseg = np.zeros((h, w), dtype=np.int32)
        instance = np.zeros((h, w), dtype=np.int32)
        yy, xx = np.mgrid[0:h, 0:w]
        for b in range(self.num_blobs):
            cy = rng.uniform(0, h) + frame * rng.uniform(-2, 2)
            cx = rng.uniform(0, w) + frame * rng.uniform(-4, 4)
            ry = rng.uniform(h * 0.05, h * 0.3)
            rx = rng.uniform(w * 0.05, w * 0.3)
            cls = int(rng.integers(1, self.num_classes))
            blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            semseg[blob] = cls
            instance[blob] = b + 1

        depth = (1.0 + yy / h * 50.0 + semseg * 0.3).astype(np.float32)
        rgb = np.stack([
            (semseg * 37 % 255) / 255.0,
            (instance * 91 % 255) / 255.0,
            yy / h,
        ], axis=-1).astype(np.float32)
        mask = (semseg != self.ignore_label).astype(np.uint8)
        seg_bits = encode_bits(semseg, self.num_bits,
                               ignore_label=self.ignore_label,
                               fill_value=self.fill_value)
        ins_bits = encode_bits(instance, self.num_bits, ignore_label=None)
        entry = (semseg, instance, depth, rgb, mask,
                 np.concatenate([seg_bits, ins_bits], axis=-1))
        self._scene_cache[key] = entry
        return entry

    def __getitem__(self, idx: int, epoch: int = 0) -> dict:
        h, w = self.size
        scene = idx // self.frames_per_scene
        frame = idx % self.frames_per_scene
        semseg, instance, depth, rgb_base, mask, image_semseg = \
            self._render(scene, frame)
        # per-epoch variation: photographic noise + inpainting mask
        # (blob geometry and bit planes are scene-deterministic, above)
        frng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx, 7]))
        rgb = np.clip(rgb_base + frng.normal(0, 0.02, rgb_base.shape),
                      0, 1)
        return {
            "image": normalize_imagenet(rgb.astype(np.float32)),
            "semseg": semseg,
            "instance": instance,
            "depth": depth,
            "mask": mask,
            "image_semseg": image_semseg,
            "inpainting_mask": self.maskgen(t=0.0, rng=frng).astype(bool),
            "text": "",
            "meta": {
                "im_size": (h, w),
                "image_file": f"synthetic_{idx}.png",
                "image_id": scene * 10000 + frame,
                "scene": scene,
                "frame": frame,
                "gt_cat": semseg.copy(),
                "gt_ins": instance.copy(),
            },
        }
