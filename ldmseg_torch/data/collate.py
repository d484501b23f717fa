"""Batch collation to fixed-shape numpy arrays (own copy of
``ldmseg_tpu/data/collate.py``): array keys are stacked, ``meta`` and
``text`` stay lists."""

from __future__ import annotations

import numpy as np

STACK_KEYS = ("image", "semseg", "instance", "depth", "mask",
              "image_semseg", "inpainting_mask", "color_target")
LIST_KEYS = ("meta", "text")


def collate(samples: list) -> dict:
    out: dict = {}
    for k in STACK_KEYS:
        if k in samples[0]:
            out[k] = np.stack([s[k] for s in samples])
    for k in LIST_KEYS:
        if k in samples[0]:
            out[k] = [s[k] for s in samples]
    return out
