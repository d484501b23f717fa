"""Label remapping, the port's own copy (numpy) of
``ldmseg_tpu/data/remap.py``.

Label remapping strategies.

The reference remaps raw panoptic/semantic ids into [0, num_classes):
  * contiguous per-sample remap (kitti.py:350-358) — nondeterministic
    across epochs only in ordering, deterministic per image;
  * random remap with small-region suppression
    (cityscapes.py:293-366 ``_remap_labels_fn(min_pixels=10)``;
    kitti.py:235-266 variant without the size filter).

TPU build adds a *deterministic per-scene* mode so that the same object
keeps the same id across frames of a video clip — required for temporally
consistent analog-bits targets (the reference approximates this with the
precomputed ``pop_gt`` colorization, Untitled.ipynb cell 2).
"""

from __future__ import annotations

import numpy as np


def remap_contiguous(labels: np.ndarray,
                     ignore_label: int = 0) -> tuple[np.ndarray, dict]:
    """Order-of-appearance contiguous remap (kitti.py:350-358).

    Note: like the reference, ``ignore_label`` pixels are remapped too if
    present — index 0 goes to the smallest id, which for KITTI (ignore 0)
    keeps ignore at 0.
    """
    unique = np.unique(labels)
    lut = np.zeros(labels.max() + 1, dtype=labels.dtype) if labels.size else \
        np.zeros(1, dtype=labels.dtype)
    for new, old in enumerate(unique):
        lut[old] = new
    return lut[labels], {int(o): int(n) for n, o in enumerate(unique)}


def remap_random(
    labels: np.ndarray,
    num_classes: int,
    ignore_label: int,
    rng: np.random.Generator,
    min_pixels: int = 0,
) -> tuple[np.ndarray, dict]:
    """Random id assignment with small/overflow regions sent to the top id
    (cityscapes.py:293-366). ``min_pixels=0`` reproduces the plain random
    remap of kitti.py:235-266."""
    max_target = num_classes - 1
    out = np.full(labels.shape, ignore_label, dtype=labels.dtype)
    unique, counts = np.unique(labels, return_counts=True)
    keep = unique != ignore_label
    unique, counts = unique[keep], counts[keep]

    mapping: dict = {}
    small = unique[counts < min_pixels] if min_pixels > 0 else \
        np.empty(0, dtype=unique.dtype)
    for val in small:
        mapping[int(val)] = max_target
        out[labels == val] = max_target

    normal = [v for v, c in zip(unique, counts) if c >= min_pixels]
    available = np.arange(1, max_target)
    if len(normal) > len(available):
        order = sorted(normal, key=lambda v: -int(counts[unique == v][0]))
        for val in order[len(available):]:
            mapping[int(val)] = max_target
            out[labels == val] = max_target
        normal = order[: len(available)]
    if normal:
        targets = rng.choice(available, size=len(normal), replace=False)
        for val, tgt in zip(normal, targets):
            mapping[int(val)] = int(tgt)
            out[labels == val] = tgt
    return out, mapping


def remap_per_scene(
    labels: np.ndarray,
    scene_table: dict,
    num_classes: int,
    ignore_label: int = 0,
) -> np.ndarray:
    """Deterministic per-scene remap: ids are assigned on first appearance
    within a scene and reused across its frames. ``scene_table`` is a
    mutable {raw_id -> assigned_id} dict owned by the dataset per scene."""
    out = np.full(labels.shape, ignore_label, dtype=labels.dtype)
    for val in np.unique(labels):
        v = int(val)
        if v == ignore_label:
            continue
        if v not in scene_table:
            nxt = len(scene_table) % (num_classes - 1) + 1
            scene_table[v] = nxt
        out[labels == val] = scene_table[v]
    return out
