"""Colour maps, the port's own copy (numpy) of ``ldmseg_tpu/ops/color.py``.

Color maps and panoptic colorization (host-side visualization helpers).

Parity: ldmseg/utils/utils.py:240-258 (bit-pattern ``color_map``) and
ldmseg/data/kitti.py:22-50 (seeded random colormap / colorize_panoptic).
"""

from __future__ import annotations

import numpy as np


def color_map(N: int = 256, normalized: bool = False) -> np.ndarray:
    """PASCAL-VOC style bit-pattern colormap.

    Parity: ldmseg/utils/utils.py:240-258.
    """
    def bitget(byteval, idx):
        return (byteval & (1 << idx)) != 0

    dtype = np.float32 if normalized else np.uint8
    cmap = np.zeros((N, 3), dtype=dtype)
    for i in range(N):
        r = g = b = 0
        c = i
        for j in range(8):
            r = r | (bitget(c, 0) << (7 - j))
            g = g | (bitget(c, 1) << (7 - j))
            b = b | (bitget(c, 2) << (7 - j))
            c = c >> 3
        cmap[i] = np.array([r, g, b])
    return cmap / 255 if normalized else cmap


def random_color_map(num_colors: int = 20, seed: int = 20) -> np.ndarray:
    """Seeded random colormap. Parity: kitti.py:22-27 (seed 20)."""
    rng = np.random.RandomState(seed)
    # dtype=uint8 (not astype) — np.random draws uint8 directly from a
    # different point of the MT19937 stream, and the reference palette
    # depends on that exact consumption order
    return rng.randint(0, 256, (num_colors, 3), dtype=np.uint8)


def colorize_panoptic_np(panoptic_map: np.ndarray,
                         colormap: np.ndarray) -> np.ndarray:
    """Colorize a panoptic id map; id 0 maps to black.

    Parity: kitti.py:29-50 — vectorized (the reference loops over unique
    ids; a modulo lookup is equivalent since color[uid % len]).
    """
    idx = (panoptic_map % len(colormap)).astype(np.int64)
    out = colormap[idx]
    out[panoptic_map == 0] = 0
    return out
