"""BEiT-style block / local inpainting mask generator (own copy of
``ldmseg_tpu/data/mask_generator.py``).

Reference: ldmseg/data/util/mask_generator.py:6-111. Redesigned around an
explicit ``numpy.random.Generator`` (no global RNG state) and a vectorized
block fill.
"""

from __future__ import annotations

import math

import numpy as np


class MaskingGenerator:
    def __init__(
        self,
        input_size=(32, 32),
        num_masking_patches: int = 512,
        min_num_patches: int = 4,
        max_num_patches: int = 128,
        min_aspect: float = 0.3,
        max_aspect: float | None = None,
        mode: str = "random_global",
    ):
        if not isinstance(input_size, (tuple, list)):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))
        self.mode = mode

    def _block(self, rng: np.random.Generator, mask: np.ndarray,
               max_mask_patches: int) -> int:
        """Place one random block (reference _mask :43-65)."""
        lo = min(self.min_num_patches, max_mask_patches)
        for _ in range(10):
            target_area = rng.uniform(lo, max_mask_patches)
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = rng.integers(0, self.height - h + 1)
                left = rng.integers(0, self.width - w + 1)
                region = mask[top:top + h, left:left + w]
                delta = int(h * w - region.sum())
                if 0 < delta <= max_mask_patches:
                    region[:] = 1
                    return delta
        return 0

    def _global_mask(self, rng, mask):
        count = 0
        while count < self.num_masking_patches:
            budget = min(self.num_masking_patches - count,
                         self.max_num_patches)
            delta = self._block(rng, mask, budget)
            if delta == 0:
                break
            count += delta
        return mask

    def _local_mask(self, rng, mask, strength):
        mask[rng.random((self.height, self.width)) < strength] = 1
        return mask

    def __call__(self, t: float = 0.5,
                 rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng if rng is not None else np.random.default_rng()
        mask = np.zeros((self.height, self.width), dtype=np.int64)
        if self.mode == "random_local":
            return self._local_mask(rng, mask, t)
        if self.mode == "random_global":
            return self._global_mask(rng, mask)
        if self.mode == "random_global_plus_local":
            g = self._global_mask(rng, mask.copy())
            return ((g + self._local_mask(rng, mask, t)) > 0).astype(np.int64)
        raise NotImplementedError(self.mode)
