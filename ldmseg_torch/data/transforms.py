"""Host-side numpy transforms (own copy of the parts of
``ldmseg_tpu/data/transforms.py`` and ``ldmseg_tpu/ops/bits.py`` that the
training path needs): ImageNet normalisation and the analog-bits encoding of
an id map. The bits encoding is the JAX package's numpy path
(``encode_bits_np``); its native C++ codec gives the same values and is not
copied."""

from __future__ import annotations

from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_imagenet(x: np.ndarray, mean=None, std=None) -> np.ndarray:
    """Channel normalisation, by default with the ImageNet statistics."""
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    return (x - mean) / std


def denormalize_imagenet(x: np.ndarray, mean=None, std=None) -> np.ndarray:
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    return x * std + mean


def encode_bits(x: np.ndarray, num_bits: int,
                ignore_label: Optional[int] = 0,
                fill_value: float = 0.5) -> np.ndarray:
    """Integer map ``[..., H, W]`` -> bit planes ``[..., H, W, num_bits]``
    float32 in {0, 1}; pixels equal to ``ignore_label`` get ``fill_value``
    in every plane (``None`` disables that)."""
    x = np.asarray(x)
    shifts = np.arange(num_bits, dtype=x.dtype)
    bits = ((x[..., None] >> shifts) & 1).astype(np.float32)
    if ignore_label is not None:
        bits[x == ignore_label] = np.float32(fill_value)
    return bits
