"""Host-side numpy and PIL transforms (own copy of
``ldmseg_tpu/data/transforms.py`` and of ``encode_bits_np`` in
``ldmseg_tpu/ops/bits.py``): the square crop box, the per-modality resizes
(RGB and depth bilinear, labels nearest), ImageNet normalisation, the
horizontal flip of a sample and the analog-bits encoding of an id map:
:func:`encode_bits` is the numpy path, :func:`encode_bits_host` (the
readers') the native C++ codec of ``data/native`` (JAX
``transforms.py:103-107``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def square_crop_box(size_wh: tuple, mode: str,
                    rng: np.random.Generator) -> tuple | None:
    """Square crop box matching the reference CropResize semantics
    (pil_transforms.py:104-126): crop to the min-dimension square, with a
    centred ('centre') or random ('random') margin along the long axis.
    NOTE: the reference's CropResize.__init__ overwrites ``crop_mode`` with
    ``None`` (pil_transforms.py:102), so these modes are unreachable
    upstream; here they work. ``mode=None`` -> no crop (the reference's
    effective behavior)."""
    if mode is None:
        return None
    assert mode in ("centre", "random")
    img_w, img_h = size_wh
    min_size = min(img_h, img_w)
    if min_size == img_h:
        margin = (img_w - min_size) // 2
        if mode == "random" and margin > 0:
            margin = int(rng.integers(0, margin + 1))
        return (margin, 0, margin + min_size, min_size)
    margin = (img_h - min_size) // 2
    if mode == "random" and margin > 0:
        margin = int(rng.integers(0, margin + 1))
    return (0, margin, min_size, margin + min_size)


def resize_rgb(img: Image.Image, size_hw: tuple, box=None) -> np.ndarray:
    """(Crop +) bilinear resize + [0,1] float, channels-last ``[H,W,3]``."""
    h, w = size_hw
    if box is not None:
        img = img.crop(box)
    img = img.convert("RGB").resize((w, h), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def normalize_imagenet(x: np.ndarray, mean=None, std=None) -> np.ndarray:
    """Channel normalisation, by default with the ImageNet statistics."""
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    return (x - mean) / std


def denormalize_imagenet(x: np.ndarray, mean=None, std=None) -> np.ndarray:
    mean = IMAGENET_MEAN if mean is None else np.asarray(mean, np.float32)
    std = IMAGENET_STD if std is None else np.asarray(std, np.float32)
    return x * std + mean


def resize_label(img: Image.Image, size_hw: tuple,
                 dtype=np.int32, box=None) -> np.ndarray:
    """(Crop +) nearest resize for id maps, ``[H, W]``."""
    h, w = size_hw
    if box is not None:
        img = img.crop(box)
    img = img.resize((w, h), Image.NEAREST)
    return np.asarray(img).astype(dtype)


def resize_depth(img: Image.Image, size_hw: tuple, box=None) -> np.ndarray:
    """(Crop +) bilinear resize for depth maps (kitti.py:370) ``[H, W]``."""
    h, w = size_hw
    if box is not None:
        img = img.crop(box)
    img = img.resize((w, h), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32)


def hflip_sample(sample: dict) -> dict:
    """Horizontal flip across all spatial keys (pil_transforms.py:43-96);
    meta gt arrays are flipped too so they stay aligned to the sample."""
    out = dict(sample)
    for k in ("image", "image_semseg", "color_target",
              "semseg", "instance", "depth", "mask"):
        if k in out:
            out[k] = out[k][:, ::-1].copy()
    if "meta" in out:
        meta = dict(out["meta"])
        for k in ("gt_cat", "gt_ins", "gt_sem", "gt_inst", "gt_mask"):
            if k in meta:
                meta[k] = meta[k][:, ::-1].copy()
        out["meta"] = meta
    return out


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


def encode_bits_host(x, num_bits, ignore_label=0, fill_value=0.5):
    """The readers' analog-bits encode: the native C++ pass
    (``data/native:encode_bits_native``, built with g++ at first use) on
    ``x`` as int32; the same values as :func:`encode_bits`."""
    from .native import encode_bits_native
    return encode_bits_native(x, num_bits, ignore_label, fill_value)
