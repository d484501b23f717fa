"""Visualization panels on the host (counterpart of
``ldmseg_tpu/utils/visualization.py``; reference ``save_train_images`` and
``log_images_*``, trainers_ae.py:884, trainers_ldm_cond.py:1378-1660):
stacked RGB / ground truth / prediction panels, panoptic maps coloured by
the bit-pattern colour map, written with PIL.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..data.transforms import denormalize_imagenet
from ..ops.bits import decode_bits_np
from ..ops.color import color_map, colorize_panoptic_np


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def panoptic_to_rgb(seg: np.ndarray, cmap: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    cmap = cmap if cmap is not None else color_map()
    return colorize_panoptic_np(to_numpy(seg).astype(np.int64), cmap)


def rgb_to_uint8(rgb) -> np.ndarray:
    """ImageNet-normalised ``[H, W, 3]`` -> uint8."""
    return (np.clip(denormalize_imagenet(to_numpy(rgb)), 0, 1)
            * 255).astype(np.uint8)


def _save(path: str, rows: list) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(np.concatenate(rows, axis=0)).save(path)
    return path


def save_train_panel(path: str, rgb, gt_seg, pred_seg, extra=None) -> str:
    """rgb / gt / pred (/ extra) stacked, as the reference's
    ``rgb_gt_pred_ae_*.jpg``."""
    rows = [rgb_to_uint8(rgb), panoptic_to_rgb(gt_seg),
            panoptic_to_rgb(pred_seg)]
    if extra is not None:
        rows.append(to_numpy(extra).astype(np.uint8))
    return _save(path, rows)


def save_val_overview(path: str, rgbs, gt_segs, pred_segs,
                      inpainting=None) -> str:
    """Columns: the batch's images with a 2% gap; rows: RGB, GT (unless
    None), prediction (+ the inpainting mask)."""
    pred_segs = to_numpy(pred_segs)
    n, h, w = pred_segs.shape[:3]
    off = max(1, int(0.02 * h))

    def row(panels):
        canvas = np.zeros((h, n * (w + off), 3), np.uint8)
        for i, p in enumerate(panels):
            canvas[:, i * (w + off):i * (w + off) + w] = p
        return canvas

    rows = [row([rgb_to_uint8(r) for r in to_numpy(rgbs)[:n]])]
    if gt_segs is not None:
        rows.append(row([panoptic_to_rgb(g) for g in to_numpy(gt_segs)[:n]]))
    rows.append(row([panoptic_to_rgb(p) for p in pred_segs[:n]]))
    if inpainting is not None:
        masks = []
        for m in to_numpy(inpainting)[:n]:
            m8 = (np.asarray(m, np.float32) * 255).astype(np.uint8)
            m8 = np.asarray(Image.fromarray(m8).resize((w, h),
                                                       Image.NEAREST))
            masks.append(np.repeat(m8[..., None], 3, axis=-1))
        rows.append(row(masks))
    return _save(path, rows)


def noise_schedule_panel(path: str, sched, bits_image,
                         timesteps=(0, 100, 250, 500, 750, 999),
                         seed: int = 0, noise=None) -> str:
    """One analog-bits map ``[H, W, n]`` noised at each timestep with one
    standard normal draw (``noise``, the map's shape, or a CPU generator
    seeded ``seed``; JAX reuses one key the same way), decoded and
    coloured, stacked."""
    from ..diffusion.ddim import add_noise
    dev = sched.alphas_cumprod.device
    x = torch.from_numpy(2.0 * np.asarray(bits_image, np.float32)[None]
                         - 1.0)
    if noise is None:
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(
            seed))
    x = x.to(dev)
    noise = torch.as_tensor(noise, dtype=torch.float32).reshape(x.shape).to(
        dev)
    rows = []
    for t in timesteps:
        noisy = add_noise(sched, x, noise, torch.tensor([t], device=dev))
        rows.append(panoptic_to_rgb(decode_bits_np(noisy[0].cpu().numpy())))
    return _save(path, rows)
