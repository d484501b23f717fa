"""Panoptic post-processing (counterpart of
``ldmseg_tpu/ops/panoptic.py:panoptic_post_process``).

1. ``pred = argmax_c logits``; pixels whose max softmax probability is below
   ``mask_th`` get the ignore label;
2. a segment (argmax label) with fewer than ``count_th`` pixels is removed;
3. a segment whose argmax area over its thresholded-sigmoid area
   (``sigmoid(logits[c]) >= mask_th``) is below ``overlap_th`` is removed.

Each pixel carries one argmax label, so the per-label loop is per-class
histograms: one pass, fixed shapes.
"""

from __future__ import annotations

from typing import Optional

import torch


def panoptic_post_process(logits: torch.Tensor, mask_th: float = 0.5,
                          count_th: int = 512, overlap_th: float = 0.5,
                          ignore_label: int = 0,
                          valid_mask: Optional[torch.Tensor] = None):
    """``logits`` ``[..., H, W, C]`` -> (cleaned ``[..., H, W]`` int32 with
    removed segments -1, keep ``[..., C]`` bool). ``valid_mask``
    ``[..., H, W]``: False pixels are left out of the counts and set to
    -1."""
    c = logits.shape[-1]
    pred = logits.argmax(dim=-1)
    maxprob = torch.softmax(logits, dim=-1).amax(dim=-1)
    pred = torch.where(maxprob < mask_th,
                       torch.full_like(pred, ignore_label), pred)
    valid = (torch.ones_like(pred, dtype=torch.bool) if valid_mask is None
             else valid_mask.to(device=logits.device, dtype=torch.bool))

    class_ids = torch.arange(c, device=logits.device)
    onehot = (pred[..., None] == class_ids) & valid[..., None]
    area_argmax = onehot.sum(dim=(-3, -2)).float()            # [..., C]
    sig_mask = (torch.sigmoid(logits) >= mask_th) & valid[..., None]
    area_sig = sig_mask.sum(dim=(-3, -2)).float()
    keep = ((area_argmax >= count_th) & (class_ids != ignore_label)
            & (area_argmax / area_sig.clamp(min=1.0) >= overlap_th))

    keep_pixel = keep.gather(-1, pred.flatten(-2)).reshape(pred.shape)
    cleaned = torch.where(keep_pixel & valid, pred,
                          torch.full_like(pred, -1)).to(torch.int32)
    return cleaned, keep
