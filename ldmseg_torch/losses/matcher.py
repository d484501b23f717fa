"""Mask2Former-style Hungarian matcher, the optional path the reference
leaves off (counterpart of ``ldmseg_tpu/losses/matcher.py``; reference
losses.py:44-101).

Point-sampled BCE + Dice costs between the prediction channels and the
selected target masks on one shared point set, on the logits' device; the
assignment on the host with ``scipy.optimize.linear_sum_assignment``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.grid_sample import point_sample
from .point_losses import select_topk_masks


def hungarian_host(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Per image, the assignment over the valid target columns; the target
    column of each query, -1 where none."""
    from scipy.optimize import linear_sum_assignment
    b, nq, _ = cost.shape
    out = np.full((b, nq), -1, dtype=np.int32)
    for i in range(b):
        nv = int(valid[i].sum())
        if nv == 0:
            continue
        rows, cols = linear_sum_assignment(cost[i, :, :nv])
        out[i, rows] = cols
    return out


def sigmoid_ce_cost(point_logits: torch.Tensor,
                    point_labels: torch.Tensor) -> torch.Tensor:
    """Pairwise BCE (losses.py:249-277): ``[Q, P] x [T, P] -> [Q, T]``."""
    p = point_logits
    soft = torch.log1p(torch.exp(-p.abs()))
    pos = p.clamp_min(0) - p + soft
    neg = p.clamp_min(0) + soft
    return (pos @ point_labels.T + neg @ (1.0 - point_labels).T) / p.shape[-1]


def dice_cost(point_logits: torch.Tensor,
              point_labels: torch.Tensor) -> torch.Tensor:
    """Pairwise Dice (losses.py:209-228)."""
    p = torch.sigmoid(point_logits)
    numerator = 2.0 * (p @ point_labels.T)
    denominator = p.sum(-1)[:, None] + point_labels.sum(-1)[None, :]
    return 1.0 - (numerator + 1.0) / (denominator + 1.0)


@torch.no_grad()
def hungarian_match(outputs: torch.Tensor, targets: torch.Tensor,
                    num_points: int = 12544, max_targets: int = 32,
                    ignore_label: int = 0, cost_mask: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    coords: Optional[torch.Tensor] = None):
    """``outputs`` NCHW ``[B, Q, H, W]`` mask logits, ``targets`` ``[B, Ht,
    Wt]`` ids -> (assignment ``[B, Q]`` int32: the target slot of each
    query or -1, the slots' class ids ``[B, max_targets]``). ``coords``
    ``[B, num_points, 2]`` replaces the uniform draw from ``generator``."""
    b, q = outputs.shape[:2]
    ids, valid = select_topk_masks(targets, q, ignore_label, max_targets)
    if coords is None:
        coords = torch.rand((b, num_points, 2), generator=generator,
                            device=outputs.device)
    coords = torch.as_tensor(coords, device=outputs.device).float()
    out_pts = point_sample(outputs.float(), coords, channels_last=False)
    tgt_raw = point_sample(targets[:, None].float(), coords, mode="nearest",
                           channels_last=False)[..., 0]
    tgt_pts = (tgt_raw[:, None, :] == ids[:, :, None].float()).float()
    cost = torch.stack([
        cost_mask * (sigmoid_ce_cost(o.T, t) + dice_cost(o.T, t))
        for o, t in zip(out_pts, tgt_pts)])
    cost = torch.where(valid[:, None, :], cost, torch.full_like(cost, 1e9))
    assignment = hungarian_host(cost.cpu().numpy(), valid.cpu().numpy())
    return torch.from_numpy(assignment).to(outputs.device), ids

