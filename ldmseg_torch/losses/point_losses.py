"""PointRend point losses of the stage-1 seg VAE (counterpart of
``ldmseg_tpu/losses/point_losses.py``; reference losses.py:117-442).

``point_losses`` gives ``{"ce", "mask"}``: cross-entropy with ignore on
uncertainty-sampled points of the class logits, and per-present-class
sigmoid BCE + Dice on uncertainty-sampled points of each selected class's
logit map. The present classes are the ``max_masks`` largest of a
per-image histogram (:func:`select_topk_masks`), so that every shape is
fixed, as in JAX. The binary targets are never drawn at full resolution:
the bilinear sample of an indicator map is the weight of the four corner
pixels whose id matches (:func:`bilinear_corner_ids`).

Logits are NCHW ``[B, C, h, w]`` (the JAX functions take NHWC); targets are
``[B, H, W]`` class ids. The random point coordinates come from
``generator``, or from ``draws``: ``{"ce": (oversampled, extra), "mask":
(oversampled, extra)}`` for the two calls of
:func:`~..ops.uncertainty.get_uncertain_point_coords`. Under data
parallelism (``group``) the CE's valid-point count and the mask count are
the global batch's, as on JAX's mesh (``parallel/mesh.py:global_mean``).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops.grid_sample import point_sample
from ..parallel.mesh import global_mean
from ..ops.uncertainty import (get_uncertain_point_coords, topk_indices,
                               uncertainty_sigmoid, uncertainty_top2)


@dataclasses.dataclass(frozen=True)
class PointLossConfig:
    """``loss_kwargs`` (reference base.yaml:107-113)."""

    num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    ignore_label: int = 0
    temperature: float = 1.0
    max_masks: int = 32


def select_topk_masks(targets: torch.Tensor, num_classes: int,
                      ignore_label: int, max_masks: int):
    """The ``max_masks`` classes with the most pixels per image, the lower
    class first among equal counts (``jax.lax.top_k``); ids out of
    ``[0, num_classes)`` are not counted (``jnp.bincount`` with a length
    drops them). Returns ``(ids [B, K] int64, valid [B, K] bool)``."""
    b = targets.shape[0]
    t = targets.reshape(b, -1).long()
    inside = (t >= 0) & (t < num_classes)
    hist = torch.zeros((b, num_classes), dtype=torch.int64,
                       device=targets.device)
    hist.scatter_add_(1, t.clamp(0, num_classes - 1), inside.long())
    hist[:, ignore_label] = 0
    ids = topk_indices(hist, max_masks)
    return ids, torch.gather(hist, 1, ids) > 0


def bilinear_corner_ids(targets: torch.Tensor, coords: torch.Tensor):
    """The four pixels around each point (``align_corners=False``, zero
    padding) and their bilinear weights: ``targets`` ``[B, H, W]``,
    ``coords`` ``[B, P, 2]`` (x, y) in [0, 1] -> ids ``[B, P, 4]`` and
    weights ``[B, P, 4]`` fp32 (0 outside the image)."""
    b, h, w = targets.shape
    ix = coords[..., 0].float() * w - 0.5
    iy = coords[..., 1].float() * h - 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    x0, y0 = x0.long(), y0.long()
    flat = targets.reshape(b, h * w)
    ids, wgts = [], []
    for dx, dy, wgt in ((0, 0, (1 - wx1) * (1 - wy1)),
                        (1, 0, wx1 * (1 - wy1)),
                        (0, 1, (1 - wx1) * wy1),
                        (1, 1, wx1 * wy1)):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        ids.append(torch.gather(flat, 1, idx))
        wgts.append(wgt * valid.float())
    return torch.stack(ids, dim=-1), torch.stack(wgts, dim=-1)


def _ce_loss(logits: torch.Tensor, targets: torch.Tensor,
             cfg: PointLossConfig, generator=None, draws=None, group=None):
    """CE with ignore on uncertainty-sampled points (losses.py:303-362):
    labels by nearest sampling, logits bilinear, / temperature."""
    coords = get_uncertain_point_coords(
        logits, uncertainty_top2, cfg.num_points, cfg.oversample_ratio,
        cfg.importance_sample_ratio, generator=generator, draws=draws)
    labels = point_sample(targets[:, None].float(), coords, mode="nearest",
                          channels_last=False)[..., 0].long()
    point_logits = point_sample(logits, coords,
                                channels_last=False) / cfg.temperature
    logp = F.log_softmax(point_logits, dim=-1)
    picked = torch.gather(logp, -1, labels[..., None])[..., 0]
    valid = (labels != cfg.ignore_label).float()
    return global_mean(-(picked * valid).sum(), valid.sum(), group)


def _mask_losses(logits: torch.Tensor, targets: torch.Tensor,
                 cfg: PointLossConfig, generator=None, draws=None,
                 group=None):
    """BCE + Dice per selected class on sampled points (losses.py:117-207),
    normalised by the number of masks (over the global batch with
    ``group``)."""
    b, c, h, w = logits.shape
    k, p = cfg.max_masks, cfg.num_points
    ids, valid = select_topk_masks(targets, c, cfg.ignore_label, k)
    num_masks = valid.float().sum()
    src = torch.gather(logits, 1, ids[:, :, None, None].expand(-1, -1, h, w))
    src = src.reshape(b * k, 1, h, w)
    coords = get_uncertain_point_coords(
        src, uncertainty_sigmoid, p, cfg.oversample_ratio,
        cfg.importance_sample_ratio, generator=generator, draws=draws)
    point_logits = point_sample(src, coords, channels_last=False)[..., 0]

    corner_ids, corner_w = bilinear_corner_ids(
        targets, coords.reshape(b, k * p, 2))
    match = (corner_ids.reshape(b, k, p, 4) == ids[:, :, None, None]).float()
    point_labels = (match * corner_w.reshape(b, k, p, 4)).sum(-1)
    point_labels = point_labels.reshape(b * k, p)
    vmask = valid.reshape(b * k).float()

    x = point_logits
    bce = x.clamp_min(0) - x * point_labels + torch.log1p(torch.exp(-x.abs()))
    loss_bce = global_mean((bce.mean(-1) * vmask).sum(), num_masks, group)
    prob = torch.sigmoid(x)
    numerator = 2.0 * (prob * point_labels).sum(-1)
    denominator = prob.sum(-1) + point_labels.sum(-1)
    dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)
    return loss_bce + global_mean((dice * vmask).sum(), num_masks, group)


def point_losses(logits: torch.Tensor, targets: torch.Tensor,
                 cfg: PointLossConfig,
                 corrupt_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Mapping] = None, group=None) -> dict:
    """``{"ce", "mask"}`` (losses.py:364-395). Where ``corrupt_mask``
    ``[B, H, W]`` is 0 the targets become the ignore label. ``group``: the
    data ranks of the global batch (each value is then this rank's share,
    whose mean over the ranks is the global loss)."""
    if corrupt_mask is not None:
        targets = torch.where(corrupt_mask.bool(), targets,
                              torch.full_like(targets, cfg.ignore_label))
    draws = draws or {}
    return {"ce": _ce_loss(logits, targets, cfg, generator,
                           draws.get("ce"), group),
            "mask": _mask_losses(logits, targets, cfg, generator,
                                 draws.get("mask"), group)}
