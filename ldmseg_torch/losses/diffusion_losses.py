"""Diffusion training loss (counterpart of
``ldmseg_tpu/losses/diffusion_losses.py``): masked L1 / L2 / smooth-L1 with
per-timestep SNR weights and optional OHEM top-k.

The port's latents are NCHW, so the mask broadcasts over the channel axis as
the reference does (``losses * mask[:, None]``); the JAX package, being
channels-last, broadcasts it over the last axis. The result is the same.
"""

from __future__ import annotations

from typing import Optional

import torch

LOSS_TYPES = ("l1", "l2", "smooth_l1")


def diffusion_loss(prediction: torch.Tensor, target: torch.Tensor,
                   timesteps: Optional[torch.Tensor] = None,
                   schedule_weights: Optional[torch.Tensor] = None,
                   loss_mask: Optional[torch.Tensor] = None,
                   loss_type: str = "l2",
                   ohem_ratio: float = 1.0) -> torch.Tensor:
    """Per-element loss -> mask -> SNR weight -> OHEM top-k -> mean, in fp32.

    ``prediction``/``target`` ``[B, C, h, w]``; ``timesteps`` ``[B]`` indexes
    ``schedule_weights`` ``[T]`` (``DDIMSchedule.weights``); ``loss_mask``
    ``[B, h, w]``; ``ohem_ratio`` < 1 keeps that fraction of the largest
    losses."""
    diff = prediction.float() - target.float()
    if loss_type == "l1":
        losses = diff.abs()
    elif loss_type == "l2":
        losses = diff ** 2
    elif loss_type == "smooth_l1":
        a = diff.abs()
        losses = torch.where(a < 1.0, 0.5 * a ** 2, a - 0.5)
    else:
        raise ValueError(f"unknown loss type {loss_type!r}: expected one of "
                         f"{LOSS_TYPES}")

    if loss_mask is not None:
        losses = losses * loss_mask[:, None]

    if schedule_weights is not None and timesteps is not None:
        w = schedule_weights[timesteps].reshape(
            (-1,) + (1,) * (losses.dim() - 1))
        losses = losses * w

    flat = losses.reshape(-1)
    if ohem_ratio < 1.0:
        flat = torch.topk(flat, int(ohem_ratio * flat.numel())).values
    return flat.mean()
