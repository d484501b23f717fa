"""Diffusion training loss (counterpart of
``ldmseg_tpu/losses/diffusion_losses.py``): masked L1 / L2 / smooth-L1 with
per-timestep SNR weights and optional OHEM top-k. Under data parallelism
(``group``) the loss is the global batch's, as JAX computes it on a mesh:
the plain mean over equal shards already is; OHEM's top-k is taken over
every rank's losses together (``parallel/mesh.py:global_topk_mean``).

The port's latents are NCHW, so the mask broadcasts over the channel axis as
the reference does (``losses * mask[:, None]``); the JAX package, being
channels-last, broadcasts it over the last axis. The result is the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import global_topk_mean

LOSS_TYPES = ("l1", "l2", "smooth_l1")


def diffusion_loss(prediction: torch.Tensor, target: torch.Tensor,
                   timesteps: Optional[torch.Tensor] = None,
                   schedule_weights: Optional[torch.Tensor] = None,
                   loss_mask: Optional[torch.Tensor] = None,
                   loss_type: str = "l2",
                   ohem_ratio: float = 1.0, group=None) -> torch.Tensor:
    """Per-element loss -> mask -> SNR weight -> OHEM top-k -> mean, in fp32.

    ``prediction``/``target`` ``[B, C, h, w]``; ``timesteps`` ``[B]`` indexes
    ``schedule_weights`` ``[T]`` (``DDIMSchedule.weights``); ``loss_mask``
    ``[B, h, w]``; ``ohem_ratio`` < 1 keeps that fraction of the largest
    losses. ``group``: the data ranks whose batches together make the
    global batch (None: this batch alone); the value returned is then this
    rank's share, whose mean over the ranks is the global loss."""
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
        return global_topk_mean(flat, ohem_ratio, group)
    return flat.mean()
