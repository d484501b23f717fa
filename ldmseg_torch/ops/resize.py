"""Exact 2x bilinear upsampling, NCHW (counterpart of
``ldmseg_tpu/ops/resize.py:bilinear_upsample_2x``).

Half-pixel centres (``align_corners=False``) make the output a fixed 2-tap
blend per axis, edge-clamped:

  out[2j]   = 0.75 * x[j] + 0.25 * x[j-1]
  out[2j+1] = 0.75 * x[j] + 0.25 * x[j+1]

computed in the input dtype, H first, then W, as the JAX version does.
"""

from __future__ import annotations

import torch


def _up_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    first, last = x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)
    prev = torch.cat([first, x.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), last], dim=dim)
    even = 0.75 * x + 0.25 * prev
    odd = 0.75 * x + 0.25 * nxt
    shape = list(x.shape)
    shape[dim] = 2 * n
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def bilinear_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x bilinear upsample of ``[B, C, H, W]``."""
    return _up_axis(_up_axis(x, 2), 3)
