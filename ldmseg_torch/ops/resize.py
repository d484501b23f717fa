"""Exact 2x bilinear upsampling, NCHW, and the host-built weight matrix of
a bilinear resize (counterparts of ``ldmseg_tpu/ops/resize.py:
bilinear_upsample_2x`` and ``resize_weight_matrix``, :46).

Half-pixel centres (``align_corners=False``) make the output a fixed 2-tap
blend per axis, edge-clamped:

  out[2j]   = 0.75 * x[j] + 0.25 * x[j-1]
  out[2j+1] = 0.75 * x[j] + 0.25 * x[j+1]

computed in the input dtype, H first, then W, as the JAX version does.
"""

from __future__ import annotations

import numpy as np
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


def resize_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Host-side ``[in_size, out_size]`` float32 matrix W such that ``x @ W``
    is ``jax.image.resize(x, out_size, "linear")`` along that axis: the
    triangle kernel, widened by the scale on a downsample (antialias),
    half-pixel centres, each column normalised, zero where the sample
    centre lies outside the input (the ``inside`` mask). A copy of the
    JAX package's numpy function."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)  # antialias widening on downsample
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / \
        kernel_scale
    w = np.maximum(0.0, 1.0 - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)
