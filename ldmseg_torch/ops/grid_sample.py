"""Point sampling: detectron2's ``point_sample`` (counterpart of
``ldmseg_tpu/ops/grid_sample.py``).

The JAX package writes ``grid_sample`` out as gathers because JAX has none;
here it is ``F.grid_sample(x, 2 * coords - 1, align_corners=False,
padding_mode="zeros")``, what the reference calls (detectron2_utils.py:
73-96). Points are ``[N, P, 2]`` in the torch order ``(x, y)`` and the
result is ``[N, P, C]``. Features are channels-last ``[N, H, W, C]`` as in
the JAX module, or NCHW with ``channels_last=False`` (the port's models run
NCHW, so the losses pass their logits that way and no permute is made).
Nearest mode rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(feat: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear", align_corners: bool = False,
                channels_last: bool = True) -> torch.Tensor:
    """``grid`` ``[N, P, 2]`` in [-1, 1] -> ``[N, P, C]``; reads outside the
    image contribute zeros."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode: {mode}")
    x = feat.permute(0, 3, 1, 2) if channels_last else feat
    out = F.grid_sample(x, grid[:, :, None].to(x.dtype), mode=mode,
                        padding_mode="zeros", align_corners=align_corners)
    return out[..., 0].transpose(1, 2)


def point_sample(feat: torch.Tensor, point_coords: torch.Tensor,
                 mode: str = "bilinear", align_corners: bool = False,
                 channels_last: bool = True) -> torch.Tensor:
    """detectron2 ``point_sample``: ``point_coords`` ``[N, P, 2]`` in
    [0, 1]^2 -> ``[N, P, C]``."""
    return grid_sample(feat, 2.0 * point_coords - 1.0, mode=mode,
                       align_corners=align_corners,
                       channels_last=channels_last)
