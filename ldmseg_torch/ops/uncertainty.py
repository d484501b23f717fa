"""PointRend's uncertainty-biased point sampling (counterpart of
``ldmseg_tpu/ops/uncertainty.py``; reference detectron2_utils.py:17-70 and
losses.py:279-301).

The random coordinates come from a ``torch.Generator``, or are handed in
(``draws``), so that a caller can give the numbers another package drew.
Among equal uncertainties the lower index is taken first, as
``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` does not
promise an order).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .grid_sample import point_sample


def uncertainty_sigmoid(logits: torch.Tensor) -> torch.Tensor:
    """``[N, P, 1]`` binary-mask logits -> ``-|logit|`` ``[N, P]``."""
    return -logits[..., 0].abs()


def uncertainty_top2(logits: torch.Tensor) -> torch.Tensor:
    """``[N, P, C]`` class logits -> ``top2 - top1`` ``[N, P]`` (<= 0)."""
    top2 = torch.topk(logits, 2, dim=-1).values
    return top2[..., 1] - top2[..., 0]


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, the lower index
    first among equals (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def get_uncertain_point_coords(
        coarse_logits: torch.Tensor, uncertainty_fn, num_points: int,
        oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        channels_last: bool = False) -> torch.Tensor:
    """``num_points`` coordinates ``[N, num_points, 2]`` in [0, 1]^2: of
    ``num_points * oversample_ratio`` uniform draws, the
    ``importance_sample_ratio`` share where ``uncertainty_fn`` of the
    sampled logits is highest, then uniform extra points. ``draws`` is
    ``(oversampled [N, S, 2], extra [N, num_points - k, 2])``; without it
    both come from ``generator``. ``coarse_logits`` is NCHW unless
    ``channels_last``."""
    if oversample_ratio < 1 or not 0.0 <= importance_sample_ratio <= 1.0:
        raise ValueError("oversample_ratio >= 1 and importance_sample_ratio "
                         "in [0, 1] are needed")
    n = coarse_logits.shape[0]
    num_sampled = int(num_points * oversample_ratio)
    k_unc = int(importance_sample_ratio * num_points)
    k_rand = num_points - k_unc
    dev, dt = coarse_logits.device, coarse_logits.dtype
    if draws is None:
        over = torch.rand((n, num_sampled, 2), generator=generator,
                          device=dev, dtype=dt)
        extra = torch.rand((n, k_rand, 2), generator=generator, device=dev,
                           dtype=dt)
    else:
        over, extra = (torch.as_tensor(d, device=dev).to(dt) for d in draws)
    with torch.no_grad():  # the indices carry no gradient
        logits = point_sample(coarse_logits, over,
                              channels_last=channels_last)
        idx = topk_indices(uncertainty_fn(logits), k_unc)
    picked = torch.gather(over, 1, idx[..., None].expand(-1, -1, 2))
    if k_rand > 0:
        picked = torch.cat([picked, extra], dim=1)
    return picked
