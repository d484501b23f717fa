"""mIoU meter, the port's counterpart of ``ldmseg_tpu/evals/miou.py``:
the per-batch intersection and union counts are computed on the tensors'
device (:func:`batch_stats`), accumulated on the host in float64;
``synchronize`` sums them over ``torch.distributed`` ranks (a no-op in one
process)."""

from __future__ import annotations

import numpy as np
import torch


def batch_stats(pred: torch.Tensor, gt: torch.Tensor, num_classes: int,
                ignore_label: int, has_bg: bool):
    """Per-class intersection and union counts of one batch (``_batch_stats``
    :20): one-hot of ``pred`` and ``gt`` over ``num_classes + has_bg``
    classes (an id outside them, the ignore label included, is all zeros,
    as ``jax.nn.one_hot`` gives), pixels where ``gt`` is the ignore label
    left out; int64 counts on the tensors' device."""
    n_eval = num_classes + int(has_bg)
    classes = torch.arange(n_eval, device=gt.device)
    valid = (gt != ignore_label).reshape(-1, 1)
    onehot_p = pred.reshape(-1, 1) == classes
    onehot_g = gt.reshape(-1, 1) == classes
    inter = (onehot_p & onehot_g & valid).sum(0)
    union = ((onehot_p | onehot_g) & valid).sum(0)
    return inter, union


class SemsegMeter:
    def __init__(self, num_classes: int, class_names=None,
                 has_bg: bool = False, ignore_index: int = 255,
                 group=None):
        self.num_classes = num_classes
        self.group = group
        self.has_bg = has_bg
        self.ignore_index = ignore_index
        n = num_classes + int(has_bg)
        self.class_names = class_names or [f"cls_{i}" for i in range(n)]
        self.reset()

    def reset(self):
        n = self.num_classes + int(self.has_bg)
        self.inter = np.zeros(n, dtype=np.float64)
        self.union = np.zeros(n, dtype=np.float64)

    def update(self, pred, gt):
        """pred, gt: integer ``[B, H, W]`` tensors (on any device) or
        arrays."""
        pred, gt = torch.as_tensor(pred), torch.as_tensor(gt)
        inter, union = batch_stats(pred, gt.to(pred.device),
                                   self.num_classes, self.ignore_index,
                                   self.has_bg)
        self.inter += inter.cpu().numpy()
        self.union += union.cpu().numpy()

    def synchronize(self, axis_name=None):
        """Sum ``inter`` and ``union`` over the group's ranks (reference
        semseg_evaluation.py:59-70; the counts are integers in float64, so
        the sum is exact). ``axis_name`` is JAX's and unused. A no-op in
        one process."""
        import torch.distributed as dist

        from ..parallel.multihost import all_gather_host
        if not dist.is_initialized() or dist.get_world_size(self.group) == 1:
            return
        stacked = np.stack(all_gather_host(
            np.stack([self.inter, self.union]), self.group))
        self.inter = stacked[:, 0].sum(0)
        self.union = stacked[:, 1].sum(0)

    def return_score(self, verbose: bool = False) -> dict:
        jac = self.inter / np.maximum(self.union, 1e-8)
        if verbose:
            for name, j in zip(self.class_names, jac):
                print(f"IoU {name}: {100*j:.2f}")
        return {"mIoU": float(100 * jac.mean()),
                "per_class": (100 * jac).tolist()}
