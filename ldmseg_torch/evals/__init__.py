"""The port's evaluators (counterpart of ``ldmseg_tpu/evals``): panoptic
quality, mIoU, COCO-panoptic PQ, and the video metrics (VPQ statistics on
the device, DVPQ over frame windows)."""

from .coco_pq import pq_compute_images
from .dvpq import dvpq_windows, evaluate_dvpq, grown_max_seg
from .miou import SemsegMeter
from .pq import PanopticEvaluator
from .vpq import (count_segments_device, vpq_eval_device, vpq_eval_np,
                  vpq_stats_to_scores)

__all__ = [
    "PanopticEvaluator",
    "SemsegMeter",
    "count_segments_device",
    "dvpq_windows",
    "evaluate_dvpq",
    "grown_max_seg",
    "pq_compute_images",
    "vpq_eval_device",
    "vpq_eval_np",
    "vpq_stats_to_scores",
]
