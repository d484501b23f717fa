"""The port's evaluators (counterpart of ``ldmseg_tpu/evals``): panoptic
quality, mIoU and COCO-panoptic PQ. The video metrics (``vpq``, ``dvpq``)
are not ported yet."""

from .coco_pq import pq_compute_images
from .miou import SemsegMeter
from .pq import PanopticEvaluator

__all__ = [
    "PanopticEvaluator",
    "SemsegMeter",
    "pq_compute_images",
]
