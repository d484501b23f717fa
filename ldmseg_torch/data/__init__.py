"""The port's data path: numpy and PIL transforms, the KITTI-DVPS,
Cityscapes-DVPS and COCO panoptic readers, the synthetic DVPS dataset, the
dataset registry, collation (own copies of the JAX package's numpy
modules), the threaded loader and the H2D prefetch."""

from .base import (CITYSCAPES_CATEGORIES, DATASETS, THING_IDS,
                   ConcatDataset, get_dataset, get_metadata)
from .cityscapes import CityscapesDVPS
from .coco import CocoPanoptic
from .collate import collate
from .kitti import KittiDVPS
from .loader import Loader, make_loader, prefetch_to_device
from .mask_generator import MaskingGenerator
from .synthetic import SyntheticDVPS

__all__ = [
    "CITYSCAPES_CATEGORIES",
    "DATASETS",
    "THING_IDS",
    "ConcatDataset",
    "get_dataset",
    "get_metadata",
    "CityscapesDVPS",
    "CocoPanoptic",
    "KittiDVPS",
    "SyntheticDVPS",
    "collate",
    "Loader",
    "make_loader",
    "prefetch_to_device",
    "MaskingGenerator",
]
