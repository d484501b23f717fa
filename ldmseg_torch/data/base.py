"""Dataset registry, the port's own copy of ``ldmseg_tpu/data/base.py``.

Dataset registry / factory.

Mirrors ldmseg/data/dataset_base.py:52-104 (``get_dataset`` with the
coco / kitti / cityscapes names incl. '-dvps' aliases; split lists become
concatenated datasets).
"""

from __future__ import annotations

from typing import Optional

from .kitti import KittiDVPS
from .cityscapes import CityscapesDVPS
from .synthetic import SyntheticDVPS

DATASETS = {
    "kitti": KittiDVPS,
    "kitti-dvps": KittiDVPS,
    "cityscapes": CityscapesDVPS,
    "cityscapes-dvps": CityscapesDVPS,
    "synthetic": SyntheticDVPS,
}


class ConcatDataset:
    """torch.utils.data.ConcatDataset equivalent (dataset_base.py:84-104)."""

    def __init__(self, datasets: list):
        self.datasets = datasets
        self._offsets = []
        total = 0
        for d in datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self):
        return self._total

    def __getitem__(self, idx: int, epoch: int = 0):
        for d, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if idx >= off:
                return d.__getitem__(idx - off, epoch=epoch)
        raise IndexError(idx)


def get_dataset(name: str, prefix: Optional[str] = None, split="train",
                **kwargs):
    if name == "synthetic":
        return SyntheticDVPS(**kwargs)
    cls = DATASETS[name]
    if isinstance(split, (list, tuple)):
        return ConcatDataset(
            [cls(prefix=prefix, split=s, **kwargs) for s in split])
    return cls(prefix=prefix, split=split, **kwargs)


# Cityscapes-style 19-class metadata shared by KITTI-DVPS and
# Cityscapes-DVPS (reference kitti.py:63-85; thing ids 11-18).
CITYSCAPES_CATEGORIES = [
    {"color": (128, 64, 128), "isthing": 0, "id": 0, "name": "road"},
    {"color": (244, 35, 232), "isthing": 0, "id": 1, "name": "sidewalk"},
    {"color": (70, 70, 70), "isthing": 0, "id": 2, "name": "building"},
    {"color": (102, 102, 156), "isthing": 0, "id": 3, "name": "wall"},
    {"color": (190, 153, 153), "isthing": 0, "id": 4, "name": "fence"},
    {"color": (153, 153, 153), "isthing": 0, "id": 5, "name": "pole"},
    {"color": (250, 170, 30), "isthing": 0, "id": 6,
     "name": "traffic light"},
    {"color": (220, 220, 0), "isthing": 0, "id": 7,
     "name": "traffic sign"},
    {"color": (107, 142, 35), "isthing": 0, "id": 8, "name": "vegetation"},
    {"color": (152, 251, 152), "isthing": 0, "id": 9, "name": "terrain"},
    {"color": (70, 130, 180), "isthing": 0, "id": 10, "name": "sky"},
    {"color": (220, 20, 60), "isthing": 1, "id": 11, "name": "person"},
    {"color": (255, 0, 0), "isthing": 1, "id": 12, "name": "rider"},
    {"color": (0, 0, 142), "isthing": 1, "id": 13, "name": "car"},
    {"color": (0, 0, 70), "isthing": 1, "id": 14, "name": "truck"},
    {"color": (0, 60, 100), "isthing": 1, "id": 15, "name": "bus"},
    {"color": (0, 80, 100), "isthing": 1, "id": 16, "name": "train"},
    {"color": (0, 0, 230), "isthing": 1, "id": 17, "name": "motorcycle"},
    {"color": (119, 11, 32), "isthing": 1, "id": 18, "name": "bicycle"},
]

CITYSCAPES_CATEGORY_NAMES = [c["name"] for c in CITYSCAPES_CATEGORIES]
THING_IDS = frozenset(c["id"] for c in CITYSCAPES_CATEGORIES
                      if c["isthing"])


def get_metadata(num_classes: int, root: str = "") -> dict:
    """Dataset metadata dict (reference kitti.py:316-326,:466-514 — the
    reference defines get_metadata twice; this is the merged, working
    version)."""
    meta = {
        "categories": CITYSCAPES_CATEGORIES,
        "thing_classes": [c["name"] for c in CITYSCAPES_CATEGORIES
                          if c["isthing"]],
        "thing_colors": [c["color"] for c in CITYSCAPES_CATEGORIES
                         if c["isthing"]],
        "stuff_classes": CITYSCAPES_CATEGORY_NAMES,
        "stuff_colors": [c["color"] for c in CITYSCAPES_CATEGORIES],
        "thing_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(CITYSCAPES_CATEGORIES)
            if c["isthing"]},
        "stuff_dataset_id_to_contiguous_id": {
            c["id"]: i for i, c in enumerate(CITYSCAPES_CATEGORIES)},
        "cat2name": {c["id"]: c["name"] for c in CITYSCAPES_CATEGORIES},
        "num_classes": num_classes,
        "panoptic_root": root,
    }
    return meta
