"""Write a KITTI-DVPS split folder from seeded numpy, in the layout that
:class:`ldmseg_torch.data.KittiDVPS` reads: per frame
``{scene}_{frame}_leftImg8bit.png`` (RGB), ``..._gtFine_class.png``
(Cityscapes train ids, 255 unlabeled), ``..._gtFine_instance.png`` (an
instance id per thing segment) and ``..._depth_{focal}.png`` (uint16).

    python3 -m ldmseg_torch.tools.kitti_tree ROOT [--frames 4] [--split val]

Each frame has bands of stuff (sky, building, vegetation, road; the road's
raw id 0 is unlabeled in this reader, as in KITTI-DVPS), a few rectangles
of thing classes with their instance ids and an unlabeled corner, at
KITTI's own 375x1242 unless ``hw`` says otherwise. For tests and for the
end-to-end ``compute_pq`` run of ``chip_smoke.py``; no download needed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

KITTI_HW = (375, 1242)
FOCAL = 721.5377


def write_kitti_dvps_tree(root: str, split: str = "val", frames: int = 4,
                          hw=KITTI_HW, scenes: int = 1, seed: int = 0,
                          focal: float = FOCAL) -> list:
    """Write ``frames`` frames over ``scenes`` scenes under
    ``root/split``; returns their name stems (``{scene}_{frame}``)."""
    rng = np.random.RandomState(seed)
    out_dir = os.path.join(root, split)
    os.makedirs(out_dir, exist_ok=True)
    h, w = hw
    stems = []
    for i in range(frames):
        stem = f"{i % scenes:06d}_{i // scenes:06d}"
        cls = np.zeros((h, w), np.uint8)                  # road, unlabeled
        bands = np.cumsum(rng.dirichlet(np.ones(4)) * 0.8 * h).astype(int)
        for (top, bottom), c in zip(zip([0, *bands[:3]], bands),
                                    (10, 2, 8, 1)):  # sky, building, ...
            cls[top:bottom] = c
        inst = np.zeros((h, w), np.uint8)
        for k in range(rng.randint(2, 6)):
            rh, rw = rng.randint(h // 10, h // 3), rng.randint(w // 20, w // 5)
            y, x = rng.randint(0, h - rh), rng.randint(0, w - rw)
            cls[y:y + rh, x:x + rw] = rng.randint(11, 19)  # thing classes
            inst[y:y + rh, x:x + rw] = k + 1
        cls[h - h // 12:, :w // 12] = 255                 # unlabeled corner
        shade = (cls.astype(np.float32) * 13.0) % 256
        rgb = np.clip(shade[..., None] + 40.0 * rng.randn(h, w, 3), 0, 255)
        depth = (rng.rand(h, w) * 80 * 256).astype(np.uint16)
        path = os.path.join(out_dir, stem)
        Image.fromarray(rgb.astype(np.uint8)).save(
            f"{path}_leftImg8bit.png")
        Image.fromarray(cls).save(f"{path}_gtFine_class.png")
        Image.fromarray(inst).save(f"{path}_gtFine_instance.png")
        Image.fromarray(depth).save(f"{path}_depth_{focal}.png")
        stems.append(stem)
    return stems


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("root")
    parser.add_argument("--split", default="val")
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    write_kitti_dvps_tree(args.root, args.split, args.frames,
                          seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
