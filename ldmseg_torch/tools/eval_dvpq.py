"""DVPQ evaluation from files (counterpart of
``ldmseg_tpu/tools/eval_dvpq.py``), mirroring eval/eval_dvpq.py:153-210.

Reads prediction PNGs (``*cat.png`` / ``*ins.png`` (+ depth)) and the GT
``video_sequence/val`` layout (``*gtFine_class.png`` / ``*_instance.png``
/ ``*depth*.png``), builds k-frame windows, and reports PQ / TPQ / SPQ,
each window's statistics computed on the card (``--host`` for the numpy
oracle).

    python -m ldmseg_torch.tools.eval_dvpq --pan_dir P --gt_dir G
        [--depth_dir D] [--eval_frames k] [--depth_thres t] [--host]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image


def _sorted(dirname, predicate):
    names = [os.path.join(dirname, n.name) for n in os.scandir(dirname)
             if predicate(n.name)]
    return sorted(names)


def read_dvpq_inputs(pan_dir: str, gt_dir: str, depth_dir: str = "",
                     depth_thres: float = 0.0):
    """The prediction PNGs and the ground truth as per-frame arrays:
    ``(pred_cat, pred_ins, gt_cat, gt_ins, depth_pred, depth_gt)``, the
    depths None unless ``depth_thres`` > 0."""
    gt_cat_names = _sorted(gt_dir, lambda n: "gtFine_class" in n)
    gt_ins_names = [n.replace("class", "instance") for n in gt_cat_names]
    cat_pred = _sorted(pan_dir, lambda n: n.endswith("cat.png"))
    ins_pred = _sorted(pan_dir, lambda n: n.endswith("ins.png"))
    if len(cat_pred) != len(gt_cat_names):
        raise ValueError(f"{len(cat_pred)} predictions vs "
                         f"{len(gt_cat_names)} gt frames")

    def load(names):
        return [np.asarray(Image.open(n)) for n in names]

    depth_pred = depth_gt = None
    if depth_thres > 0:
        depth_gt = load(_sorted(gt_dir, lambda n: "depth" in n))
        depth_pred = load(_sorted(depth_dir, lambda n: True))
    return (load(cat_pred), load(ins_pred), load(gt_cat_names),
            load(gt_ins_names), depth_pred, depth_gt)


def main(argv=None):
    """Print and return the scores."""
    from ..evals import evaluate_dvpq

    ap = argparse.ArgumentParser()
    ap.add_argument("--pan_dir", required=True)
    ap.add_argument("--gt_dir", default="video_sequence/val")
    ap.add_argument("--depth_dir", default="")
    ap.add_argument("--eval_frames", type=int, default=1)
    ap.add_argument("--depth_thres", type=float, default=0.0)
    ap.add_argument("--host", action="store_true",
                    help="use the numpy oracle instead of the device path")
    args = ap.parse_args(argv)

    pred_cat, pred_ins, gt_cat, gt_ins, depth_pred, depth_gt = \
        read_dvpq_inputs(args.pan_dir, args.gt_dir, args.depth_dir,
                         args.depth_thres)
    scores = evaluate_dvpq(
        pred_cat, pred_ins, gt_cat, gt_ins,
        eval_frames=args.eval_frames,
        depth_pred=depth_pred, depth_gt=depth_gt,
        depth_thres=args.depth_thres,
        device="host" if args.host else "cuda",
    )
    # same 3-number report format as the reference (:206-210)
    print(f"{scores['pq']:.1f} {scores['tpq']:.1f} {scores['spq']:.1f}")
    return scores


if __name__ == "__main__":
    main()
