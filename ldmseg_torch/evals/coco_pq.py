"""COCO-panoptic PQ, the port's own copy (numpy) of
``ldmseg_tpu/evals/coco_pq.py``.

COCO-panoptic-json PQ (panopticapi ``pq_compute`` equivalent).

Reference: ldmseg/evaluations/panoptic_evaluation.py (COCO PQ via
panopticapi) and panoptic_evaluation_agnostic.py (class-agnostic variant
that rewrites GT categories, :59-72 + custom pq_compute :188-230).

panopticapi semantics per image: segments match when same category and
IoU > 0.5, where IoU's union discounts overlap with VOID (id 0); crowd GT
segments are excluded from matching but matched-crowd-overlapping
predictions are not penalized.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

VOID = 0


def pq_compute_images(
    matched_pairs: list,
    num_categories: int = 201,
    class_agnostic: bool = False,
    things: set | None = None,
) -> dict:
    """Compute PQ over (pred_map, pred_segments, gt_map, gt_segments)
    tuples. Maps are int id arrays; segments are lists of dicts with
    ``id``, ``category_id``, optional ``iscrowd``.
    """
    stats = defaultdict(lambda: {"tp": 0, "fp": 0, "fn": 0, "iou": 0.0})

    for pred_map, pred_segments, gt_map, gt_segments in matched_pairs:
        gt_cat = {s["id"]: (1 if class_agnostic else s["category_id"])
                  for s in gt_segments}
        gt_crowd = {s["id"] for s in gt_segments if s.get("iscrowd", 0)}
        pr_cat = {s["id"]: (1 if class_agnostic else s["category_id"])
                  for s in pred_segments}

        gm = gt_map.astype(np.int64)
        pm = pred_map.astype(np.int64)
        gt_ids, gt_areas = np.unique(gm, return_counts=True)
        pr_ids, pr_areas = np.unique(pm, return_counts=True)
        gt_area = dict(zip(gt_ids.tolist(), gt_areas.tolist()))
        pr_area = dict(zip(pr_ids.tolist(), pr_areas.tolist()))

        offset = 2**32
        comb, inter = np.unique(gm * offset + pm, return_counts=True)
        inter_map = {}
        for c, a in zip(comb.tolist(), inter.tolist()):
            inter_map[(c // offset, c % offset)] = a

        gt_matched, pr_matched = set(), set()
        for (gid, pid), a in inter_map.items():
            if gid not in gt_cat or pid not in pr_cat:
                continue
            if gid in gt_crowd:
                continue
            if gt_cat[gid] != pr_cat[pid]:
                continue
            union = gt_area[gid] + pr_area[pid] - a - \
                inter_map.get((VOID, pid), 0)
            iou = a / union if union > 0 else 0.0
            if iou > 0.5:
                c = gt_cat[gid]
                stats[c]["tp"] += 1
                stats[c]["iou"] += iou
                gt_matched.add(gid)
                pr_matched.add(pid)

        for gid, c in gt_cat.items():
            if gid in gt_matched or gid in gt_crowd:
                continue
            stats[c]["fn"] += 1

        # crowd-of-same-class overlap counts as ignore for FPs
        crowd_area_by_cat: dict = defaultdict(int)
        for gid in gt_crowd:
            crowd_area_by_cat[gt_cat[gid]] = gid
        for pid, c in pr_cat.items():
            if pid in pr_matched:
                continue
            ignore = inter_map.get((VOID, pid), 0)
            if c in crowd_area_by_cat:
                ignore += inter_map.get((crowd_area_by_cat[c], pid), 0)
            if pr_area.get(pid, 0) and \
                    ignore / pr_area[pid] > 0.5:
                continue
            stats[c]["fp"] += 1

    per_class = {}
    pqs, sqs, rqs = [], [], []
    t_pqs, s_pqs = [], []
    for c, s in stats.items():
        if s["tp"] + s["fp"] + s["fn"] == 0:
            continue
        sq = s["iou"] / s["tp"] if s["tp"] else 0.0
        rq = s["tp"] / (s["tp"] + 0.5 * s["fp"] + 0.5 * s["fn"])
        pq = sq * rq
        per_class[c] = {"pq": pq, "sq": sq, "rq": rq, **s}
        pqs.append(pq)
        sqs.append(sq)
        rqs.append(rq)
        if things is not None:
            (t_pqs if c in things else s_pqs).append(pq)

    def mean(x):
        return float(np.mean(x)) if x else 0.0

    return {
        "pq": 100 * mean(pqs), "sq": 100 * mean(sqs),
        "rq": 100 * mean(rqs), "per_class": per_class,
        "thing_pq": 100 * mean(t_pqs), "stuff_pq": 100 * mean(s_pqs),
        "n": len(pqs),
    }
