"""Greedy-IoU panoptic quality evaluator (host numpy), the port's own copy
of ``ldmseg_tpu/evals/pq.py:PanopticEvaluator``;
``synchronize_between_processes`` sums over ``torch.distributed`` ranks
(``group``) where JAX sums over its processes.

Reference: ldmseg/evaluations/cityscapes_pap_eval.py:9-249
(``CityscapesPanopticEvaluator``) and kitti_pap_eval.py. Semantics:

  * GT panoptic segments: stuff = semantic id; things = connected
    components of the semantic mask (scipy.ndimage.label), id =
    sem * max_ins + component (:76-87) — unless an explicit gt instance
    map is provided (the KITTI variant).
  * predicted segments: same componentization of the predicted id map for
    thing classes (:89-105).
  * greedy matching: per GT segment, best same-category IoU; >= 0.5 is a
    TP (:122-163); unmatched preds are FP.
  * PQ = SQ * RQ overall + per-class / thing / stuff breakdowns
    (:176-249). Class-agnostic mode maps every id to one category
    (panoptic_evaluation_agnostic.py behaviour).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


class PanopticEvaluator:
    def __init__(self, thing_ids=frozenset({11, 12, 13, 14, 15, 16, 17, 18}),
                 ignore_label: int = 0, iou_thresh: float = 0.5,
                 max_ins: int = 1 << 20, class_agnostic: bool = False,
                 group=None):
        self.thing_ids = set(thing_ids)
        # the ranks whose images together make the set (None: the whole
        # initialised group)
        self.group = group
        self.ignore_label = ignore_label
        self.iou_thresh = iou_thresh
        self.max_ins = max_ins
        self.class_agnostic = class_agnostic
        self.reset()

    def reset(self):
        self.TP = self.FP = self.FN = 0
        self.iou_sum = 0.0
        self.per_class: dict = {}

    def _cls(self, cat):
        return self.per_class.setdefault(
            int(cat), {"tp": 0, "fp": 0, "fn": 0, "iou": 0.0})

    def _to_panoptic(self, sem, ins):
        """stuff -> sem; things -> sem * max_ins + ins; ignore -> -1
        (:33-46)."""
        sem = sem.astype(np.int64)
        ins = ins.astype(np.int64)
        pan = np.where(np.isin(sem, list(self.thing_ids)),
                       sem * self.max_ins + ins, sem)
        pan[sem == self.ignore_label] = -1
        return pan

    def _components(self, id_map):
        """Split thing segments into connected components (:89-105)."""
        pan = np.zeros_like(id_map, dtype=np.int64)
        for label in np.unique(id_map):
            if label == self.ignore_label:
                continue
            if label in self.thing_ids:
                comp, n = ndimage.label(id_map == label)
                m = id_map == label
                pan[m] = label * self.max_ins + comp[m]
            else:
                pan[id_map == label] = label
        return pan

    def add_image(self, pred_seg: np.ndarray, gt_semseg: np.ndarray,
                  gt_instance: np.ndarray | None = None):
        pred_seg = pred_seg.copy()
        pred_seg[pred_seg == -1] = self.ignore_label

        if gt_instance is None:
            gt_instance = np.zeros_like(gt_semseg)
            for tid in self.thing_ids:
                m = gt_semseg == tid
                if m.any():
                    labeled, _ = ndimage.label(m)
                    gt_instance[m] = labeled[m]
        gt_pan = self._to_panoptic(gt_semseg, gt_instance)
        pred_pan = self._components(pred_seg)

        ignore_px = (gt_semseg == self.ignore_label) | \
            (pred_seg == self.ignore_label)
        pred_pan = pred_pan.copy()
        pred_pan[ignore_px] = -1
        gt_pan = gt_pan.copy()
        gt_pan[gt_semseg == self.ignore_label] = -1

        gt_ids = np.unique(gt_pan)
        gt_ids = gt_ids[gt_ids != -1]
        pr_ids = np.unique(pred_pan)
        pr_ids = pr_ids[pr_ids != -1]

        # vectorized pairwise intersections via combined histogram
        gt_idx = np.searchsorted(gt_ids, gt_pan.ravel())
        pr_idx = np.searchsorted(pr_ids, pred_pan.ravel())
        ok = (gt_pan.ravel() != -1) & (pred_pan.ravel() != -1)
        ng, npr = len(gt_ids), len(pr_ids)
        inter = np.bincount(gt_idx[ok] * max(npr, 1) + pr_idx[ok],
                            minlength=ng * max(npr, 1)).reshape(
            ng, max(npr, 1)).astype(np.float64)
        gt_areas = np.array([(gt_pan == g).sum() for g in gt_ids],
                            dtype=np.float64)
        pr_areas = np.array([(pred_pan == p).sum() for p in pr_ids],
                            dtype=np.float64)

        def cat_of(x):
            if self.class_agnostic:
                return 1
            return int(x // self.max_ins) if x >= self.max_ins else int(x)

        matched_pred = set()
        for gi, gid in enumerate(gt_ids):
            gcat = cat_of(gid)
            self._cls(gcat)
            best_iou, best_pj = 0.0, None
            for pj, pid in enumerate(pr_ids):
                if cat_of(pid) != gcat:
                    continue
                i = inter[gi, pj]
                u = gt_areas[gi] + pr_areas[pj] - i
                iou = 0.0 if u == 0 else i / u
                if iou > best_iou:
                    best_iou, best_pj = iou, pj
            if best_iou >= self.iou_thresh:
                self.TP += 1
                self.iou_sum += best_iou
                matched_pred.add(best_pj)
                self.per_class[gcat]["tp"] += 1
                self.per_class[gcat]["iou"] += best_iou
            else:
                self.FN += 1
                self.per_class[gcat]["fn"] += 1

        self.FP += len(pr_ids) - len(matched_pred)
        for pj, pid in enumerate(pr_ids):
            if pj not in matched_pred:
                self._cls(cat_of(pid))["fp"] += 1

    def synchronize_between_processes(self):
        """Sum the counters and the per-class table over the group's ranks,
        so that a sharded val set scores as a whole (the reference gathers
        the ranks' records, panoptic_evaluation.py:97-100; the counter sums
        are exact because matching is per image). Packed as JAX packs them:
        a head row and at most 4096 class rows, refused above that; the
        ranks' tables are merged in rank order. A no-op in one process."""
        import torch.distributed as dist

        from ..parallel.multihost import all_gather_host
        if not dist.is_initialized() or dist.get_world_size(self.group) == 1:
            return
        cap = 4096  # the per-class table's row budget, as JAX's
        cats = sorted(self.per_class)
        if len(cats) > cap:
            # never truncate silently: the per-class, thing and stuff
            # breakdowns would be wrong for the dropped ids
            raise ValueError(
                f"per-class PQ table has {len(cats)} class ids > packing "
                f"cap {cap}")
        rows = np.zeros((len(cats), 5), np.float64)
        for i, c in enumerate(cats):
            st = self.per_class[c]
            rows[i] = [c, st["tp"], st["fp"], st["fn"], st["iou"]]
        head = np.array([self.TP, self.FP, self.FN, self.iou_sum,
                         len(cats)], np.float64)
        gathered = all_gather_host(np.concatenate([head[None], rows]),
                                   self.group)
        self.reset()
        for packed in gathered:
            h = packed[0]
            self.TP += int(h[0])
            self.FP += int(h[1])
            self.FN += int(h[2])
            self.iou_sum += float(h[3])
            for r in packed[1:1 + int(h[4])]:
                st = self._cls(int(r[0]))
                st["tp"] += int(r[1])
                st["fp"] += int(r[2])
                st["fn"] += int(r[3])
                st["iou"] += float(r[4])

    def evaluate(self, synchronize: bool = True) -> dict:
        if synchronize:
            self.synchronize_between_processes()
        if self.TP == 0:
            sq = rq = pq = 0.0
        else:
            sq = self.iou_sum / self.TP
            rq = self.TP / (self.TP + 0.5 * (self.FP + self.FN))
            pq = sq * rq

        per_class = {}
        thing, stuff = [], []
        for cat, s in self.per_class.items():
            if s["tp"] == 0:
                c_pq = c_sq = c_rq = 0.0
            else:
                c_sq = s["iou"] / s["tp"]
                c_rq = s["tp"] / (s["tp"] + 0.5 * (s["fp"] + s["fn"]))
                c_pq = c_sq * c_rq
            per_class[cat] = {"pq": c_pq, "sq": c_sq, "rq": c_rq, **s}
            (thing if cat in self.thing_ids else stuff).append(
                (c_pq, c_sq, c_rq))

        def avg(lst):
            if not lst:
                return (0.0, 0.0, 0.0)
            arr = np.array(lst)
            return tuple(arr.mean(axis=0))

        t_pq, t_sq, t_rq = avg(thing)
        s_pq, s_sq, s_rq = avg(stuff)
        return {
            "pq": pq * 100, "sq": sq * 100, "rq": rq * 100,
            "tp": self.TP, "fp": self.FP, "fn": self.FN,
            "iou_sum": self.iou_sum, "per_class": per_class,
            "thing_pq": t_pq * 100, "thing_sq": t_sq * 100,
            "thing_rq": t_rq * 100,
            "stuff_pq": s_pq * 100, "stuff_sq": s_sq * 100,
            "stuff_rq": s_rq * 100,
        }
