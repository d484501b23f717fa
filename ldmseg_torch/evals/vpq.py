"""(Depth-aware) Video Panoptic Quality statistics (counterpart of
``ldmseg_tpu/evals/vpq.py``).

Reference: eval/eval_dvpq.py:25-101 (``vpq_eval``, the VIP-DeepLab
formulation): panoptic id = category * 2^20 + instance; per (gt, pred)
segment pair with equal category and IoU > 0.5 a TP is counted, where the
union discounts the prediction's overlap with the *void* gt segment
(category 255, instance 0); unmatched gt segments (cat != 255) are FN;
unmatched pred segments are FP unless > 50% of their area overlaps ignored
gt segments (any instance of cat 255).

:func:`vpq_eval_device` computes them with tensor math on the ids' device:

  * ``torch.unique`` (sorted) compacts the segment ids, cut to ``max_seg``
    and padded with the sentinel ``300 * max_ins``, as JAX's
    ``jnp.unique(size=max_seg, fill_value=sentinel)``,
  * per-pixel (gt_idx, pred_idx) pairs from ``searchsorted`` -> one
    ``bincount`` of the combined index = the intersection matrix,
  * TP/FN/FP/IoU reduce from that [max_seg, max_seg] matrix.

Ids are int64 here; JAX runs them in int32 (no x64), and every id is below
2^31, so the answers are the same. ``vpq_eval_np`` is the numpy oracle (own
copy of JAX's).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MAX_INS = 2**20
IGN_ID = 255
NUM_CAT = 20


# ---------------------------------------------------------------------------
# Host reference (parity oracle)
# ---------------------------------------------------------------------------

def vpq_eval_np(pred_ids: np.ndarray, gt_ids: np.ndarray,
                num_cat: int = NUM_CAT, ign_id: int = IGN_ID,
                max_ins: int = MAX_INS):
    """Direct numpy port of eval/eval_dvpq.py:25-101."""
    offset = 2**30
    iou = np.zeros(num_cat)
    tp = np.zeros(num_cat)
    fn = np.zeros(num_cat)
    fp = np.zeros(num_cat)

    def counts(a):
        ids, c = np.unique(a, return_counts=True)
        return dict(zip(ids.tolist(), c.tolist()))

    pred_areas = counts(pred_ids)
    gt_areas = counts(gt_ids)
    void_id = ign_id * max_ins
    ign_ids = {g for g in gt_areas if g // max_ins == ign_id}

    int_ids = gt_ids.astype(np.int64) * offset + pred_ids.astype(np.int64)
    int_areas = counts(int_ids)

    def void_overlap(pid):
        return int_areas.get(void_id * offset + pid, 0)

    def ignored_overlap(pid):
        return sum(int_areas.get(i * offset + pid, 0) for i in ign_ids)

    gt_matched, pred_matched = set(), set()
    for int_id, area in int_areas.items():
        gid = int(int_id // offset)
        pid = int(int_id % offset)
        gcat, pcat = gid // max_ins, pid // max_ins
        if gcat != pcat:
            continue
        union = gt_areas[gid] + pred_areas[pid] - area - void_overlap(pid)
        # the reference divides numpy ints (0 -> nan -> fails the > 0.5
        # check with a warning); equivalent explicit guard here
        i = area / union if union > 0 else 0.0
        if i > 0.5:
            tp[gcat] += 1
            iou[gcat] += i
            gt_matched.add(gid)
            pred_matched.add(pid)

    for gid in gt_areas:
        if gid in gt_matched or gid // max_ins == ign_id:
            continue
        fn[gid // max_ins] += 1
    for pid in pred_areas:
        if pid in pred_matched:
            continue
        if ignored_overlap(pid) / pred_areas[pid] > 0.5:
            continue
        fp[pid // max_ins] += 1
    return iou, tp, fn, fp


# ---------------------------------------------------------------------------
# Device implementation
# ---------------------------------------------------------------------------

def _ids(x) -> torch.Tensor:
    """The ids flattened to int64, on the tensor's device (numpy: the
    CPU)."""
    return torch.as_tensor(x).reshape(-1).long()


def count_segments_device(pred_ids, gt_ids):
    """Exact distinct-segment counts ``(n_gt, n_pred)`` for one window, by
    sorting and counting transitions on the ids' device.
    :func:`vpq_eval_device` keeps only ``max_seg`` segments;
    :func:`~.dvpq.evaluate_dvpq` grows ``max_seg`` from these counts, so
    that none is ever dropped silently."""
    def n_unique(a):
        s = torch.sort(a).values
        return 1 + (s[1:] != s[:-1]).sum()

    return n_unique(_ids(gt_ids)), n_unique(_ids(pred_ids))


def _compact(ids: torch.Tensor, max_seg: int, sentinel: int):
    """The sorted distinct ids, the first ``max_seg`` of them, padded at the
    end with ``sentinel``."""
    u = torch.unique(ids)[:max_seg]
    out = torch.full((max_seg,), sentinel, dtype=ids.dtype,
                     device=ids.device)
    out[:u.numel()] = u
    return out


def vpq_eval_device(pred_ids, gt_ids, max_seg: int = 256,
                    num_cat: int = NUM_CAT, ign_id: int = IGN_ID,
                    max_ins: int = MAX_INS):
    """VPQ statistics for one (windowed) id map pair, on the ids' device.

    Args:
      pred_ids / gt_ids: int tensors (or numpy arrays: the CPU) of
        identical shape (any rank), panoptic ids = cat * max_ins + ins.
      max_seg: cap on distinct segments per map (typical windows have
        < 100); segments past it are dropped, as in JAX.

    Returns: (iou, tp, fn, fp), each a ``[num_cat]`` float32 tensor.
    """
    pred = _ids(pred_ids)
    gt = _ids(gt_ids)

    # the sentinel sorts above any real id (categories are < 256), so the
    # padded arrays stay sorted for searchsorted
    sentinel = 300 * max_ins
    gt_u = _compact(gt, max_seg, sentinel)
    pr_u = _compact(pred, max_seg, sentinel)
    gt_valid = gt_u < sentinel
    pr_valid = pr_u < sentinel

    gt_idx = torch.searchsorted(gt_u, gt)
    pr_idx = torch.searchsorted(pr_u, pred)

    # the intersection matrix from one histogram; an index past the last
    # bin (a dropped segment) is dropped, as jnp.bincount(length=) drops it
    n = max_seg * max_seg
    comb = (gt_idx * max_seg + pr_idx).clamp_max(n)
    inter = torch.bincount(comb, minlength=n + 1)[:n].reshape(
        max_seg, max_seg).float()
    gt_areas = inter.sum(1)
    pr_areas = inter.sum(0)

    gt_cat = torch.where(gt_valid, gt_u // max_ins, -1)
    pr_cat = torch.where(pr_valid, pr_u // max_ins, -2)

    # void overlap: intersection of each pred with gt id == ign_id*max_ins
    is_void_gt = (gt_u == ign_id * max_ins) & gt_valid
    void_overlap = (inter * is_void_gt[:, None].float()).sum(0)
    # ignored overlap: all gt segments with cat == ign_id
    is_ign_gt = (gt_cat == ign_id) & gt_valid
    ign_overlap = (inter * is_ign_gt[:, None].float()).sum(0)

    same_cat = gt_cat[:, None] == pr_cat[None, :]
    union = gt_areas[:, None] + pr_areas[None, :] - inter - \
        void_overlap[None, :]
    iou_mat = torch.where(same_cat & (inter > 0),
                          inter / union.clamp_min(1.0),
                          torch.zeros_like(inter))
    match = iou_mat > 0.5

    cat_onehot_gt = F.one_hot(gt_cat.clamp(0, num_cat - 1),
                              num_cat).float() * gt_valid[:, None]
    # TP / IoU per category (match rows index gt segments)
    tp_per_gt = match.any(1)
    iou_per_gt = (iou_mat * match).sum(1)
    tp = (cat_onehot_gt * tp_per_gt[:, None]).sum(0)
    iou = (cat_onehot_gt * iou_per_gt[:, None]).sum(0)

    # FN: unmatched valid gt with cat != ign
    fn_seg = gt_valid & ~tp_per_gt & (gt_cat != ign_id)
    fn = (cat_onehot_gt * fn_seg[:, None]).sum(0)

    # FP: unmatched valid pred unless mostly ignored
    pr_matched = match.any(0)
    mostly_ignored = ign_overlap / pr_areas.clamp_min(1.0) > 0.5
    fp_seg = pr_valid & ~pr_matched & ~mostly_ignored
    cat_onehot_pr = F.one_hot(pr_cat.clamp(0, num_cat - 1),
                              num_cat).float() * pr_valid[:, None]
    fp = (cat_onehot_pr * fp_seg[:, None]).sum(0)

    return iou, tp, fn, fp


def vpq_stats_to_scores(iou, tp, fn, fp, num_eval_cat: int = 19,
                        things_split: int = 8):
    """Aggregate accumulated stats into PQ / TPQ / SPQ
    (eval/eval_dvpq.py:190-210). ``things_split``: classes [0, split) are
    things, [split, num_eval_cat) stuff."""
    eps = 1e-10
    iou = np.asarray(iou, dtype=np.float64)[:num_eval_cat]
    tp = np.asarray(tp, dtype=np.float64)[:num_eval_cat]
    fn = np.asarray(fn, dtype=np.float64)[:num_eval_cat]
    fp = np.asarray(fp, dtype=np.float64)[:num_eval_cat]
    sq = iou / (tp + eps)
    rq = tp / (tp + 0.5 * fn + 0.5 * fp + eps)
    pq = sq * rq
    return {
        "pq": float(pq.mean() * 100),
        "tpq": float(pq[:things_split].mean() * 100),
        "spq": float(pq[things_split:].mean() * 100),
        "per_class_pq": (pq * 100).tolist(),
    }
