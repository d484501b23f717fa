"""Depth-aware Video Panoptic Quality (DVPQ) over frame windows (own copy of
``ldmseg_tpu/evals/dvpq.py``).

Reference: eval/eval_dvpq.py:104-210 — sliding windows of ``eval_frames``
consecutive frames are concatenated along width; panoptic id =
cat * 2^20 + ins; predictions whose depth relative error exceeds
``depth_thres`` (where gt depth > 0) are reassigned to category 19
(:125-145); per-window vpq stats are summed and reported as PQ / TPQ
(things = classes 0-7) / SPQ (stuff = 8-18).

Works from in-memory per-frame arrays; each window's statistics come from
:func:`~.vpq.vpq_eval_device` on ``device`` (the card unless the caller
asks for the CPU), or, with ``device="host"`` (JAX's ``use_device=False``),
from the numpy oracle.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .vpq import (MAX_INS, count_segments_device, vpq_eval_device,
                  vpq_eval_np, vpq_stats_to_scores)


def _window_concat(frames: Sequence[np.ndarray], i: int, k: int):
    return np.concatenate([np.asarray(f) for f in frames[i:i + k]], axis=1)


def dvpq_windows(
    pred_cat: Sequence[np.ndarray],
    pred_ins: Sequence[np.ndarray],
    gt_cat: Sequence[np.ndarray],
    gt_ins: Sequence[np.ndarray],
    eval_frames: int = 1,
    depth_pred: Optional[Sequence[np.ndarray]] = None,
    depth_gt: Optional[Sequence[np.ndarray]] = None,
    depth_thres: float = 0.0,
):
    """Yield (pred_pan, gt_pan) windowed id maps (eval :104-150)."""
    n = len(pred_cat)
    for i in range(n - eval_frames + 1):
        pc = _window_concat(pred_cat, i, eval_frames).astype(np.int32)
        pi = _window_concat(pred_ins, i, eval_frames).astype(np.int32)
        pred = pc * MAX_INS + pi
        gc = _window_concat(gt_cat, i, eval_frames).astype(np.int32)
        gi = _window_concat(gt_ins, i, eval_frames).astype(np.int32)
        gt = gc * MAX_INS + gi

        if depth_thres > 0:
            dp = _window_concat(depth_pred, i, eval_frames).astype(np.float64)
            dg = _window_concat(depth_gt, i, eval_frames).astype(np.float64)
            mask = dg > 0
            rel = np.zeros_like(dp)
            rel[mask] = np.abs(dp[mask] - dg[mask]) / dg[mask]
            ignored = mask & (rel > depth_thres)
            pred = pred.copy()
            pred[ignored] = 19 * MAX_INS  # (:143)
        yield pred, gt


def grown_max_seg(n_segments: int, max_seg: int = 256) -> int:
    """``max_seg`` doubled until ``n_segments`` (a window's exact count of
    distinct ids, gt or pred) fits, so that no segment is dropped."""
    while max_seg < n_segments:
        max_seg *= 2
    return max_seg


def evaluate_dvpq(
    pred_cat, pred_ins, gt_cat, gt_ins,
    eval_frames: int = 1,
    depth_pred=None, depth_gt=None, depth_thres: float = 0.0,
    num_cat: int = 20, num_eval_cat: int = 19, things_split: int = 8,
    max_seg: int = 256, device="cuda",
) -> dict:
    """Accumulate VPQ stats over all windows and report PQ/TPQ/SPQ. Each
    window's exact segment counts (:func:`~.vpq.count_segments_device`)
    come first: ``max_seg`` grows (:func:`grown_max_seg`) until every
    segment fits, so that a crowded window is never cut. ``device="host"``
    scores every window with the numpy oracle instead."""
    host = device == "host"
    if not host:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "evaluate_dvpq: device 'cuda' asked for but "
                "torch.cuda.is_available() is False; pass device='cpu', or "
                "device='host' for the numpy oracle")
    iou = np.zeros(num_cat)
    tp = np.zeros(num_cat)
    fn = np.zeros(num_cat)
    fp = np.zeros(num_cat)
    for pred, gt in dvpq_windows(pred_cat, pred_ins, gt_cat, gt_ins,
                                 eval_frames, depth_pred, depth_gt,
                                 depth_thres):
        if host:
            i, t, n, p = vpq_eval_np(pred, gt, num_cat=num_cat)
        else:
            pred_t = torch.from_numpy(pred).to(device)
            gt_t = torch.from_numpy(gt).to(device)
            n_gt, n_pred = (int(x) for x in count_segments_device(pred_t,
                                                                  gt_t))
            seg = grown_max_seg(max(n_gt, n_pred), max_seg)
            i, t, n, p = (x.cpu().numpy() for x in vpq_eval_device(
                pred_t, gt_t, max_seg=seg, num_cat=num_cat))
        iou += i
        tp += t
        fn += n
        fp += p
    return vpq_stats_to_scores(iou, tp, fn, fp, num_eval_cat=num_eval_cat,
                               things_split=things_split)
