"""Restoring predicted logits to the ground truth's resolution and
post-processing them, shared by the two trainers' evaluations (the JAX
trainers' ``_eval_fullres``/``_fullres_post`` and their resize branch).
A class that mixes it in sets ``mask_th``, ``count_th``, ``overlap_th``
and ``ignore_label``."""

from __future__ import annotations

import numpy as np
import torch


def resize_logits(logits: torch.Tensor, size_hw) -> torch.Tensor:
    """``jax.image.resize(logits, (B, h, w, C), "linear")`` of NHWC logits
    as two host-built weight-matrix contractions in fp32 on their device
    (:func:`~..ops.resize.resize_weight_matrix`)."""
    from ..ops.resize import resize_weight_matrix
    (h, w), (ih, iw) = size_hw, logits.shape[1:3]
    dev = logits.device
    wh = torch.from_numpy(resize_weight_matrix(ih, h)).to(dev)
    ww = torch.from_numpy(resize_weight_matrix(iw, w)).to(dev)
    return torch.einsum("bhwc,hH,wW->bHWc", logits.float(), wh, ww)


class PanopticRestore:
    def restore_fullres(self, logits: torch.Tensor, metas,
                        bucket: int = 128) -> list:
        """Cleaned panoptic maps ``[oh, ow]`` (numpy int32), one per meta,
        at ``gt_sem``'s size (JAX ``_eval_fullres``, :1218): per image two
        host-built weight matrices (:func:`resize_weight_matrix`, the
        bilinear resize of ``jax.image.resize``; the crop of
        ``meta['padding'] = (top, bottom, left, right)`` folded in) into a
        canvas rounded up to ``bucket``, the out-of-image region and
        ``gt_mask``'s zeros left out through ``valid_mask``; images sharing
        a canvas restored together, at most 8 a call
        (:meth:`_fullres_post`), on the logits' device."""
        from ..ops.resize import resize_weight_matrix
        ih, iw = logits.shape[1:3]
        groups: dict = {}
        for bi, m in enumerate(metas):
            t, b_, le, r = m.get("padding") or (0, 0, 0, 0)
            oh, ow = m["gt_sem"].shape
            bh = -(-oh // bucket) * bucket
            bw = -(-ow // bucket) * bucket
            wh = np.zeros((ih, bh), np.float32)
            wh[t:ih - b_, :oh] = resize_weight_matrix(ih - t - b_, oh)
            ww = np.zeros((iw, bw), np.float32)
            ww[le:iw - r, :ow] = resize_weight_matrix(iw - le - r, ow)
            valid = np.zeros((bh, bw), bool)
            gm = m.get("gt_mask")
            valid[:oh, :ow] = True if gm is None else \
                np.asarray(gm).astype(bool)
            groups.setdefault((bh, bw), []).append((bi, wh, ww, valid))
        out = [None] * len(metas)
        for items in groups.values():
            for s in range(0, len(items), 8):
                chunk = items[s:s + 8]
                cleaned = self._fullres_post(
                    logits[[it[0] for it in chunk]],
                    *(np.stack([it[k] for it in chunk]) for k in (1, 2, 3)))
                for k, (bi, *_unused) in enumerate(chunk):
                    oh, ow = metas[bi]["gt_sem"].shape
                    out[bi] = cleaned[k, :oh, :ow]
        return out

    def restore_resized(self, logits: torch.Tensor, size_hw, mask
                        ) -> np.ndarray:
        """Cleaned panoptic maps ``[B, h, w]`` (numpy int32) after the
        bilinear resize of the logits to ``size_hw`` (JAX :1198-1209,
        ``jax.image.resize(..., "linear")``), post-processed under
        ``mask`` ``[B, h, w]``. The resize is the same contraction as
        :meth:`restore_fullres` with :func:`resize_weight_matrix`, not
        ``F.interpolate``: the two differ where the size shrinks
        (``jax.image.resize`` widens its triangle kernel by the scale)."""
        from ..ops.resize import resize_weight_matrix
        (h, w), (ih, iw) = size_hw, logits.shape[1:3]
        wh, ww = resize_weight_matrix(ih, h), resize_weight_matrix(iw, w)
        mask = np.asarray(mask).astype(bool)
        return np.concatenate([
            self._fullres_post(
                logits[s:s + 8], np.broadcast_to(wh, (len(m),) + wh.shape),
                np.broadcast_to(ww, (len(m),) + ww.shape), m)
            for s in range(0, logits.shape[0], 8)
            for m in (mask[s:s + 8],)])

    @torch.no_grad()
    def _fullres_post(self, li: torch.Tensor, wh, ww, valid) -> np.ndarray:
        """One restore call (JAX :1275): ``einsum("bhwc,bhH,bwW->bHWc")``
        of the logits with the weight matrices in fp32 on the logits'
        device, then ``panoptic_post_process`` with ``valid_mask``."""
        from ..ops.panoptic import panoptic_post_process
        dev = li.device
        resized = torch.einsum(
            "bhwc,bhH,bwW->bHWc", li.float(),
            torch.as_tensor(np.ascontiguousarray(wh), device=dev),
            torch.as_tensor(np.ascontiguousarray(ww), device=dev))
        cleaned, _ = panoptic_post_process(
            resized, mask_th=self.mask_th, count_th=self.count_th,
            overlap_th=self.overlap_th, ignore_label=self.ignore_label,
            valid_mask=torch.as_tensor(np.ascontiguousarray(valid),
                                       device=dev))
        return cleaned.cpu().numpy()
