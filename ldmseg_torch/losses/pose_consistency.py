"""Pose-consistency (SfMLearner-style) losses (counterpart of
``ldmseg_tpu/losses/pose_consistency.py``).

  * 6-DoF pose (tx ty tz rx ry rz, PoseExpNet's output convention) ->
    SE(3) matrices,
  * depth + intrinsics inverse-warp of a reference frame onto the target
    frame (bilinear or nearest sampling through ``ops.grid_sample``,
    differentiable in the frame and in the pose),
  * photometric L1 weighted by the explainability mask + the mask's
    binary-cross-entropy regularizer (SfMLearner, arXiv:1704.07813),
  * the same warp on analog-bits maps gives the segmentation
    temporal-consistency loss.

Frames, depth and masks are channels-last as in the JAX module;
:func:`inverse_warp` also takes and returns NCHW frames with
``channels_last=False`` (the trainer's latents). The 3x3 products (the
Euler composition, the rotation of the camera points, the inversion) are
written out as fp32 multiply-adds, so that no TF32 or reduced-precision
matmul setting reaches them: JAX runs the rotation at
``precision="highest"``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.grid_sample import grid_sample
from ..parallel.mesh import global_mean


def _mat33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for ``[..., 3, k]`` and ``[..., k, m]`` as elementwise
    products summed in fp32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def euler_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """[..., 3] (rx, ry, rz) -> [..., 3, 3] rotation (XYZ convention)."""
    rx, ry, rz = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one = torch.ones_like(rx)
    zero = torch.zeros_like(rx)
    shape = rx.shape + (3, 3)
    Rx = torch.stack([one, zero, zero,
                      zero, cx, -sx,
                      zero, sx, cx], dim=-1).reshape(shape)
    Ry = torch.stack([cy, zero, sy,
                      zero, one, zero,
                      -sy, zero, cy], dim=-1).reshape(shape)
    Rz = torch.stack([cz, -sz, zero,
                      sz, cz, zero,
                      zero, zero, one], dim=-1).reshape(shape)
    return _mat33(_mat33(Rz, Ry), Rx)


def pose_vec_to_mat(pose: torch.Tensor) -> torch.Tensor:
    """[..., 6] (t, euler) -> [..., 3, 4] transform (SfMLearner layout)."""
    t = pose[..., :3]
    R = euler_to_matrix(pose[..., 3:])
    return torch.cat([R, t[..., None]], dim=-1)


def invert_pose_mat(T: torch.Tensor) -> torch.Tensor:
    """Invert a ``[..., 3, 4]`` SE(3) transform: ``(R, t) -> (Rᵀ, -Rᵀt)``.
    PoseExpNet predicts target->ref poses; warping the anchor frame's
    latent into a reference frame needs ref->target
    (``TrainerDiffusion.sample_panoptic_clip``)."""
    R = T[..., :3]
    t = T[..., 3]
    Rt = R.transpose(-1, -2)
    return torch.cat([Rt, -_mat33(Rt, t[..., None])], dim=-1)


def inverse_warp(
    ref: torch.Tensor,
    depth: torch.Tensor,
    pose: torch.Tensor,
    focal: torch.Tensor,
    cx: Optional[torch.Tensor] = None,
    cy: Optional[torch.Tensor] = None,
    mode: str = "bilinear",
    channels_last: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample ``ref`` at the projection of the target frame's pixels.

    Args:
      ref: ``[B, H, W, C]`` reference frame (``[B, C, H, W]`` with
        ``channels_last=False``).
      depth: ``[B, H, W]`` target-frame depth.
      pose: ``[B, 6]`` target->reference relative pose, or a ``[B, 3, 4]``
        SE(3) matrix (e.g. from :func:`invert_pose_mat`).
      focal: ``[B]`` focal length in pixels (KITTI meta['focal']).
      cx/cy: principal point (default: image center).

    Returns: (warped, in ``ref``'s layout, valid ``[B, H, W]`` in-bounds
    mask, bool).
    """
    b, h, w = depth.shape
    depth = depth.float()
    focal = focal.float().reshape(b, 1, 1)
    cx = (torch.full((b, 1, 1), (w - 1) / 2.0, device=depth.device)
          if cx is None else cx.float().reshape(b, 1, 1))
    cy = (torch.full((b, 1, 1), (h - 1) / 2.0, device=depth.device)
          if cy is None else cy.float().reshape(b, 1, 1))

    ys = torch.arange(h, dtype=torch.float32, device=depth.device)[None, :,
                                                                    None]
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)[None,
                                                                    None, :]
    x_cam = (xs - cx) / focal * depth
    y_cam = (ys - cy) / focal * depth
    pts = torch.stack([x_cam, y_cam, depth], dim=-1)  # [B, H, W, 3]

    T = pose_vec_to_mat(pose) if pose.dim() == 2 else pose  # [B, 3, 4]
    R, t = T[..., :3].float(), T[..., 3].float()
    pts_ref = (R[:, None, None] * pts[..., None, :]).sum(-1) + \
        t[:, None, None, :]

    z = torch.clamp_min(pts_ref[..., 2], 1e-3)
    u = pts_ref[..., 0] / z * focal + cx
    v = pts_ref[..., 1] / z * focal + cy

    # normalized [0, 1] coords, pixel centres at (i + 0.5) / size
    coords = torch.stack([(u + 0.5) / w, (v + 0.5) / h], dim=-1)
    grid = 2.0 * coords.reshape(b, h * w, 2) - 1.0
    warped = grid_sample(ref, grid, mode=mode, channels_last=channels_last)
    warped = warped.reshape(b, h, w, warped.shape[-1])
    if not channels_last:
        warped = warped.permute(0, 3, 1, 2)
    valid = ((u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
             & (pts_ref[..., 2] > 1e-3))
    return warped, valid


def photometric_consistency_loss(
    target: torch.Tensor,
    refs: torch.Tensor,
    depth: torch.Tensor,
    poses: torch.Tensor,
    focal: torch.Tensor,
    exp_masks: Optional[torch.Tensor] = None,
    mask_reg_weight: float = 0.2,
) -> dict:
    """SfMLearner view-synthesis objective over ``R`` reference frames.

    Args:
      target: ``[B, H, W, C]``.
      refs: ``[B, R, H, W, C]``.
      depth: ``[B, H, W]`` target depth (GT from the DVPS datasets or
        predicted).
      poses: ``[B, R, 6]`` PoseExpNet output.
      exp_masks: optional ``[B, H, W, R]`` explainability (sigmoid).

    Returns: {'photo': scalar, 'mask_reg': scalar, plus 'warped' for vis}.
    """
    r = poses.shape[1]
    photo = 0.0
    warped_all = []
    for i in range(r):
        warped, valid = inverse_warp(refs[:, i], depth, poses[:, i], focal)
        diff = (warped - target).abs() * valid[..., None]
        if exp_masks is not None:
            diff = diff * exp_masks[..., i:i + 1]
        photo = photo + diff.mean()
        warped_all.append(warped)

    out = {"photo": photo / r, "warped": torch.stack(warped_all, dim=1)}
    if exp_masks is not None:
        # encourage masks toward 1 (SfMLearner cross-entropy w/ ones)
        eps = 1e-6
        out["mask_reg"] = mask_reg_weight * torch.mean(
            -torch.log(exp_masks + eps))
    else:
        out["mask_reg"] = torch.zeros((), device=target.device)
    return out


def segmentation_consistency_loss(
    target_bits: torch.Tensor,
    ref_bits: torch.Tensor,
    depth: torch.Tensor,
    pose: torch.Tensor,
    focal: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """Temporal consistency on analog-bits maps: warp the reference
    frame's bit planes onto the target (nearest, half to even — ids must
    not blend) and penalize disagreement on valid pixels (their count over
    the global batch with ``group``, :func:`~..parallel.mesh.
    global_mean`)."""
    warped, valid = inverse_warp(ref_bits, depth, pose, focal,
                                 mode="nearest")
    per_pixel = (warped - target_bits).abs().mean(-1)
    return global_mean((per_pixel * valid).sum(), valid.sum().float(),
                       group)
