"""PoseExpNet, the SfMLearner pose/explainability net (counterpart of
``ldmseg_tpu/models/posenet.py``), NCHW.

Seven stride-2 conv stages -> a 6-DoF pose per reference frame (scaled by
0.01), plus, with ``output_exp``, an upconv decoder emitting multi-scale
explainability masks. The frame stack is concatenated along channels. The
decoder's upconvs are ``ConvTranspose2d(k=4, s=2, padding=1)``, which
doubles the size as Flax's ``'SAME'`` does (its taps flipped by
``convert.pose_state_dict_from_jax``), then cropped to the encoder stage's
size.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

PLANES = (16, 32, 64, 128, 256, 256, 256)
KSIZES = (7, 5, 3, 3, 3, 3, 3)
UP_PLANES = (256, 128, 64, 32, 16)
# the parameters that only the explainability decoder has
DECODER_PREFIXES = ("upconv", "predict_mask")


class PoseExpNet(nn.Module):
    def __init__(self, nb_ref_imgs: int = 2, output_exp: bool = False):
        super().__init__()
        self.nb_ref_imgs = nb_ref_imgs
        self.output_exp = output_exp
        cin = 3 * (1 + nb_ref_imgs)
        for i, (c, k) in enumerate(zip(PLANES, KSIZES)):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(cin, c, k, stride=2, padding=(k - 1) // 2))
            cin = c
        self.pose_pred = nn.Conv2d(cin, 6 * nb_ref_imgs, 1)
        if output_exp:
            cin = PLANES[4]
            for i, c in enumerate(UP_PLANES):
                setattr(self, f"upconv{5 - i}",
                        nn.ConvTranspose2d(cin, c, 4, stride=2, padding=1))
                cin = c
            for i, c in enumerate(UP_PLANES[1:]):
                setattr(self, f"predict_mask{4 - i}",
                        nn.Conv2d(c, nb_ref_imgs, 3, padding=1))

    def forward(self, target_image: torch.Tensor,
                ref_imgs: Sequence[torch.Tensor], train: bool = True):
        """``target_image`` and each of ``ref_imgs`` ``[B, 3, H, W]`` ->
        (masks, pose ``[B, R, 6]``): masks ``[B, R, h, w]`` at full, 1/2,
        1/4 and 1/8 resolution when ``train`` (a list of 4; ``[None] * 4``
        without ``output_exp``), else the full-resolution one (None without
        ``output_exp``), as the JAX module returns them."""
        if len(ref_imgs) != self.nb_ref_imgs:
            raise ValueError(f"{len(ref_imgs)} reference frames for "
                             f"nb_ref_imgs={self.nb_ref_imgs}")
        x = torch.cat([target_image, *ref_imgs], dim=1)
        feats = []
        h = x
        for i in range(len(PLANES)):
            h = F.relu(getattr(self, f"conv{i + 1}")(h))
            feats.append(h)

        pose = self.pose_pred(h).mean(dim=(2, 3))
        pose = 0.01 * pose.reshape(pose.shape[0], self.nb_ref_imgs, 6)

        if not self.output_exp:
            return ([None] * 4, pose) if train else (None, pose)

        targets = [feats[3], feats[2], feats[1], feats[0], x]
        h = feats[4]
        ups = []
        for i, t in enumerate(targets):
            h = F.relu(getattr(self, f"upconv{5 - i}")(h))
            h = h[:, :, :t.shape[2], :t.shape[3]]
            ups.append(h)
        masks = [torch.sigmoid(getattr(self, f"predict_mask{4 - i}")(u))
                 for i, u in enumerate(ups[1:])]
        exp1, exp2, exp3, exp4 = masks[3], masks[2], masks[1], masks[0]
        if train:
            return [exp1, exp2, exp3, exp4], pose
        return exp1, pose


def load_pose_state_dict(model: PoseExpNet, sd: Mapping) -> None:
    """``model.load_state_dict(sd, strict=True)``, except that a state dict
    with the explainability decoder (trained with ``output_exp``) loads
    into a model without it: exactly the ``upconv*`` and ``predict_mask*``
    keys are dropped then, as Flax ignores those leaves. Any other missing
    or extra key raises."""
    if not model.output_exp:
        sd = {k: v for k, v in sd.items()
              if not k.startswith(DECODER_PREFIXES)}
    model.load_state_dict(sd, strict=True)
