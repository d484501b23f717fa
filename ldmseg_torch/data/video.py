"""Video clip batching (own copy of ``ldmseg_tpu/data/video.py``).

A :class:`ClipDataset` groups a frame dataset by scene and yields fixed-T
clips whose frames stack on a leading axis: ``collate`` then stacks a
batch of clips to ``[B, T, ...]`` and keeps ``meta`` as a list of lists.
:func:`flatten_clip_batch` turns such a batch back into ``[B*T, ...]``
frames, clip i's T frames contiguous. :func:`clip_focal` reads each clip's
focal length, as the JAX trainers do.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .collate import STACK_KEYS


class ClipDataset:
    """Wrap a frame dataset (KittiDVPS / SyntheticDVPS) into T-frame clips.

    Requires the base dataset to expose ``scene_frame(idx)`` or samples
    with ``meta['scene']/meta['frame']``. Clips are consecutive frames of
    one scene with stride ``stride``.
    """

    def __init__(self, base, clip_len: int = 5, stride: int = 1):
        self.base = base
        self.clip_len = clip_len
        scenes: dict = defaultdict(list)
        for i in range(len(base)):
            if hasattr(base, "scene_frame"):
                scene, frame = base.scene_frame(i)
            else:
                meta = base[i]["meta"]
                scene, frame = meta["scene"], meta["frame"]
            scenes[scene].append((frame, i))
        self.clips = []
        for scene, frames in scenes.items():
            frames.sort()
            idxs = [i for _, i in frames]
            for s in range(0, len(idxs) - clip_len + 1, stride):
                self.clips.append(idxs[s:s + clip_len])

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, idx: int, epoch: int = 0) -> dict:
        samples = [self.base.__getitem__(i, epoch=epoch)
                   for i in self.clips[idx]]
        out: dict = {}
        for k in STACK_KEYS:
            if k in samples[0]:
                out[k] = np.stack([s[k] for s in samples])  # [T, ...]
        out["meta"] = [s["meta"] for s in samples]
        out["text"] = samples[0].get("text", "")
        return out


def flatten_clip_batch(batch: dict) -> dict:
    """[B, T, ...] -> [B*T, ...] so frames ride the batch axis; metas
    flatten likewise."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 2:
            out[k] = v.reshape((-1,) + v.shape[2:])
        elif k == "meta":
            out[k] = [m for clip in v for m in clip]
        else:
            out[k] = v
    return out


# KITTI's focal length, where a frame's meta gives none
DEFAULT_FOCAL = 707.0


def clip_focal(metas, n: int = 0) -> np.ndarray:
    """Each clip's focal length ``[B]`` fp32: its first frame's
    ``meta['focal']``, 707 where that gives none; ``n`` clips of 707
    without metas."""
    if not metas:
        return np.full((n,), DEFAULT_FOCAL, np.float32)
    return np.asarray([float((m[0] if isinstance(m, list) else m).get(
        "focal") or DEFAULT_FOCAL) for m in metas], dtype=np.float32)
