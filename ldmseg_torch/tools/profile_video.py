"""Where the memory of a clip training step and the time of a pose training
step go on the card.

    python -m ldmseg_torch.tools.profile_video

Both parts run with TF32 off, as ``chip_smoke.py`` does, and print one JSON
line each.

Clip training: the deployment of ``chip_smoke.py``'s phase 48 (SD-1.4 UNet
with self-conditioning, bf16 compute on fp32 masters, AdamW, a full-size
``PoseExpNet(nb_ref_imgs=2)`` with seeded random weights attached,
``temporal_consistency_weight`` 0.1) on one loaded batch of 2 clips x 3
frames of 192x640 ``SyntheticDVPS``, with the same trainer stepping on
other batches for comparison: the clip batch with the consistency term
off, its 6 frames as a plain batch, and 8 plain frames (phase 6's batch).
For each, after a warm-up step of that shape: the memory the process holds
before the step (``memory_allocated``), the step's peak
(``max_memory_allocated`` after a reset) and the difference, and ms a
step. The clip step with the term on is then recorded with
``torch.cuda.memory._record_memory_history`` and its trace replayed to the
moment of the peak: the blocks live then, grouped by the innermost frame
of this package that allocated them (blocks the backward allocates on
autograd's own thread carry no Python frame and form one group).

Pose training: ``TrainerPose`` as phase 49 trains it (``output_exp``,
fp32, AdamW, batch 4 clips of 3 frames of 192x640): s a step through
``train_loop`` (loader and H2D included, a new epoch each step as in phase
49), the host time to make one batch, and a ``torch.profiler`` trace of
``train_step`` on one batch already on the card (wall, device time, busy
share, kernel families).

Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

from ..utils.precision import strict_fp32
from .profile_sampling import _profile

HW = (192, 640)
T = 3
CLIPS = 2
POSE_BATCH = 4
TOP = 12


def _site(frames) -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for f in frames:
        name = f.get("filename", "")
        if name.startswith(here) and not name.endswith("profile_video.py"):
            return (f"{os.path.relpath(name, os.path.dirname(here))}:"
                    f"{f.get('line')} {f.get('name')}")
    return ("(no frame of this package: the backward on autograd's thread,"
            " or a library's own allocation)")


def _live_at_peak(snapshot) -> dict:
    """Replay the allocator's trace: the blocks live at its highest point,
    summed by allocation site (GiB), and that point's bytes."""
    trace = snapshot["device_traces"][0]
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        action = ev["action"]
        if action == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif action == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    sites: dict = {}
    for size, frames in at_peak.values():
        key = _site(frames)
        sites[key] = sites.get(key, 0) + size
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:TOP]
    return {"traced_peak_gib": peak / 2**30,
            "live_at_peak_gib_by_site": {k: v / 2**30 for k, v in top}}


def _step_memory(trainer, batch, gen, reps: int = 2) -> dict:
    trainer.train_step(batch, generator=gen)   # warm-up of this shape
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    peak = torch.cuda.max_memory_allocated()
    return {"held_gib": held / 2**30, "peak_gib": peak / 2**30,
            "step_gib": (peak - held) / 2**30, "ms_per_step": ms}


def clip_train() -> dict:
    from ..data import collate
    from ..data.synthetic import SyntheticDVPS
    from ..data.video import ClipDataset, flatten_clip_batch
    from ..models.layers import init_random_
    from ..models.posenet import PoseExpNet
    from ..train.trainer_ldm import TrainerDiffusion
    from ..utils.config import DEFAULT_CONFIG, merge_dicts

    frames = SyntheticDVPS(length=4 * T, size=HW, num_bits=8,
                           frames_per_scene=T)
    clips = ClipDataset(frames, clip_len=T)
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True, "weight_dtype": "bfloat16",
                         "batch_size": CLIPS, "video_clips": T,
                         "temporal_consistency_weight": 0.1},
        "ignore_label": 0})
    trainer = TrainerDiffusion(cfg, dataset=clips)
    trainer.init_params(seed=0)
    pose = PoseExpNet(nb_ref_imgs=T - 1).to("cuda")
    init_random_(pose, torch.Generator(device="cuda").manual_seed(7))
    trainer.attach_pose(pose)
    del pose
    clip = collate([clips[0], clips[1]])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"window": f"clip train_step, {CLIPS} clips x {T} x "
                     f"{HW[0]}x{HW[1]}, bf16 on fp32 masters, pose net "
                     f"attached; one loaded batch a variant"}
    out["clip, consistency 0.1"] = _step_memory(trainer, clip, gen)
    trainer.temporal_consistency_weight = 0.0
    out["clip, consistency 0"] = _step_memory(trainer, clip, gen)
    out["6 frames, no clip"] = _step_memory(trainer,
                                            flatten_clip_batch(clip), gen)
    out["8 frames, no clip"] = _step_memory(
        trainer, collate([frames[i] for i in range(8)]), gen)
    trainer.temporal_consistency_weight = 0.1
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    trainer.train_step(clip, generator=gen)
    torch.cuda.synchronize()
    snapshot = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    out["clip, consistency 0.1, traced"] = dict(
        held_gib=held / 2**30, **_live_at_peak(snapshot))
    del trainer, snapshot
    torch.cuda.empty_cache()
    return out


def pose_train() -> dict:
    from ..data import collate
    from ..data.loader import make_loader
    from ..data.synthetic import SyntheticDVPS
    from ..data.video import ClipDataset, clip_focal
    from ..train.trainer_pose import TrainerPose
    from ..utils.config import DEFAULT_CONFIG, merge_dicts

    clips = ClipDataset(SyntheticDVPS(length=POSE_BATCH * T, size=HW,
                                      num_bits=8, frames_per_scene=T),
                        clip_len=T)
    cfg = merge_dicts(DEFAULT_CONFIG, {"train_kwargs": {
        "batch_size": POSE_BATCH, "train_num_steps": 4}})
    out = {}
    with tempfile.TemporaryDirectory() as root:
        trainer = TrainerPose(cfg, dataset=clips, results_folder=root,
                              nb_ref_imgs=T - 1, output_exp=True)
        trainer.init_params(seed=0)
        trainer.train_loop(seed=0, max_steps=1, log_every=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_loop(seed=1, max_steps=3, log_every=3)
        torch.cuda.synchronize()
        out["train_loop_s_per_step"] = (time.perf_counter() - t0) / 3
        loader = make_loader(clips, POSE_BATCH, seed=0)
        host_ms = []
        for epoch in range(3):
            t0 = time.perf_counter()
            b = next(iter(loader.epoch(epoch)))
            host_ms.append((time.perf_counter() - t0) * 1e3)
        loader.close()
        out["host_batch_ms"] = host_ms
        host = collate([clips[i] for i in range(POSE_BATCH)])
        batch = {"image": torch.as_tensor(host["image"]).cuda(),
                 "depth": torch.as_tensor(host["depth"]).cuda(),
                 "focal": torch.as_tensor(clip_focal(host["meta"])).cuda()}
        del b
        out["train_step, one batch on the card"] = _profile(
            lambda: trainer.train_step(batch), 3,
            f"TrainerPose.train_step, {POSE_BATCH} clips x {T} x "
            f"{HW[0]}x{HW[1]}, fp32, output_exp")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_video: no CUDA device", file=sys.stderr)
        return 1
    strict_fp32()
    print(json.dumps({"clip_train": clip_train()}), flush=True)
    print(json.dumps({"pose_train": pose_train()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
