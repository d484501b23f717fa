"""The metric-level gate on a trained model (counterpart of
``ldmseg_tpu/tools/perf/trained_gate.py``).

    python3 -m ldmseg_torch.tools.trained_gate [--ae-steps 300]
        [--ldm-steps 500] [--pose-steps 100] [--out-dir DIR]
        [--device cuda|cpu]

Trains a small two-stage model on synthetic DVPS through the trainers
(stage 1: the seg VAE, ``TrainerAE``; stage 2: the LDM, ``TrainerDiffusion``
adopting the trained seg VAE; then a short ``TrainerPose`` run), and gates
the task metric:

  (a) sampled DVPQ rises over training (against the step-0 model);
  (b) int8 sampling, auto-calibrated on the trained weights, lands within
      max(2, 10% of bf16) of bf16 DVPQ;
  (c) pose-warped clip sampling is not worse than per-frame sampling by
      more than 1 on DVPQ with ``eval_frames=2``.

The model is sized so that the hand-written kernels engage on the card: the
stage-2 UNet at widths (32, 64) with 2 heads (head dims 16 and 32) on a
12x40 latent (T = 480 and 120) runs K1 and K2 in training and bf16
sampling, K3 and K4 in int8 sampling. JAX's gate builds that UNet without
``use_fused_attention`` (its trainer sets the flag only on the UNet it
builds itself), so its stage 2 runs XLA attention; this gate sets it as the
trainer's ``train_kwargs.fused_attention`` default does.

The flags replace the JAX gate's environment variables: ``--ae-steps``
``LDMSEG_GATE_AE_STEPS``, ``--ldm-steps`` ``LDMSEG_GATE_LDM_STEPS``,
``--pose-steps`` ``LDMSEG_GATE_POSE_STEPS``, ``--out-dir``
``LDMSEG_GATE_DIR`` (here it must be empty or new; without it the run
writes into a fresh temporary directory, removed at the end).
:func:`run`'s ``train_frames``, ``val_frames`` and ``val_batches`` (the
JAX gate's 64, 16 and 2) size the data for short runs. Every sampling
call draws its noise from a ``torch.Generator`` seeded as the JAX gate's
keys are (0 for the per-frame calls, 7 for the clip calls) and hands it
in as ``init_noise``.

Prints a line per stage as it ends (beside the JAX gate's: the DVPQ of
the trained seg VAE's own reconstructions, the most a stage-2 sample can
score through it), then a JSON line ``{"stages": ...}`` with each stage's
launches and fallbacks of K1-K4 (and of any other hand-written kernel that
ran), its s/step from ``StepTimer`` and its seconds, the card's
``nvidia-smi`` name and power limit, and last the JAX gate's JSON line
(its keys). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

H, W = 96, 320
CLIP_T = 3
# the JAX gate's evaluate_dvpq arguments: 20 synthetic classes scored as
# Cityscapes-VPS's 33 categories, 8 of them things
DVPQ_KW = {"num_cat": 33, "num_eval_cat": 32, "things_split": 8}


def small_cfg(merge_dicts, base):
    return merge_dicts(base, {
        "vae_model_kwargs": {
            "in_channels": 10, "int_channels": 32, "out_channels": 32,
            "block_out_channels": [16, 32, 32, 64], "num_upscalers": 2,
            "upscale_channels": 32, "norm_num_groups": 8,
        },
        "image_vae_kwargs": {"block_out_channels": [16, 32, 32, 64],
                             "groups": 8},
        "train_kwargs": {"batch_size": 8, "train_num_steps": 10**6,
                         "weight_dtype": "bfloat16", "clip_grad": 1.0},
        "optimizer_kwargs": {"lr": 2e-4, "weight_decay": 0.01},
        "noise_scheduler_kwargs": {"prediction_type": "epsilon",
                                   "weight": "max_clamp_snr",
                                   "max_snr": 2.0},
        "sampling_kwargs": {"num_inference_steps": 10},
        "eval_kwargs": {"count_th": 32, "mask_th": 0.0,
                        "overlap_th": 0.0, "eval_every": None},
        "transformation_kwargs": {"size": H, "size_2": W},
        "ignore_label": 0,
    })


def unet_config():
    """The gate's stage-2 UNet (JAX :135-140; the port's UNet has no
    cross-attention, so neither ``cross_attention_dim`` nor
    ``use_cross_attention=False``), with the trainer's
    default ``fused_attention``: d = c / heads a multiple of 8 at every
    attention site, T = 12 * 40 = 480 a multiple of 8."""
    from ..models.unet import UNetConfig
    return UNetConfig(
        in_channels=8, out_channels=4, block_out_channels=(32, 64),
        attn_down=(True, True), layers_per_block=1, attention_head_dim=2,
        norm_num_groups=8, use_fused_attention=True)


def panoptic_maps(logits: torch.Tensor, hw, trainer) -> np.ndarray:
    """NHWC logits -> cleaned panoptic maps ``[B, h, w]`` (removed segments
    0): the bilinear resize of ``jax.image.resize`` to ``hw``
    (``ops/resize.py``'s weights), then ``panoptic_post_process`` with the
    trainer's thresholds and ignore label 0."""
    from ..ops.panoptic import panoptic_post_process
    from ..train.restore import resize_logits
    cleaned, _ = panoptic_post_process(
        resize_logits(logits, hw), mask_th=trainer.mask_th,
        count_th=trainer.count_th, overlap_th=trainer.overlap_th,
        ignore_label=0)
    return np.maximum(cleaned.cpu().numpy(), 0)


def dvpq(preds, gts, eval_frames: int, device) -> dict:
    """The scores (``pq``, ``per_class_pq``, ...) of the maps (semantic
    ids, no instances) against the ground truth: the JAX gate's
    ``evaluate_dvpq`` call. ``pq`` is the mean over all 32 evaluated
    categories, those absent from both counting 0, as the reference's
    ``eval_dvpq.py:190-210`` averages."""
    from ..evals.dvpq import evaluate_dvpq
    zeros = [np.zeros_like(p) for p in preds]
    return evaluate_dvpq(preds, zeros, gts, zeros, eval_frames=eval_frames,
                         device=device, **DVPQ_KW)


def gt_sanity(gts, device) -> dict:
    """DVPQ of the ground truth against itself: the mean, and the least and
    largest per-category PQ over the evaluated categories it holds."""
    scores = dvpq(gts, gts, 1, device)
    held = sorted({int(c) for g in gts for c in np.unique(g)
                   if c < DVPQ_KW["num_eval_cat"]})
    per = [scores["per_class_pq"][c] for c in held]
    return {"dvpq": float(scores["pq"]), "present": len(held),
            "present_pq_min": float(min(per)),
            "present_pq_max": float(max(per))}


def sample_dvpq(trainer, ds, batches: int, seed: int,
                eval_frames: int = 1) -> float:
    """Sample the first ``batches`` batches of 8 of ``ds`` per frame and
    score DVPQ; each batch's initial noise drawn from a CPU generator
    seeded ``seed``."""
    from ..data.loader import Loader
    gen = torch.Generator().manual_seed(seed)
    preds, gts = [], []
    for bi, batch in enumerate(Loader(ds, 8, shuffle=False)):
        b, h, w = batch["semseg"].shape
        noise = torch.randn((b, h // 8, w // 8, 4), generator=gen)
        logits, _ = trainer.sample_panoptic(batch, init_noise=noise)
        preds += list(panoptic_maps(logits, (h, w), trainer))
        gts += list(batch["semseg"])
        if bi + 1 >= batches:
            break
    return float(dvpq(preds, gts, eval_frames, trainer.device)["pq"])


def recon_dvpq(ae, ds, batches: int, thresholds) -> float:
    """DVPQ of the trained seg VAE's own reconstructions of the first
    ``batches`` batches of 8 of ``ds`` (posterior mode, the upsample), with
    ``thresholds``' post-processing: the most a stage-2 sample decoded by
    this VAE can score."""
    from ..data.loader import Loader
    preds, gts = [], []
    for bi, batch in enumerate(Loader(ds, 8, shuffle=False)):
        logits = ae.eval_logits(batch)
        preds += list(panoptic_maps(logits, batch["semseg"].shape[1:],
                                    thresholds))
        gts += list(batch["semseg"])
        if bi + 1 >= batches:
            break
    return float(dvpq(preds, gts, 1, ae.device)["pq"])


def clip_dvpq(trainer, clips_val, pose_warp: bool, seed: int = 7) -> float:
    """The first batch of 4 clips of ``clips_val`` sampled with clip-shared
    noise (a 0.4 refine tail, blend 0.5, with ``pose_warp``), DVPQ with
    ``eval_frames=2`` per clip, averaged."""
    from ..data.loader import Loader
    batch = next(iter(Loader(clips_val, 4, shuffle=False)))
    b, t, h, w = batch["semseg"].shape
    gen = torch.Generator().manual_seed(seed)
    init, refine = (torch.randn((b, 1, h // 8, w // 8, 4), generator=gen)
                    for _ in range(2))
    logits, _ = trainer.sample_panoptic_clip(
        batch, init_noise=init, refine_noise=refine,
        num_inference_steps=10, repeat_noise=True, pose_warp=pose_warp,
        refine_strength=0.4, warp_blend=0.5)
    maps = panoptic_maps(logits, (h, w), trainer).reshape(b, t, h, w)
    return float(np.mean([dvpq(list(maps[i]), list(batch["semseg"][i]), 2,
                               trainer.device)["pq"] for i in range(b)]))


def _kernel_wrappers() -> dict:
    from ..ops import attention as A
    from ..ops import attention_s8 as S8
    from ..ops import geglu as G
    return {"K1": A.fused_self_attention,
            "K2": A.fused_self_attention_backward,
            "K3": S8.ln_attention_s8, "K4": G.geglu_ln_s8}


class StageCounts:
    """Each stage's launches and fallbacks of the hand-written kernels:
    every counter is set to 0 when a stage starts and read when it ends."""

    def __init__(self):
        self.stages: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str, timer=None):
        from ..ops.counters import COUNTERS, counted_wrappers
        for fn in counted_wrappers():
            for c in COUNTERS:
                if hasattr(fn, c):
                    setattr(fn, c, 0)
        t0 = time.perf_counter()
        yield
        seconds = time.perf_counter() - t0
        named = _kernel_wrappers()
        ids = {id(fn): k for k, fn in named.items()}
        launches = {k: fn.launches for k, fn in named.items()}
        fallbacks = {k: fn.fallbacks for k, fn in named.items()
                     if hasattr(fn, "fallbacks")}
        for fn in counted_wrappers():
            if id(fn) in ids:
                continue
            if fn.launches:
                launches[fn.__name__] = fn.launches
            if getattr(fn, "fallbacks", 0):
                fallbacks[fn.__name__] = fn.fallbacks
        launches["K1 D=512"] = named["K1"].wide_launches
        self.stages[name] = {
            "launches": launches, "fallbacks": fallbacks,
            "seconds": seconds,
            "step_timer": timer.summary() if timer and timer.times
            else None}
        print(f"[counts] {name}: {json.dumps(self.stages[name])}",
              flush=True)


def _time_steps(trainer, timer) -> None:
    """Time each ``train_step`` of ``trainer``'s ``train_loop`` with
    ``timer`` (its result synchronised)."""
    step = trainer.train_step

    def timed(*args, **kwargs):
        timer.start()
        out = step(*args, **kwargs)
        timer.stop(out)
        return out
    trainer.train_step = timed


def run(ae_steps: int = 300, ldm_steps: int = 500, pose_steps: int = 100,
        out_dir: Optional[str] = None, device="cuda",
        train_frames: int = 64, val_frames: int = 16,
        val_batches: int = 2):
    """The gate, writing into ``out_dir`` (made if new, refused unless
    empty; without it a temporary directory removed at the end). Returns
    ``(line, stages, trainers)``: the JAX gate's JSON line as a dict,
    :class:`StageCounts`' stages, and the trainers (``ae``, ``ldm``,
    ``int8``, ``pose``) with the datasets (``val``, ``clips_val``) for a
    caller that checks more."""
    with _out_dir(out_dir) as root:
        return _run(ae_steps, ldm_steps, pose_steps, root, torch.device(
            device), train_frames, val_frames, val_batches)


def _run(ae_steps, ldm_steps, pose_steps, out_dir, device, train_frames,
         val_frames, val_batches):
    from ..data.synthetic import SyntheticDVPS
    from ..data.video import ClipDataset
    from ..models.posenet import PoseExpNet
    from ..train.trainer_ae import TrainerAE
    from ..train.trainer_ldm import TrainerDiffusion
    from ..train.trainer_pose import TrainerPose
    from ..utils.config import DEFAULT_CONFIG, merge_dicts
    from ..utils.profiling import StepTimer

    t_all = time.time()
    cfg = small_cfg(merge_dicts, DEFAULT_CONFIG)
    train_ds = SyntheticDVPS(length=train_frames, size=(H, W),
                             num_classes=20, frames_per_scene=CLIP_T)
    val_ds = SyntheticDVPS(length=val_frames, size=(H, W), num_classes=20,
                           frames_per_scene=CLIP_T, seed=1)
    counts = StageCounts()

    # ---- stage 1: seg VAE ----
    ae = TrainerAE(cfg, device=device, dataset=train_ds, val_dataset=val_ds,
                   results_folder=os.path.join(out_dir, "ae"))
    ae.init_params(seed=0)
    timer = StepTimer()
    _time_steps(ae, timer)
    with counts.stage("stage 1 train", timer):
        ae.train_loop(max_steps=ae_steps, log_every=100, save_every=10**9)
    miou = float(ae.compute_miou(max_batches=2)["mIoU"])
    print(f"[stage1] {ae_steps} steps, recon mIoU {miou:.1f}", flush=True)

    # eval plumbing: the ground truth scored against itself reads 100 in
    # every category it holds (the mean over all 32 counts the absent as 0)
    gts = [np.asarray(val_ds[i]["semseg"]) for i in range(8)]
    sanity = gt_sanity(gts, device)
    print(f"[sanity] DVPQ(gt, gt) = {sanity['dvpq']:.1f} over "
          f"{DVPQ_KW['num_eval_cat']} categories; the {sanity['present']} "
          f"present read {sanity['present_pq_min']:.1f} to "
          f"{sanity['present_pq_max']:.1f} (expect 100)", flush=True)

    # ---- stage 2: the LDM adopting the trained seg VAE ----
    ucfg = unet_config()
    cfg_ldm = merge_dicts(cfg, {"sampling_kwargs": {
        "num_inference_steps": 10, "int8_inference": False}})
    tr = TrainerDiffusion(cfg_ldm, unet_config=ucfg, device=device,
                          dataset=train_ds, val_dataset=val_ds,
                          results_folder=os.path.join(out_dir, "ldm"))
    tr.load_state_dicts(vae_seg=ae.vae.state_dict())
    recon = recon_dvpq(ae, val_ds, val_batches, tr)
    print(f"[stage1] reconstruction DVPQ {recon:.2f} (the most a stage-2 "
          f"sample decoded by this seg VAE can score)", flush=True)
    with counts.stage("stage 2 sample, step 0"):
        dvpq_step0 = sample_dvpq(tr, val_ds, val_batches, seed=0)
    print(f"[stage2] DVPQ @ step 0: {dvpq_step0:.2f}", flush=True)
    timer = StepTimer()
    _time_steps(tr, timer)
    with counts.stage("stage 2 train", timer):
        tr.train_loop(max_steps=ldm_steps, log_every=100, save_every=10**9)
    with counts.stage("stage 2 sample"):
        dvpq_bf16 = sample_dvpq(tr, val_ds, val_batches, seed=0)
    print(f"[stage2] DVPQ @ step {ldm_steps} (bf16): {dvpq_bf16:.2f}",
          flush=True)

    # ---- int8 on the trained weights (auto-calibrates on the first batch)
    cfg_i8 = merge_dicts(cfg_ldm, {"sampling_kwargs": {
        "int8_inference": True}})
    tr_i8 = TrainerDiffusion(cfg_i8, unet_config=ucfg, device=device,
                             dataset=train_ds, val_dataset=val_ds,
                             results_folder=os.path.join(out_dir, "ldm"))
    tr_i8.load_state_dicts(unet=tr.unet.state_dict(),
                           vae_img=tr.vae_img.state_dict(),
                           vae_seg=ae.vae.state_dict())
    with counts.stage("int8 sample"):
        dvpq_int8 = sample_dvpq(tr_i8, val_ds, val_batches, seed=0)
    print(f"[int8] DVPQ (auto-calibrated s8 sampling): {dvpq_int8:.2f}",
          flush=True)

    # ---- stage 3: the pose net, then pose-warped clip sampling ----
    clips_train = ClipDataset(train_ds, clip_len=CLIP_T)
    clips_val = ClipDataset(val_ds, clip_len=CLIP_T)
    tp = TrainerPose(cfg, dataset=clips_train,
                     results_folder=os.path.join(out_dir, "pose"),
                     nb_ref_imgs=CLIP_T - 1, output_exp=False, device=device)
    timer = StepTimer()
    _time_steps(tp, timer)
    with counts.stage("pose train", timer):
        tp.train_loop(max_steps=pose_steps)
    with torch.device("meta"):
        pose = PoseExpNet(nb_ref_imgs=CLIP_T - 1, output_exp=False)
    tr.attach_pose(pose, tp.model.state_dict())
    with counts.stage("clip sample, per frame"):
        dvpq_plain = clip_dvpq(tr, clips_val, False)
    with counts.stage("clip sample, pose-warped"):
        dvpq_warp = clip_dvpq(tr, clips_val, True)
    print(f"[pose] clip DVPQ(eval_frames=2): per-frame {dvpq_plain:.2f}"
          f" vs pose-warped {dvpq_warp:.2f}", flush=True)

    gates = {
        "dvpq_improves": dvpq_bf16 > dvpq_step0,
        "int8_within_noise": abs(dvpq_int8 - dvpq_bf16) <= max(
            2.0, 0.1 * dvpq_bf16),
        "pose_not_worse": dvpq_warp >= dvpq_plain - 1.0,
    }
    line = {
        "metric": "trained_model_gate",
        "recon_miou_stage1": round(miou, 2),
        "dvpq_step0": round(dvpq_step0, 2),
        "dvpq_bf16": round(dvpq_bf16, 2),
        "dvpq_int8": round(dvpq_int8, 2),
        "dvpq_clip_plain": round(dvpq_plain, 2),
        "dvpq_clip_warp": round(dvpq_warp, 2),
        "gates": gates,
        "all_pass": all(gates.values()),
        "steps": {"ae": ae_steps, "ldm": ldm_steps, "pose": pose_steps},
        "wall_s": round(time.time() - t_all, 1),
    }
    counts.stages["sanity DVPQ(gt, gt)"] = sanity
    counts.stages["stage 1 reconstruction DVPQ"] = recon
    trainers = {"ae": ae, "ldm": tr, "int8": tr_i8, "pose": tp,
                "val": val_ds, "clips_val": clips_val}
    return line, counts.stages, trainers


def _out_dir(path: Optional[str]):
    """``path`` made if new, refused unless empty; without it a fresh
    temporary directory removed on exit."""
    if path is None:
        return tempfile.TemporaryDirectory(prefix="ldmseg_gate_")
    os.makedirs(path, exist_ok=True)
    if os.listdir(path):
        raise ValueError(f"trained_gate: the out dir {path} is not empty")
    return contextlib.nullcontext(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ae-steps", type=int, default=300)
    ap.add_argument("--ldm-steps", type=int, default=500)
    ap.add_argument("--pose-steps", type=int, default=100)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line, stages, _ = run(args.ae_steps, args.ldm_steps, args.pose_steps,
                          args.out_dir, args.device)
    print(json.dumps({"stages": stages}), flush=True)
    if torch.device(args.device).type == "cuda":
        from .bench import smi_line
        print(f"device: {torch.cuda.get_device_name()}; nvidia-smi: "
              f"{smi_line()}", flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
