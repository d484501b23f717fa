"""The port's bench line: 50-step panoptic inference throughput on the card.

    python3 -m ldmseg_torch.tools.bench [--batch 16] [--steps 50] [--calls 3]
        [--eager]
    python3 -m ldmseg_torch.tools.bench --breakdown [--batch 16] [--steps 50]

The counterpart of the JAX package's ``bench.py``: the full inference
pipeline, RGB image-VAE encode -> 50 DDIM steps of the SD-1.4-width UNet
(8 input channels, no self-conditioning) -> seg-VAE decode to 128 logits,
on 256x512 frames (a 32x64 latent), batch 16 by default, seeded random
weights, through ``TrainerDiffusion.sample_panoptic``, whose steps replay a
CUDA graph (``--eager``: the eager loop; the line's ``sampler`` says
which). The image VAE is the JAX bench's: ``ImageVAE(use_int8=True,
int8_act_scale=0.05, use_fused_attention=True)``, its codes prepared once
from its bf16 weights (s8 resnet convs and downsamples, its mid attention
on K1 at head dim 512). The pipeline runs three times: in bf16
(self-attention on K1), on the default int8 path
(``sampling_kwargs.int8_inference`` with ``fused_norms`` and ``fused_ff``:
s8 convs, K3 and K4), and on that path with DPM-Solver++(2M) at
``DPM_STEPS`` = 20 steps (``sampling_kwargs.sampler: dpmpp_2m``, JAX's
``dpm_fps`` probe, ``bench.py:171``), each with one warm-up call and ``--calls`` timed calls
(host clock around work that ends in ``torch.cuda.synchronize()``).
Beside them it times the flagship UNet forward of
:func:`ldmseg_torch.entry.entry` (CUDA events).

Prints ONE JSON line: ``{"metric": "frames_per_s", "value": <the int8
DDIM path's frames/s>, "unit": "frames/s", "dpm_fps": <the DPM path's>,
...}`` with the forward's ms, each path's s per call, frames/s, peak device
memory and kernel launches per call, the batch, the steps, and the card's
``nvidia-smi`` name and power limit. It has no ``vs_baseline``: the JAX
bench's baseline was taken on a TPU.

``--breakdown`` (the JAX package's ``tools/perf/breakdown.py``) splits the
int8 pipeline into its stages instead, at ``bench_config(int8=True)``
(which is the JAX breakdown's configuration: padded attention with fused
norms, s8 convs at act scale 0.05, int8 fused feed-forward, attention act
scale 0.1, the int8 image VAE with fused attention, the seg VAE 16 -> 128
logits) on random 256x512 frames: the image encode, the ``--steps``-step
DDIM loop (one CUDA graph a call) and the seg-VAE decode, each timed with
CUDA events over repeated calls after a warm-up call (5 for the encode and
decode, 3 for the loop), and prints one JSON line with their ms and the
frames/s of their sum.

Needs a CUDA device; without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

IMAGE_HW = (256, 512)
# the steps of the JAX bench's DPM-Solver++(2M) probe (bench.py:171)
DPM_STEPS = 20


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# the JAX bench's image VAE (bench.py:59-60)
IMAGE_VAE_KWARGS = {"use_int8": True, "int8_act_scale": 0.05,
                    "use_fused_attention": True}


def bench_config(int8: bool, sampler: str = "ddim") -> dict:
    """The JAX bench's pipeline as a trainer config: its image VAE,
    DEFAULT_CONFIG's seg VAE (16 bits in, 128 logits), bf16 compute, no
    self-conditioning; with ``int8`` the default int8 path; ``sampler``
    "ddim" or "dpmpp_2m"."""
    from ..utils.config import DEFAULT_CONFIG, merge_dicts
    return merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": False,
                         "weight_dtype": "bfloat16"},
        "image_vae_kwargs": dict(IMAGE_VAE_KWARGS),
        "sampling_kwargs": {"int8_inference": int8, "sampler": sampler}})


def _launch_counts() -> dict:
    """The launch counters of the pipeline's kernels: K1 (the UNet's
    head dims), K1's wide class (the image VAE's mid attention, D = 512),
    K3 and K4."""
    from ..ops import attention as A
    from ..ops import attention_s8 as AS
    from ..ops import geglu as G
    return {"K1": A.fused_self_attention.launches,
            "K1 D=512": A.fused_self_attention.wide_launches,
            "K3": AS.ln_attention_s8.launches, "K4": G.geglu_ln_s8.launches}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_sampling(trainer, batch: int, steps: int, calls: int,
                     warmup: int, image_hw=IMAGE_HW, graph=None) -> dict:
    """``sample_panoptic`` on ``batch`` random ``image_hw`` frames
    (``graph`` as ``ddim_sample`` takes it): ``warmup`` calls, then
    ``calls`` timed ones; s per call (their mean, and each call's),
    frames/s, peak memory and the kernels' launches per call."""
    dev = trainer.device
    image = np.random.RandomState(0).randn(
        batch, *image_hw, 3).astype(np.float32)
    frames = {"image": image}
    for _ in range(warmup):
        trainer.sample_panoptic(frames, num_inference_steps=steps,
                                graph=graph)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launch_counts()
    each = []
    for _ in range(calls):
        t0 = time.perf_counter()
        logits, _ = trainer.sample_panoptic(frames,
                                            num_inference_steps=steps,
                                            graph=graph)
        _sync(dev)
        each.append(time.perf_counter() - t0)
    secs = sum(each) / calls
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("bench: sample_panoptic gave non-finite logits")
    return {
        "s_per_call": secs, "s_each_call": each,
        "frames_per_s": batch / secs,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "launches_per_call": {k: (n - before[k]) / calls
                              for k, n in _launch_counts().items()},
        "logits_shape": list(logits.shape)}


def measure_forward(fn, args, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of ``fn(*args)`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(batch: int = 16, steps: int = 50, calls: int = 3,
        warmup: int = 1, eager: bool = False) -> dict:
    """The bench line as a dict, on the card: the flagship forward of
    :func:`ldmseg_torch.entry.entry`, then the full-width pipeline in bf16,
    on the default int8 path and on that path with DPM-Solver++(2M) at
    ``DPM_STEPS``, its steps a CUDA graph (or with ``eager`` the eager
    loop)."""
    from ..entry import entry
    from ..train.trainer_ldm import TrainerDiffusion
    device = torch.device("cuda")
    line = {"metric": "frames_per_s", "value": None, "unit": "frames/s",
            "batch": batch, "steps": steps, "image_hw": list(IMAGE_HW),
            "calls": calls, "warmup": warmup,
            "dpm_steps": DPM_STEPS,
            "sampler": ("DDIM, the eager loop" if eager else
                        "DDIM, each call's steps replayed as a CUDA graph"),
            "image_vae": dict(IMAGE_VAE_KWARGS)}
    fn, args = entry(device)
    line["unet_forward_ms"] = measure_forward(fn, args)
    line["unet_forward_shape"] = list(args[0].shape)
    del fn, args
    torch.cuda.empty_cache()
    for kind, int8, sampler, n in (("bf16", False, "ddim", steps),
                                   ("int8", True, "ddim", steps),
                                   ("dpm", True, "dpmpp_2m", DPM_STEPS)):
        trainer = TrainerDiffusion(bench_config(int8, sampler),
                                   device=device)
        trainer.init_params(seed=0)
        line[kind] = measure_sampling(trainer, batch, n, calls, warmup,
                                      graph=not eager)
        del trainer
        torch.cuda.empty_cache()
    line["value"] = line["int8"]["frames_per_s"]
    line["dpm_fps"] = line["dpm"]["frames_per_s"]
    line["path"] = ("int8: s8 convs, K3 and K4 (fused_norms, fused_ff); "
                    "int8 image VAE with its mid attention on K1 (D = 512)")
    line["device"] = torch.cuda.get_device_name(device)
    line["nvidia_smi"] = smi_line()
    return line


def breakdown(batch: int = 16, steps: int = 50, iters: int = 5,
              loop_iters: int = 3) -> dict:
    """Encode, the DDIM loop and decode of the int8 bench pipeline apart,
    in ms (CUDA events) and the frames/s of their sum."""
    from ..diffusion.sampler import ddim_sample
    from ..train.trainer_ldm import TrainerDiffusion
    device = torch.device("cuda")
    trainer = TrainerDiffusion(bench_config(int8=True), device=device)
    trainer.init_params(seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    h, w = IMAGE_HW
    image = torch.randn((batch, h, w, 3), generator=gen, device=device)
    init = torch.randn((batch, 4, h // 8, w // 8), generator=gen,
                       device=device)
    unet = trainer.int8_unet()
    with torch.inference_mode():
        rgb = trainer._encode_rgb(image)
        x0 = ddim_sample(trainer.sched, lambda z, c, t: trainer._unet_apply(
            unet, z, rgb, c, t), init, num_inference_steps=steps)

        def encode():
            return trainer._encode_rgb(image)

        def loop():
            return ddim_sample(
                trainer.sched, lambda z, c, t: trainer._unet_apply(
                    unet, z, rgb, c, t), init, num_inference_steps=steps)

        def decode():
            z = (x0 * (1.0 / trainer.seg_scale)).to(trainer.compute_dtype)
            return trainer.vae_seg.decode(z, True)

        enc_ms = measure_forward(encode, (), iters, warmup=1)
        loop_ms = measure_forward(loop, (), loop_iters, warmup=1)
        dec_ms = measure_forward(decode, (), iters, warmup=1)
        logits = decode()
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("breakdown: non-finite logits")
    total = enc_ms + loop_ms + dec_ms
    for name, ms in (("encode", enc_ms), (f"loop{steps}", loop_ms),
                     ("decode", dec_ms)):
        print(f"{name:8s} {ms:8.1f} ms", flush=True)
    return {"metric": "stage_breakdown", "batch": batch, "steps": steps,
            "image_hw": list(IMAGE_HW), "encode_ms": enc_ms,
            "loop_ms": loop_ms, "loop_ms_per_step": loop_ms / steps,
            "decode_ms": dec_ms, "total_ms": total,
            "frames_per_s": batch / (total / 1e3),
            "iters": {"encode": iters, "loop": loop_iters,
                      "decode": iters},
            "path": "int8: s8 convs, K3 and K4; the int8 image VAE with "
                    "its mid attention on K1 (D = 512); the loop one CUDA "
                    "graph a call",
            "device": torch.cuda.get_device_name(device),
            "nvidia_smi": smi_line()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--eager", action="store_true",
                        help="the eager DDIM loop instead of the CUDA graph")
    parser.add_argument("--breakdown", action="store_true",
                        help="encode, the DDIM loop and decode apart")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.breakdown:
        print(json.dumps(breakdown(args.batch, args.steps)), flush=True)
        return 0
    print(json.dumps(run(args.batch, args.steps, args.calls, args.warmup,
                         args.eager)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
