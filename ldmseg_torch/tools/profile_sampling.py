"""Where the time of the sampling path goes on the card.

    python -m ldmseg_torch.tools.profile_sampling [--int8 [fused|a|b|c]] [--gn]

Builds the default deployment of ``chip_smoke.py`` (SD-1.4 UNet and image
VAE, DEFAULT_CONFIG seg VAE, bf16, self-conditioning) with seeded random
weights and traces, with ``torch.profiler``, (a) 5 UNet forwards at batch
2 on a 32x64 latent and (b) one 50-step ``sample_panoptic`` call on 2
frames of 256x512. ``--int8`` turns on ``sampling_kwargs.int8_inference``:
(a) then runs the int8 UNet and (b) samples on it, with the default scales
and again after ``calibrate_int8`` on the frames. Its variant picks the
transformer blocks: ``fused`` (the default: K3, K4), ``a`` (``fused_norms``
False: K13, K12), ``b`` (``fused_norms`` and ``fused_ff`` False: K13, s8
linears) or ``c`` (``fused_ff`` False: K3, s8 linears). ``--gn`` builds
the UNet with ``UNetConfig.use_pallas_gn`` and ``int8_fuse_gn``: the
resnets' GN + SiLU pairs on K5 (bf16), or on K6 feeding the s8 convs
(int8). For each window it prints one JSON line: wall time, device time
summed over kernels, the device's busy share (the union of kernel intervals
over the wall time), device time by kernel family and the top kernels.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np
import torch

FAMILIES = (  # first match wins
    ("K5/K6 groupnorm_silu", r"gn_(stats|apply|ymax|quant)_kernel"),
    ("K7 gn_silu_conv", r"gn_conv_kernel"),
    ("K1 attention_fwd", r"attention_fwd_kernel"),
    ("K2 attention_bwd", r"attention_bwd_"),
    ("K13 attention_s8", r"attn_s8_kernel|quant_qkv_kernel"),
    ("K3 attention_ln_s8", r"::(qkv|attn|out)_kernel"),
    ("K4/K12 geglu (up, down)", r"::(up|down)_kernel"),
    ("K3/K4/K12 (LN +) quantize", r"ln_quant_kernel"),
    ("int8 matmul (s8 conv)", r"s8|i8|imma|int8|Int8"),
    ("optimizer (foreach)", r"multi_tensor_apply|foreach"),
    ("group/layer norm", r"group_norm|layer_norm|GroupNorm|LayerNorm|"
                         r"welford|RowwiseMoments|ComputeFused"),
    ("convolution", r"conv|cudnn|implicit|xmma|fprop|dgrad|nchw|nhwc"),
    ("matmul", r"gemm|cutlass|nvjet|gemv|sm90_|sm80_"),
    ("softmax", r"softmax"),
    ("copy/cat/cast", r"copy|cat|Cat|convert|fill|Memcpy|memcpy"),
    ("elementwise", r"elementwise|vectorized|unrolled|silu|gelu|add|mul"),
)


# sampling_kwargs of each int8 variant
VARIANTS = {"fused": {}, "a": {"fused_norms": False},
            "b": {"fused_norms": False, "fused_ff": False},
            "c": {"fused_ff": False}}


def gn_unet_config(gn: bool):
    """The default deployment's UNet (12 input channels, K1) with the resnet
    norm flags ``use_pallas_gn`` and ``int8_fuse_gn`` when ``gn``; without,
    None (the trainer builds its own)."""
    from ldmseg_torch.models.unet import UNetConfig
    if not gn:
        return None
    return UNetConfig(in_channels=12, use_fused_attention=True,
                      use_pallas_gn=True, int8_fuse_gn=True)


def _family(name: str) -> str:
    for fam, pattern in FAMILIES:
        if re.search(pattern, name):
            return fam
    return "other"


def _kernels(prof) -> list:
    """The trace's device events without the device-side spans of user
    annotations, which are not kernels (``Optimizer.step#AdamW.step``
    covers the optimizer's kernels)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _summary(prof, wall_s: float, per: int, label: str) -> dict:
    kernels = _kernels(prof)
    if not kernels:
        return {"window": label, "wall_ms": wall_s * 1e3 / per,
                "device_ms": "not measured (no device events in trace)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name, by_family = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = _family(e.name)
        by_family[fam] = by_family.get(fam, 0.0) + us
    device_us = sum(by_family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "window": label,
        "per": per,
        "wall_ms": wall_s * 1e3 / per,
        "device_ms": device_us / 1e3 / per,
        "busy_share": busy / (wall_s * 1e6),
        "kernel_launches": len(kernels) // per,
        "families_ms": {k: v / 1e3 / per for k, v in
                        sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [[n[:90], us / 1e3 / per] for n, us in top],
    }


def _profile(fn, per: int, label: str, extra=None) -> dict:
    """Profile ``per`` calls of ``fn`` after one untraced call; ``extra``,
    if given, maps ``(prof, per)`` to more keys of the summary."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = _summary(prof, wall, per, label)
    if extra is not None:
        out.update(extra(prof, per))
    return out


def main() -> int:
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--int8", nargs="?", const="fused",
                        choices=sorted(VARIANTS),
                        help="int8 sampling, and which transformer blocks")
    parser.add_argument("--gn", action="store_true",
                        help="UNetConfig.use_pallas_gn and int8_fuse_gn")
    args = parser.parse_args()
    variant = args.int8
    if not torch.cuda.is_available():
        print("profile_sampling: no CUDA device", file=sys.stderr)
        return 1
    int8 = variant is not None
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True, "weight_dtype": "bfloat16"},
        "sampling_kwargs": {"int8_inference": int8,
                            **VARIANTS.get(variant, {})}})
    trainer = TrainerDiffusion(cfg, unet_config=gn_unet_config(args.gn))
    trainer.init_params(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, trainer.unet_config.in_channels, 32, 64),
                    generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    image = np.random.RandomState(0).randn(2, 256, 512, 3).astype(
        np.float32)
    kinds = ([f"int8 {variant}", f"int8 {variant} calibrated"] if int8
             else ["bf16"])
    if args.gn:
        kinds = [f"{k}, GN on K5/K6" for k in kinds]
    for kind in kinds:
        if kind.endswith("calibrated"):
            trainer.calibrate_int8({"image": image})
        unet = trainer.int8_unet() if int8 else trainer.inference_unet()
        with torch.inference_mode():
            print(json.dumps(_profile(
                lambda: unet(x, t), 5,
                f"UNet forward, {kind}, [2, 12, 32, 64]")), flush=True)
        print(json.dumps(_profile(
            lambda: trainer.sample_panoptic({"image": image}), 1,
            f"sample_panoptic, {kind}, 50 DDIM steps, 2 x 256x512")),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
