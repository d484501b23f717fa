"""Where the time of the sampling path goes on the card.

    python -m ldmseg_torch.tools.profile_sampling [--int8 [fused|a|b|c]] [--gn]
        [--projs] [--padded] [--packed] [--absorbed]

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
(int8). ``--projs`` builds it with ``UNetConfig.use_fused_projs`` and
samples int8 (fused norms): the transformer blocks on K8 and K9.
``--packed`` builds it with ``UNetConfig.use_packed_attention``: the
self-attention on K14 (bf16), or with ``--int8 a`` on K15 (with fused norms
the flag does nothing, as in JAX). ``--absorbed`` builds it with
``UNetConfig.use_absorbed_attention``: the self-attention with its four
projections on K16 (bf16), or with ``--int8 a`` on K17.
``--padded`` traces the K11 UNet instead (:data:`PADDED_FLAGS`, filled by
``prepare_int8_unet`` from the trainer's masters: K11 and K12): (a) 5
forwards and (b) one 50-step ``ddim_sample`` on that latent, the RGB
latents random. For each window it prints one JSON line: wall time, device time
summed over kernels, the device's busy share (the union of kernel intervals
over the wall time), device time by kernel family and the top kernels.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time

import numpy as np
import torch

FAMILIES = (  # first match wins
    ("K5/K6 groupnorm_silu", r"gn_(cluster|stats|apply|ymax|quant)_kernel"),
    ("K7 gn_silu_conv", r"gn_conv_kernel"),
    ("K1/K14/K16 attention_fwd", r"attention_fwd_kernel"),
    ("K2 attention_bwd", r"attention_bwd_"),
    ("K3/K8/K10 attention (sm90)", r"attn_s8_kernel_sm90"),
    ("K8/K16 bf16 products: proj_in, qkv, to_out (sm90)",
     r"gemm_kernel<.*(BiasF32Epi|StoreBf16Epi)"),
    ("K3/K8/K10 products: qkv, to_out (sm90)",
     r"gemm_kernel<.*(QkvPadEpi|ResidualEpi)"),
    ("K4/K9/K12 products: up, down (sm90)",
     r"gemm_kernel<.*(GateEpi|DownEpi)"),
    ("K4/K9/K12 interior quantize", r"::quant_kernel"),
    ("K13/K11/K15/K17 attention (sm90), quantize, amax",
     r"attn_s8pv_kernel_sm90|attn_s8_kernel|quant_qkv_kernel|amax_qkv_"
     r"kernel|amax_scales_kernel"),
    ("K11/K10/K17 products (sm90)",
     r"gemm_kernel<.*(QkPadEpi|VtEpi|DequantEpi|ResidualS8Epi|"
     r"AbsorbedProjEpi)|gemm_heads_kernel"),
    ("K17/K18 dynamic quantize, to_out per head",
     r"group_quant_kernel|group_amax_kernel|head_out_kernel"),
    ("K9 proj_out (s8_common), K16 fp32 products",
     r"s8_gemm_kernel|bf16_gemm_kernel|f32_gemm_kernel"),
    ("K3/K4/K11/K12/K17 (LN +) quantize", r"ln_quant_kernel"),
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


# the K11 UNet: variant (a)'s flags with padded attention; no trainer path
# reaches K11 (the trainer sets use_padded_attention = fused_norms), the
# UNet's own entry point does
PADDED_FLAGS = dict(use_int8_conv=True, int8_act_scale=0.05,
                    use_padded_attention=True, use_int8_ff=True,
                    use_fused_ff=True, int8_attn_act_scale=0.1)


def int8_unet_from(masters, flags: dict, dtype=torch.bfloat16,
                   scales=None, absorbed_attention: bool = False):
    """A UNet with the int8 ``flags`` on the float UNet ``masters``'
    config, filled from it by ``prepare_int8_unet`` (with the activation
    ``scales`` of ``calibrate_int8`` when given, and its
    ``absorbed_attention`` switch), in ``dtype`` on its device, without
    gradients (K11 and K17 are inference only)."""
    from ldmseg_torch.models.unet import UNet2DCondition
    from ldmseg_torch.ops.quant import apply_act_scales, prepare_int8_unet
    device = next(masters.parameters()).device
    with torch.device(device):
        unet = UNet2DCondition(dataclasses.replace(masters.config, **flags))
    unet.to(dtype).eval().requires_grad_(False)
    apply_act_scales(unet, scales)
    prepare_int8_unet(unet, masters, absorbed_attention=absorbed_attention)
    return unet


def padded_sample(unet, rgb: torch.Tensor, noise: torch.Tensor,
                  steps: int = 50) -> torch.Tensor:
    """The port's ``ddim_sample`` with self-conditioning on ``unet``, the
    RGB latents ``rgb`` beside the noisy ones as the trainer feeds them."""
    from ldmseg_torch.diffusion.ddim import make_ddim_schedule
    from ldmseg_torch.diffusion.sampler import ddim_sample
    from ldmseg_torch.utils.config import DEFAULT_CONFIG
    sched = make_ddim_schedule(**DEFAULT_CONFIG["noise_scheduler_kwargs"],
                               device=rgb.device)

    def model_fn(z, cond, t):
        x = torch.cat([z, rgb, cond], dim=1).to(rgb.dtype)
        return unet(x, torch.full((z.shape[0],), t, device=z.device))
    with torch.no_grad():
        return ddim_sample(sched, model_fn, noise, steps,
                           self_condition=True)


def unet_config_for(gn: bool = False, projs: bool = False,
                    packed: bool = False, absorbed: bool = False):
    """The default deployment's UNet (12 input channels, K1) with the resnet
    norm flags ``use_pallas_gn`` and ``int8_fuse_gn`` when ``gn``,
    ``use_fused_projs`` when ``projs``, ``use_packed_attention`` when
    ``packed`` and ``use_absorbed_attention`` when ``absorbed``; without
    any, None (the trainer builds its own)."""
    from ldmseg_torch.models.unet import UNetConfig
    if not (gn or projs or packed or absorbed):
        return None
    return UNetConfig(in_channels=12, use_fused_attention=True,
                      use_pallas_gn=gn, int8_fuse_gn=gn,
                      use_fused_projs=projs, use_packed_attention=packed,
                      use_absorbed_attention=absorbed)


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
    parser.add_argument("--projs", action="store_true",
                        help="int8 with UNetConfig.use_fused_projs (K8, K9)")
    parser.add_argument("--padded", action="store_true",
                        help="the K11 UNet (PADDED_FLAGS) and ddim_sample")
    parser.add_argument("--packed", action="store_true",
                        help="UNetConfig.use_packed_attention (K14, K15)")
    parser.add_argument("--absorbed", action="store_true",
                        help="UNetConfig.use_absorbed_attention (K16, K17)")
    args = parser.parse_args()
    if args.padded and (args.int8 or args.projs or args.packed
                        or args.absorbed):
        parser.error("--padded profiles the K11 UNet: no --int8, --projs, "
                     "--packed or --absorbed")
    variant = "fused" if args.projs and args.int8 is None else args.int8
    if not torch.cuda.is_available():
        print("profile_sampling: no CUDA device", file=sys.stderr)
        return 1
    int8 = variant is not None
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True, "weight_dtype": "bfloat16"},
        "sampling_kwargs": {"int8_inference": int8,
                            **VARIANTS.get(variant, {})}})
    trainer = TrainerDiffusion(cfg, unet_config=unet_config_for(
        args.gn, args.projs, args.packed, args.absorbed))
    trainer.init_params(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, trainer.unet_config.in_channels, 32, 64),
                    generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    if args.padded:
        unet = int8_unet_from(trainer.unet, PADDED_FLAGS)
        rgb, noise = (torch.randn((2, 4, 32, 64), generator=gen,
                                  device="cuda") for _ in range(2))
        rgb = rgb.to(torch.bfloat16)
        with torch.inference_mode():
            print(json.dumps(_profile(
                lambda: unet(x, t), 5,
                "UNet forward, K11 UNet, [2, 12, 32, 64]")), flush=True)
        print(json.dumps(_profile(
            lambda: padded_sample(unet, rgb, noise), 1,
            "ddim_sample, K11 UNet, 50 DDIM steps, [2, 4, 32, 64]")),
            flush=True)
        return 0
    image = np.random.RandomState(0).randn(2, 256, 512, 3).astype(
        np.float32)
    kinds = ([f"int8 {variant}", f"int8 {variant} calibrated"] if int8
             else ["bf16"])
    if args.gn:
        kinds = [f"{k}, GN on K5/K6" for k in kinds]
    if args.projs:
        kinds = [f"{k}, fused projs (K8, K9)" for k in kinds]
    if args.packed:
        kinds = [f"{k}, packed attention" for k in kinds]
    if args.absorbed:
        kinds = [f"{k}, absorbed attention" for k in kinds]
    for kind in kinds:
        if "calibrated" in kind:
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
