"""Where the time of K3 and K4 goes, stage by stage, on the card.

    python -m ldmseg_torch.tools.profile_int8_blocks

For each (B, T, C) of the default int8 UNet forward (batch 2, 32x64 latent,
8 heads; ``chip_smoke.py``'s ``INT8_SHAPES``) it builds one transformer
block's float modules with seeded weights, packs them as the int8 UNet does
(``pack_ln_attention``, ``pack_geglu`` with the dynamic and a static
interior scale) and traces 20 calls of K3 (``ln_attention_s8``) and of K4
(``geglu_ln_s8``) on bf16 x with ``torch.profiler``. It prints one JSON
line per (kernel, shape): the CUDA-event time per call, the device time
per call summed over its kernels and split by kernel name (each of a
call's launches is a stage: LN + quantize, the products, the attention or
the interior quantize), and the number of launches per call. It reads
the kernels' names from the trace, so it profiles whatever the checkout
builds. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

# (B, T, C) of K3's and K4's launches in one int8 UNet forward, with the
# launches of each (chip_smoke.py's INT8_SHAPES)
SHAPES = [((2, 2048, 320), 5), ((2, 512, 640), 5), ((2, 128, 1280), 5),
          ((2, 32, 1280), 1)]


def short_name(name: str) -> str:
    """A kernel's name without its namespace and template arguments' noise:
    ``void (anonymous namespace)::gemm_kernel<...>(...)`` ->
    ``gemm_kernel<...>``, the arguments' own namespaces dropped."""
    name = re.sub(r"^void\s+", "", name)
    name = re.sub(r"\(anonymous namespace\)::|s8::|gemm90::|sm90::", "",
                  name)
    return re.sub(r"\(.*\)$", "", name)[:120]


def stages(fn, iters: int = 20) -> dict:
    """Event time per call of ``fn`` and its device time per call by
    kernel name, from ``torch.profiler`` over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    event_ms = start.elapsed_time(end) / iters
    for _ in range(3):  # a trace now and then comes back without kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by_name, launches = {}, 0
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            key = short_name(e.name)
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
            launches += 1
        if launches:
            break
    device = {k: v / 1e3 / iters for k, v in
              sorted(by_name.items(), key=lambda kv: -kv[1])}
    return {"event_ms": event_ms,
            "device_ms": sum(device.values()) if device else
            "not measured (no device events in trace)",
            "launches_per_call": launches / iters,
            "stages_device_ms": device}


def block_modules(c: int, seed: int, device: str = "cuda"):
    """A transformer block's float modules (LayerNorm, CrossAttention,
    LayerNorm, FeedForward) with seeded weights, as ``chip_smoke.py``
    builds them."""
    from ldmseg_torch.models.layers import LayerNorm, init_random_
    from ldmseg_torch.models.unet import CrossAttention, FeedForward
    gen = torch.Generator(device=device).manual_seed(seed)
    mods = [LayerNorm(c), CrossAttention(c, 8, use_fused=True),
            LayerNorm(c), FeedForward(c)]
    for m in mods:
        m.to(device)
        init_random_(m, gen)
    return mods


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("profile_int8_blocks: no CUDA device", file=sys.stderr)
        return 1
    from ldmseg_torch.ops import attention_s8 as K3
    from ldmseg_torch.ops import geglu as K4
    gen = torch.Generator(device="cuda").manual_seed(7)
    total = {}
    for (b, t, c), per_fwd in SHAPES:
        norm1, attn, norm3, ff = block_modules(c, seed=t + c)
        apack = K3.pack_ln_attention(norm1, attn, 8, 0.1)
        x = torch.randn((b, t, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        runs = {"K3": lambda: K3.ln_attention_s8(x, apack)}
        for mode, gs in (("dynamic", None), ("static", 0.02)):
            fpack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05, gs)
            runs[f"K4 {mode}"] = (
                lambda p=fpack: K4.geglu_ln_s8(x, p))
        with torch.inference_mode():
            for kid, fn in runs.items():
                row = stages(fn)
                print(json.dumps({"kernel": kid, "shape_btc": [b, t, c],
                                  "per_unet_forward": per_fwd, **row}),
                      flush=True)
                if isinstance(row["device_ms"], float):
                    acc = total.setdefault(kid, [0.0, 0.0])
                    acc[0] += row["event_ms"] * per_fwd
                    acc[1] += row["device_ms"] * per_fwd
    print(json.dumps({"per_unet_forward_ms": {
        k: {"event_ms": v[0], "device_ms": v[1]} for k, v in total.items()},
        "device": torch.cuda.get_device_name(0)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
