"""Where the time of the int8 blocks goes, stage by stage, on the card.

    python -m ldmseg_torch.tools.profile_int8_blocks [--blocks K3,K4,...]

For each (B, T, C) of the int8 UNet forward (batch 2, 32x64 latent, 8
heads; ``chip_smoke.py``'s ``INT8_SHAPES``) it builds one transformer
block's float modules with seeded weights, packs them as the int8 UNets do
and traces 20 calls of each block on bf16 x with ``torch.profiler``: K3
(``ln_attention_s8``), K4 (``geglu_ln_s8``, dynamic and a static interior
scale), K8 (``ln_attention_s8_pin`` on the tokens view of a channel-major
``[B, C, T]`` x, as the UNet hands it, with a seeded 1x1 ``proj_in``), K13
(``fused_self_attention_s8`` on the head views of bf16 q, k, v, static
scale 0.1), K15 (``fused_self_attention_packed_s8``), K11
(``padded_attention_s8``), K17 (``absorbed_self_attention_s8``) and the
bf16 K16 (``absorbed_self_attention`` on the block's four bf16 weights:
the same shapes as the sampling path's, where K16 runs in bf16); beside
K8 the bf16 1x1 ``proj_in`` conv alone (cuDNN: its prologue's library
yardstick), beside K16 ``F.linear`` x 4 (cuBLAS: its products'). It
prints one JSON line per (block, shape): the CUDA-event time per call, the
device time per call summed over its kernels and split by kernel name, the
same split by stage (:data:`STAGES`: LN + quantize, the products, the
attention, the quantize passes), and the number of launches per call. It
reads the kernels' names from the trace, so it profiles whatever checkout
it imports: run it as a file with ``PYTHONPATH`` at another tree to
profile that tree. Needs a CUDA device.
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


# stage -> regex on a kernel's short name, per block; a kernel that matches
# no stage counts under "other". The names of the parent designs (the
# Ampere-era attn_s8_kernel, s8_gemm_kernel, group_amax_kernel,
# head_out_kernel) are kept so that an older tree splits the same way; the
# wmma product K8 and K16 ran before they moved to gemm_kernel
# (bf16_gemm_kernel) is not: an older tree's K8 and K16 show it under
# "other", and chip_smoke.py fails where it comes back.
STAGES = {
    "K3": {"ln_quant": r"ln_quant_kernel", "qkv": r"QkvPadEpi",
           "attention": r"attn_s8_kernel_sm90", "to_out": r"ResidualEpi"},
    "K4": {"ln_quant": r"ln_quant_kernel", "up": r"GateEpi",
           "quant": r"^quant_kernel", "down": r"DownEpi"},
    "K13": {"quant": r"quant_qkv_kernel",
            "attention": r"attn_s8pv_kernel_sm90|^attn_s8_kernel<"},
    "K15": {"amax": r"amax_qkv_kernel|amax_scales_kernel|[Mm]emset",
            "quant": r"quant_qkv_kernel",
            "attention": r"attn_s8pv_kernel_sm90|^attn_s8_kernel<"},
    "K11": {"ln_quant": r"ln_quant_kernel",
            "qk": r"QkPadEpi|s8_gemm_kernel<.*QkvEpi", "v": r"VtEpi",
            "attention": r"attn_s8pv_kernel_sm90|^attn_s8_kernel<",
            "to_out": r"DequantEpi|DequantBf16Epi"},
    "K17": {"ln_quant": r"ln_quant_kernel|[Mm]emset",
            "qkv": r"AbsorbedProjEpi",
            "quant": r"group_quant_kernel|group_amax_kernel",
            "attention": r"attn_s8pv_kernel_sm90|^attn_s8_kernel<",
            "to_out": r"gemm_heads_kernel|head_out_kernel"},
}
# K18's wrapper repeats its per-tensor weight scales over the heads
STAGES["K18"] = {**STAGES["K17"], "scales": r"direct_copy_kernel"}
STAGES["K10"] = {**STAGES["K11"], "to_out": r"ResidualS8Epi"}
# K8: K3's four behind the proj_in prologue on the Hopper product
STAGES["K8"] = {"proj_in": r"^gemm_kernel<.*BiasF32Epi", **STAGES["K3"]}
# K16 (bf16): Q, K and V in one launch over three W maps, K1's attention
# kernel, to_out on one map
STAGES["K16"] = {"qkv": r"^gemm_kernel<.*StoreBf16Epi, 3\b",
                 "attention": r"attention_fwd_kernel_sm90",
                 "to_out": r"^gemm_kernel<.*StoreBf16Epi, 1\b"}


def by_stage(kid: str, by_name: dict) -> dict:
    """A block's device ms by kernel name summed by stage
    (:data:`STAGES`)."""
    out = {}
    for name, ms in by_name.items():
        stage = next((k for k, pat in STAGES.get(kid, {}).items()
                      if re.search(pat, name)), "other")
        out[stage] = out.get(stage, 0.0) + ms
    return out


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


def block_runs(kid: str, x: torch.Tensor, mods) -> dict:
    """label -> a call of block ``kid`` on ``x [B, T, C]`` (bf16) with the
    block's float modules ``mods`` packed as its int8 UNet packs them."""
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.ops import geglu as K4
    norm1, attn, norm3, ff = mods
    b, t, c = x.shape
    d = c // 8
    if kid == "K3":
        apack = S8.pack_ln_attention(norm1, attn, 8, 0.1)
        return {"K3": lambda: S8.ln_attention_s8(x, apack)}
    if kid == "K4":
        return {f"K4 {mode}": (
            lambda p=K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05,
                                   gs): K4.geglu_ln_s8(x, p))
            for mode, gs in (("dynamic", None), ("static", 0.02))}
    if kid in ("K13", "K15"):
        q, k, v = (x.roll(i, dims=1) for i in range(3))
        if kid == "K15":
            return {"K15": lambda: S8.fused_self_attention_packed_s8(
                q, k, v, 8, d ** -0.5)}
        qh, kh, vh = (z.unflatten(-1, (8, d)) for z in (q, k, v))
        return {"K13": lambda: S8.fused_self_attention_s8(
            qh, kh, vh, d ** -0.5, 0.1)}
    if kid == "K11":
        ppack = S8.pack_padded_attention(attn, 8, 0.05)
        return {"K11": lambda: S8.padded_attention_s8(x, ppack)}
    if kid == "K8":
        from ldmseg_torch.models.layers import init_random_
        conv = torch.nn.Conv2d(c, c, 1).to(x.device)
        with torch.no_grad():
            init_random_(conv, torch.Generator(device=x.device).manual_seed(c))
        p = S8.with_proj_in(S8.pack_ln_attention(norm1, attn, 8, 0.1), conv)
        xg = x.transpose(1, 2).contiguous().transpose(1, 2)  # [B, C, T]
        # the prologue's library yardstick: the bf16 1x1 conv on NCHW
        conv_b = torch.nn.Conv2d(c, c, 1).to(x.device, torch.bfloat16)
        conv_b.load_state_dict(conv.state_dict())
        x_nchw = xg.transpose(1, 2).unsqueeze(-1)
        return {"K8": lambda: S8.ln_attention_s8_pin(xg, p),
                "K8 proj_in conv (cuDNN)": lambda: conv_b(x_nchw)}
    if kid == "K16":
        import torch.nn.functional as F
        from ldmseg_torch.ops import attention as A
        ws = [m.weight.to(torch.bfloat16) for m in
              (attn.to_q, attn.to_k, attn.to_v, attn.to_out[0])]
        # its products' library yardstick: F.linear x 4 (cuBLAS)
        return {"K16": lambda: A.absorbed_self_attention(x, *ws, 8,
                                                         d ** -0.5),
                "K16 F.linear x 4 (cuBLAS)": lambda: [F.linear(x, w)
                                                      for w in ws]}
    if kid == "K17":
        p = S8.pack_absorbed_attention(attn, 8, 0.1)
        # a pack of a tree before the head-padded to_out has no wo_p
        extra = (p.wo_p,) if hasattr(p, "wo_p") else ()
        return {"K17": lambda: S8.absorbed_self_attention_s8(
            x, p.w_qkv, p.wo_q, p.w_scale, 8, d ** -0.5, p.xs, *extra)}
    raise ValueError(f"unknown block {kid!r}")


BLOCKS = ("K3", "K4", "K8", "K13", "K15", "K11", "K17", "K16")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--blocks", default=",".join(BLOCKS),
                        help="comma-separated, of " + ", ".join(BLOCKS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_int8_blocks: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(7)
    total = {}
    for (b, t, c), per_fwd in SHAPES:
        mods = block_modules(c, seed=t + c)
        x = torch.randn((b, t, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        with torch.inference_mode():
            for kid in args.blocks.split(","):
                for label, fn in block_runs(kid, x, mods).items():
                    row = stages(fn)
                    row["by_stage_device_ms"] = by_stage(
                        kid, row["stages_device_ms"])
                    print(json.dumps({"kernel": label, "shape_btc": [b, t, c],
                                      "per_unet_forward": per_fwd, **row}),
                          flush=True)
                    if isinstance(row["device_ms"], float):
                        acc = total.setdefault(label, {"event_ms": 0.0,
                                                       "device_ms": 0.0,
                                                       "by_stage": {}})
                        acc["event_ms"] += row["event_ms"] * per_fwd
                        acc["device_ms"] += row["device_ms"] * per_fwd
                        for k, v in row["by_stage_device_ms"].items():
                            acc["by_stage"][k] = (acc["by_stage"].get(k, 0.0)
                                                  + v * per_fwd)
    print(json.dumps({"per_unet_forward_ms": total,
                      "device": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
