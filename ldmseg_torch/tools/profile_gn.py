"""The GroupNorm + SiLU kernels' time at the UNet's 44 resnet norms, on the
card: K5, K6 and K7.

    python -m ldmseg_torch.tools.profile_gn [--iters 20]

The 44 (norm, conv) halves of one UNet forward (batch 2, 32x64 latent: the
default deployment's sampling shapes) are found by :func:`site_shapes`, a
forward of the full-width UNet on the ``meta`` device (shapes only, no
weights, no card). At each, on seeded bf16 x with bf16 scale and shift (the
bf16 UNet's) and the half's conv for K7, it measures per call
(:func:`measure`): the CUDA-event time of back-to-back calls, the device
time and the kernels from ``torch.profiler`` (each kernel by name, and how
many the trace shows per call: K6's two launches apart), and the host time,
the wall time of calls issued without synchronizing over their number. It
prints one JSON line per kernel and shape class (halves of that (C, H·W),
their summed times) and one with the sums per forward and the card's name.
It reads the kernels' names from the trace, so it measures whatever
checkout it imports: run it as a file with ``PYTHONPATH`` at another tree
to measure that tree. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def site_shapes(batch: int = 2, h: int = 32, w: int = 64) -> list:
    """``[((B, C, H, W), cout), ...]``: the input of each resnet norm of
    the default deployment's UNet (12 input channels) on a ``batch x h x
    w`` latent, in the order of the forward, with the output channels of
    the conv after it; from a forward on the ``meta`` device."""
    from ldmseg_torch.models.layers import ResnetBlock
    from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(in_channels=12))
    sites = []
    for m in unet.modules():
        if isinstance(m, ResnetBlock):
            for norm, conv in ((m.norm1, m.conv1), (m.norm2, m.conv2)):
                norm.register_forward_pre_hook(
                    lambda _m, inputs, conv=conv: sites.append(
                        (tuple(inputs[0].shape), conv.out_channels)))
    x = torch.empty((batch, 12, h, w), device="meta")
    t = torch.zeros((batch,), dtype=torch.long, device="meta")
    with torch.no_grad():
        unet(x, t)
    return sites


def measure(fn, iters: int = 20, host_calls: int = 50) -> dict:
    """Per call of ``fn``: ``event_ms`` (CUDA events around ``iters``
    back-to-back calls), ``host_us`` (wall time of ``host_calls`` calls
    issued without synchronizing, over their number, after the device is
    idle) and, from ``torch.profiler`` over ``iters`` calls,
    ``kernels_device_ms`` by kernel name, their sum ``device_ms`` and
    ``kernels_per_call``, over the calls the trace shows (a trace now and
    then drops events: the count of the kernel seen least often, which a
    call launches once; None when a trace holds no device events), and
    ``kernel_launches``, each kernel's count over the ``traced_calls``."""
    from torch.profiler import ProfilerActivity, profile

    from ldmseg_torch.tools.profile_int8_blocks import short_name
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
    row = {"event_ms": start.elapsed_time(end) / iters}
    t0 = time.perf_counter()
    for _ in range(host_calls):
        fn()
    row["host_us"] = (time.perf_counter() - t0) / host_calls * 1e6
    torch.cuda.synchronize()
    us, counts = {}, {}
    for _ in range(5):  # a trace now and then comes back without kernels
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                key = short_name(e.name)
                us[key] = us.get(key, 0.0) + e.time_range.elapsed_us()
                counts[key] = counts.get(key, 0) + 1
        if counts:
            break
    calls = min(counts.values()) if counts else None
    row["kernels_device_ms"] = {k: v / 1e3 / calls for k, v in
                                sorted(us.items(), key=lambda kv: -kv[1])}
    row["device_ms"] = sum(row["kernels_device_ms"].values()) if calls \
        else None
    row["kernels_per_call"] = sum(counts.values()) / calls if calls else None
    row["kernel_launches"], row["traced_calls"] = counts, iters
    return row


def gn_runs(x, scale, bias, w, b):
    """The three kernels' calls on one half's input (32 groups, eps 1e-5,
    as the UNet's resnet norms)."""
    from ldmseg_torch.ops import gn_silu_conv as GC
    from ldmseg_torch.ops import groupnorm_silu as GN
    return {"K5": lambda: GN.group_norm_silu(x, scale, bias, 32, 1e-5),
            "K6": lambda: GN.group_norm_silu_quant(x, scale, bias, 32, 1e-5),
            "K7": lambda: GC.gn_silu_conv(x, scale, bias, w, b, 32, 1e-5)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--kernels", default="K5,K6,K7")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_gn: no CUDA device", file=sys.stderr)
        return 1
    from ldmseg_torch.ops import gn_silu_conv as GC
    kids = args.kernels.split(",")
    gen = torch.Generator(device="cuda").manual_seed(3)
    classes = {}
    # no_grad, not inference_mode: K7 packs a weight once per version, and
    # an inference tensor keeps no version (it would pack at every call)
    with torch.no_grad():
        for shape, cout in site_shapes():
            c = shape[1]
            x = (torch.randn(shape, generator=gen, device="cuda") + 0.3).to(
                torch.bfloat16)
            scale = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
                     ).to(torch.bfloat16)
            bias = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(
                torch.bfloat16)
            w = (torch.randn((cout, c, 3, 3), generator=gen, device="cuda")
                 / (9 * c) ** 0.5).to(torch.bfloat16)
            b = torch.zeros(cout, device="cuda", dtype=torch.bfloat16)
            for kid, fn in gn_runs(x, scale, bias, w, b).items():
                if kid not in kids:
                    continue
                if kid == "K7":
                    before = GC.gn_silu_conv.fallbacks
                    fn()
                    if GC.gn_silu_conv.fallbacks != before:
                        continue  # the 6 MiB rule's fallback, not K7
                row = measure(fn, args.iters)
                key = (kid, c, shape[2] * shape[3])
                cls = classes.setdefault(key, {"halves": 0, "rows": []})
                cls["halves"] += 1
                cls["rows"].append(row)
    total = {}
    for (kid, c, hw), cls in classes.items():
        rows = cls["rows"]
        summed = {k: sum(r[k] for r in rows)
                  if all(r[k] is not None for r in rows) else None
                  for k in ("event_ms", "device_ms", "host_us")}
        kernels = {}
        for r in rows:
            for name, ms in r["kernels_device_ms"].items():
                kernels[name] = kernels.get(name, 0.0) + ms
        print(json.dumps({"kernel": kid, "channels": c, "pixels": hw,
                          "batch": 2, "halves": cls["halves"], **summed,
                          "kernels_per_call": rows[0]["kernels_per_call"],
                          "kernels_device_ms": kernels}), flush=True)
        acc = total.setdefault(kid, {"halves": 0, "event_ms": 0.0,
                                     "device_ms": 0.0, "host_us": 0.0,
                                     "kernels_device_ms": {}})
        acc["halves"] += cls["halves"]
        for k in ("event_ms", "device_ms", "host_us"):
            acc[k] = (None if acc[k] is None or summed[k] is None
                      else acc[k] + summed[k])
        for name, ms in kernels.items():
            acc["kernels_device_ms"][name] = (
                acc["kernels_device_ms"].get(name, 0.0) + ms)
    for acc in total.values():
        acc["host_us_per_call"] = (None if acc["host_us"] is None
                                   else acc["host_us"] / acc["halves"])
    print(json.dumps({"per_unet_forward": total,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
