"""K9's ``proj_out`` product under every tile and ring depth, on the card.

    python -m ldmseg_torch.tools.sweep_pout [--iters 20]

At each (B, T, C) of K9's launches in one fused-projs int8 forward (batch
2, 32x64 latent; ``profile_int8_blocks.SHAPES``) it builds K9's pack from a
transformer block's seeded float modules and a seeded 1x1 ``proj_out``,
then, for each tile of ``ops/gemm.py:TILES`` and each ring of 2, 3, 4, 6
and 8 stages that fits, runs K9 with that plan in place of
``ops/geglu.py:pout_plan``'s and prints one JSON line: the plan, the
``proj_out`` kernel's device time per call from ``torch.profiler``
(``profile_int8_blocks.stages``), and K9's max |err| against its plain
version. The last line names, per shape, the fastest plan and the one
``pout_plan`` picks. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch


def _pack(b, t, c):
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.tools.profile_int8_blocks import block_modules
    _, _, norm3, ff = block_modules(c, seed=t + c)
    conv = torch.nn.Conv2d(c, c, 1).to("cuda")
    with torch.no_grad():
        init_random_(conv, torch.Generator(device="cuda").manual_seed(c + 1))
    return G.with_proj_out(G.pack_geglu(norm3, ff.net[0].proj, ff.net[2],
                                        0.05), conv)


def main() -> int:
    from ldmseg_torch.ops import gemm as GM
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.tools.profile_int8_blocks import SHAPES, stages
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sweep_pout: no CUDA device", file=sys.stderr)
        return 1
    chosen_rule, best = G.pout_plan, {}
    try:
        for (b, t, c), _ in SHAPES:
            p = _pack(b, t, c)
            x = torch.randn((b, t, c), device="cuda").to(torch.bfloat16)
            ref = G.geglu_ln_s8_pout_reference(x, p).float()
            rule = chosen_rule(b, t, c)
            for tile in GM.TILES:
                for st in (2, 3, 4, 6, 8):
                    smem = GM.gemm_smem_bytes(*tile, 1, st)
                    if smem > GM.SM90_SMEM_LIMIT:
                        continue
                    plan = GM.GemmPlan(1, *tile, 1, st, -(-c // 64), smem,
                                       GM.gemm_grid(c, b * t, *tile))
                    G.pout_plan = lambda *_a, plan=plan: plan
                    G._plans_c.cache_clear()
                    with torch.inference_mode():
                        err = (G.geglu_ln_s8_pout(x, p).float() - ref).abs()
                        row = stages(lambda: G.geglu_ln_s8_pout(x, p),
                                     args.iters)
                    us = 1e3 * sum(v for k, v in
                                   row["stages_device_ms"].items()
                                   if "ProjOutEpi" in k)
                    out = {"shape_btc": [b, t, c], "tile": list(tile),
                           "stages": st, "grid": list(plan.grid),
                           "smem_bytes": smem, "proj_out_us": us,
                           "max_abs_err": err.max().item(),
                           "rule": (tuple(tile), st) == (
                               (rule.block_m, rule.block_n), rule.stages)}
                    print(json.dumps(out), flush=True)
                    key = f"{b}x{t}x{c}"
                    if out["rule"]:
                        best.setdefault(key, {})["rule"] = out
                    if us and us < best.setdefault(key, {}).get(
                            "fastest", {}).get("proj_out_us", float("inf")):
                        best[key]["fastest"] = out
    finally:
        G.pout_plan = chosen_rule
        G._plans_c.cache_clear()
    print(json.dumps({"per_shape": best,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
