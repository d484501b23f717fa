"""What bounds the int8 blocks on the card: their stages' times with parts
taken out.

    python -m ldmseg_torch.tools.ablate_int8_blocks [--iters N]
        [--blocks K3,K4,K13,K15,K11,K17] [--variants a,b,...]

Builds copies of ``csrc/attention_ln_s8.cu``, ``csrc/geglu_ln_s8.cu`` and
``csrc/attention_s8.cu``, with their headers, in which one part of the
Hopper product (``csrc/gemm_sm90.cuh``) or of the attention stage
(``csrc/attention_sm90.cuh``: K3's, and K13's with the s8 e8·V product that
K15, K11 and K17 run too) is removed by a textual edit; loads them with
``ctypes`` in place of the real libraries and traces the blocks (K4 with
its dynamic interior scale) at the four shapes of the int8 UNet forward
with ``tools/profile_int8_blocks.py``'s ``stages``, each variant in a
process of its own (each library carries its own CUDA runtime). It prints
one JSON line per variant: each shape's device time per call by kernel,
the sum by stage per UNet forward, and the sum per UNet forward. A removed
part gives wrong numbers; the variants only time. The variants:

* ``kernel``: the sources as they are;
* ``products without epilogue``: the product returns after its last
  ``wgmma``, before the epilogue;
* ``products without wgmma``: no ``wgmma`` is issued in the product
  (loads, ring and epilogue stay);
* ``products without loads``: the product's producer arrives on each full
  barrier without a copy;
* ``gating without exp and division``: K4's gate is ``uh * ug + z``;
* ``attention without exponentials``: ``ex2`` returns its argument (K3's
  and K13's stage);
* ``attention without products``: K3's attention issues no ``wgmma``;
* ``s8 attention without e8 V``: K13's stage issues no e8·V ``wgmma``;
* ``s8 attention without epilogue``: K13's stage returns before its
  epilogue (no O stored, no amax).

An edit that no longer matches the source raises. Needs a CUDA device and
``nvcc``; the copies are built under ``ldmseg_torch/_build/ablate_int8/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _build
from .profile_int8_blocks import SHAPES, block_modules, stages

SOURCES = ("attention_ln_s8", "geglu_ln_s8", "attention_s8")

_NO_EPILOGUE = [("  sm90::bar_sync(1, 128 * kWG);  // the per-column vectors",
                 "  if (k_tiles > 0) return;\n"
                 "  sm90::bar_sync(1, 128 * kWG);  // the per-column vectors")]
_NO_WGMMA = [("        sm90::WgmmaK<kS8, kBN>::ss(\n",
              "        if (kk < 0) sm90::WgmmaK<kS8, kBN>::ss(\n")]
_NO_LOADS = [("sm90::mbar_expect_tx(full_bar + 8 * s, kStage);",
              "sm90::mbar_arrive(full_bar + 8 * s);"),
             ("sm90::tma_load_2d(", "if (kt < 0) sm90::tma_load_2d(")]
_NO_GATE = [("    return uh * (ug / (1.f + expf(-2.f * z)));",
             "    return uh * ug + z;")]
_NO_EXP = [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            "y = x;")]
_NO_ATTN_PRODUCTS = [
    ("      sm90::WgmmaK<C::kS8, C::kBK>::ss(\n",
     "      if (kk < 0) sm90::WgmmaK<C::kS8, C::kBK>::ss(\n"),
    ("      sm90::WgmmaRs<kDN>::rs(\n",
     "      if (kk < 0) sm90::WgmmaRs<kDN>::rs(\n"),
]

_NO_PV8 = [("      sm90::WgmmaRsS8<kDN>::rs(acc, &p[4 * kk],",
            "      if (kk < 0) sm90::WgmmaRsS8<kDN>::rs(acc, &p[4 * kk],")]
_NO_PV8_EPILOGUE = [
    ("      // the epilogue on rows < t, columns < d: f = out / l once per row (a",
     "      if (t > 0) return;\n"
     "      // the epilogue on rows < t, columns < d: f = out / l once per row (a")]

# variant -> (file -> edits)
VARIANTS = {
    "kernel": {},
    "products without epilogue": {"gemm_sm90.cuh": _NO_EPILOGUE},
    "products without wgmma": {"gemm_sm90.cuh": _NO_WGMMA},
    "products without loads": {"gemm_sm90.cuh": _NO_LOADS},
    "gating without exp and division": {"geglu_ln_s8.cu": _NO_GATE},
    "attention without exponentials": {"attention_sm90.cuh": _NO_EXP},
    "attention without products": {"attention_sm90.cuh": _NO_ATTN_PRODUCTS},
    "s8 attention without e8 V": {"attention_sm90.cuh": _NO_PV8},
    "s8 attention without epilogue": {"attention_sm90.cuh": _NO_PV8_EPILOGUE},
}


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablation edit no longer matches: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(names=None) -> dict:
    """One directory per variant with the edited copies of the headers
    and the two sources, every source compiled at once; returns, per
    variant, the library path of each source."""
    root = _build.BUILD_DIR / "ablate_int8"
    nvcc = _build._nvcc()
    procs, libs = [], {}
    for i, (name, files) in enumerate(VARIANTS.items()):
        if names is not None and name not in names:
            continue
        out = root / f"variant{i}"
        out.mkdir(parents=True, exist_ok=True)
        for path in [*_build.CSRC.glob("*.cuh"),
                     *(_build.CSRC / f"{s}.cu" for s in SOURCES)]:
            text = path.read_text()
            (out / path.name).write_text(_edit(text, files.get(path.name,
                                                               [])))
        libs[name] = {}
        for src in SOURCES:
            lib = out / f"lib{src}.so"
            libs[name][src] = lib
            procs.append((name, lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS.get(src, ()),
                 "-o", str(lib),
                 str(out / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r} ({lib.name}):\n"
                               f"{log}")
    return libs


def _use(libs: dict):
    """Route the wrappers to the variant's libraries (before any launch)."""
    for src, lib in libs.items():
        _build._loaded[src] = ctypes.CDLL(str(lib))


def run_variant(name: str, libs: dict, iters: int, blocks) -> dict:
    """The variant's stages at every shape for each of ``blocks``."""
    from .profile_int8_blocks import block_runs, by_stage
    _use(libs)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows, total, split = {}, {}, {}
    with torch.inference_mode():
        for (b, t, c), per_fwd in SHAPES:
            mods = block_modules(c, seed=t + c)
            x = torch.randn((b, t, c), generator=gen, device="cuda").to(
                torch.bfloat16)
            for kid in blocks:
                runs = block_runs(kid, x, mods)
                label, fn = next(iter(runs.items()))   # K4: dynamic scale
                row = stages(fn, iters)
                rows[f"{label} {[b, t, c]}"] = row["stages_device_ms"]
                if isinstance(row["device_ms"], float):
                    total[label] = (total.get(label, 0.0)
                                    + row["device_ms"] * per_fwd)
                    acc = split.setdefault(label, {})
                    for k, v in by_stage(kid,
                                         row["stages_device_ms"]).items():
                        acc[k] = acc.get(k, 0.0) + v * per_fwd
    return {"variant": name, "per_unet_forward_device_ms": total,
            "by_stage_per_unet_forward_ms": split,
            "stages_device_ms": rows,
            "device": torch.cuda.get_device_name(0)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--blocks", default="K3,K4",
                        help="comma-separated blocks (profile_int8_blocks)")
    parser.add_argument("--variants", default=None,
                        help="comma-separated variant names (default all)")
    parser.add_argument("--run", help=argparse.SUPPRESS)  # one variant
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_int8_blocks: needs a CUDA device")
    if args.run is not None:
        spec = json.loads(args.run)
        print(json.dumps(run_variant(spec["name"], spec["libs"],
                                     args.iters, args.blocks.split(","))),
              flush=True)
        return 0
    names = None if args.variants is None else args.variants.split(",")
    for name, libs in build_variants(names).items():
        spec = json.dumps({"name": name,
                           "libs": {k: str(v) for k, v in libs.items()}})
        proc = subprocess.run(
            [sys.executable, "-m", "ldmseg_torch.tools.ablate_int8_blocks",
             "--iters", str(args.iters), "--blocks", args.blocks,
             "--run", spec],
            capture_output=True, text=True)
        if proc.returncode:
            print(json.dumps({"variant": name, "failed": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            continue
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
