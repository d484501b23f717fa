"""What bounds K1's bf16 kernel on the card: its time with parts taken out.

    python -m ldmseg_torch.tools.ablate_attention_fwd [--iters N] [--k16]

Builds copies of ``csrc/attention_fwd.cu`` with one part of the bf16 kernel
(``attention_fwd_kernel_sm90``, the skeleton of ``csrc/attention_sm90.cuh``)
removed by a textual edit of the header, loads each with
``ctypes`` in place of the real library, and prints one JSON line: the
kernel's device time per launch (``torch.profiler``) for each variant at
the sampling path's (2, 2048, 8, 40) and the training path's
(8, 1920, 8, 40), with its max abs error against the plain version (a
removed part gives wrong numbers; the error only shows that the variant
ran). The variants:

* ``kernel``: the source as it is;
* ``no loads``: the producer arrives on each full barrier without a copy
  (compute and synchronisation only, on whatever shared memory holds);
* ``loads only``: the consumers wait for each tile and release it (the TMA
  stream and the ring's handshakes alone);
* ``no exponentials``: ``ex2`` returns its argument;
* ``no products``: no ``wgmma`` is issued (fences and waits stay);
* ``skeleton``: no loads, exponentials, products, row statistics or
  probabilities: the loop, the barriers and the ring's bookkeeping.

With ``--k16`` it times K16's bf16 call (``ldmseg_attention_absorbed``:
its Q/K/V product, K1's kernel, ``to_out``) in two forms of
``csrc/attention_fwd.cu`` instead, device time per call summed over its
kernels at the four shapes of the sampling forward (batch 2, 32x64 latent,
8 heads) and per UNet forward (16 calls):

* ``one launch``: the source as it is, Q, K and V in one launch of the
  Hopper product over three weight maps;
* ``three launches``: one launch per projection (a textual edit of the
  source), each over the plan's column tiles of its weight.

An edit that no longer matches the source raises. Needs a CUDA device and
``nvcc``; the copies are built under ``ldmseg_torch/_build/ablate/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess

import torch

from ..ops import _build
from ..ops import attention as A
from .profile_sampling import _kernels

SHAPES = [(2, 2048, 8, 40), (8, 1920, 8, 40)]
# (B, T, C) of K16's calls in one UNet forward, with the calls of each
K16_SHAPES = [((2, 2048, 320), 5), ((2, 512, 640), 5), ((2, 128, 1280), 5),
              ((2, 32, 1280), 1)]
# K16's Q/K/V as three launches of one weight map each, over the plan's
# column tiles of one weight
_K16_THREE_LAUNCHES = [(
    "  int err = gemm90::launch_gemm_in_context<false, 3, false>(\n"
    "      plans + gemm90::kPlanInts, x, w, rows, 3 * c, c, 0, 1,\n"
    "      StoreBf16Epi{q, k, v, c}, stream);\n",
    "  int plan1[gemm90::kPlanInts];\n"
    "  for (int i = 0; i < gemm90::kPlanInts; ++i) {\n"
    "    plan1[i] = plans[gemm90::kPlanInts + i];\n"
    "  }\n"
    "  plan1[gemm90::kPlanInts - 1] /= 3;\n"
    "  int err = 0;\n"
    "  for (int i = 0; i < 3 && err == 0; ++i) {\n"
    "    auto* dst = static_cast<__nv_bfloat16*>(qkvo[i]);\n"
    "    err = gemm90::launch_gemm_in_context<false, 1, false>(\n"
    "        plan1, x, &w[i], rows, c, c, 0, 1,\n"
    "        StoreBf16Epi{dst, dst, dst, c}, stream);\n"
    "  }\n")]

_NO_LOADS = [
    ("sm90::tma_load_4d(", "if (pass < 0) sm90::tma_load_4d("),
    ("sm90::mbar_expect_tx(q_bar, kWG * C::kQSub);",
     "int pass = 0; sm90::mbar_arrive(q_bar);"),
    ("sm90::mbar_expect_tx(full_bar + 8 * s,\n"
     "                               C::kKTile + (pass == 1 ? C::kVTile : 0));",
     "sm90::mbar_arrive(full_bar + 8 * s);"),
]
_NO_EXP = [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            "y = x;")]
_NO_PRODUCTS = [
    ("      sm90::WgmmaK<C::kS8, C::kBK>::ss(\n",
     "      if (kk < 0) sm90::WgmmaK<C::kS8, C::kBK>::ss(\n"),
    ("      sm90::WgmmaRs<kDN>::rs(\n",
     "      if (kk < 0) sm90::WgmmaRs<kDN>::rs(\n"),
]
_NO_SOFTMAX = [
    ("Score (&m)[2],\n                        float (&l)[2]) const {\n",
     "Score (&m)[2],\n                        float (&l)[2]) const {\n"
     "    if (kt >= 0) { m[0] = m[1] = 0.f; l[0] += s[0]; l[1] += s[1];"
     " return; }\n"),
    ("                        const float (&r)[2]) const {\n",
     "                        const float (&r)[2]) const {\n"
     "    if (kt >= 0) return;\n"),
]
_PASSES = ("    // pass 1: the row statistics;",
           "    // O rounded to bf16 once;")
_LOADS_ONLY_BODY = """    float acc[kDN / 2];
    for (int i = 0; i < kDN / 2; ++i) acc[i] = 0.f;
    for (int n = 0; n < 2 * ntiles; ++n) {
      sm90::mbar_wait(full_bar + 8 * cons.load.stage, cons.load.phase);
      cons.load.next(stages);
      cons.release();
    }
"""


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablation edit no longer matches: {old!r}")
        src = src.replace(old, new)
    return src


def _loads_only(src: str) -> str:
    begin, end = (src.index(marker) for marker in _PASSES)
    return src[:begin] + _LOADS_ONLY_BODY + src[end:]


def variants(src: str) -> dict:
    """The ablated sources by name."""
    return {
        "kernel": src,
        "no loads": _edit(src, _NO_LOADS),
        "loads only": _loads_only(src),
        "no exponentials": _edit(src, _NO_EXP),
        "no products": _edit(src, _NO_PRODUCTS),
        "skeleton": _edit(src, _NO_LOADS + _NO_EXP + _NO_PRODUCTS
                          + _NO_SOFTMAX),
    }


def _build_all(sources: dict, edited: str, target: str,
               subdir: str = "ablate") -> dict:
    """One ``nvcc`` per variant of ``csrc/<target>``, all at once, each in
    a directory of its own under ``_build/<subdir>`` with copies of the
    headers and of ``target``, the variant's text in place of ``edited``
    (the target or one of its headers); returns the library path of
    each."""
    nvcc = _build._nvcc()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        out = _build.BUILD_DIR / subdir / f"variant{i}"
        out.mkdir(parents=True, exist_ok=True)
        for path in [*_build.CSRC.glob("*.cuh"), _build.CSRC / target]:
            shutil.copy(path, out)
        (out / edited).write_text(text)
        lib = out / "libvariant.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(out / target)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        libs[name] = lib
    return libs


def _device_ms(fn, iters: int, per_call: bool = False) -> float:
    """K1's kernel's device time per launch, or (``per_call``) every
    kernel's per call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in _kernels(prof)
             if per_call or "attention_fwd_kernel_sm90" in e.name]
    if not times:
        return float("nan")
    return sum(times) / (iters if per_call else len(times)) / 1e3


def k16_variants(src: str) -> dict:
    """``csrc/attention_fwd.cu`` in K16's two forms by name."""
    return {"one launch": src,
            "three launches": _edit(src, _K16_THREE_LAUNCHES)}


def ablate_k16(iters: int) -> dict:
    """K16's device time per call and per UNet forward in each form of
    :func:`k16_variants`, with its max abs error against the plain
    version."""
    from ..ops import gemm as G
    libs = _build_all(k16_variants((_build.CSRC / "attention_fwd.cu")
                                   .read_text()),
                      "attention_fwd.cu", "attention_fwd.cu", "ablate_k16")
    gen = torch.Generator(device="cuda").manual_seed(0)
    argtypes = A._absorbed_kernel().argtypes
    dev = torch.cuda.current_device()
    result = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).ldmseg_attention_absorbed
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        rows, per_forward = {}, 0.0
        for (b, t, c), calls in K16_SHAPES:
            x = torch.randn((b, t, c), generator=gen, device="cuda").to(
                torch.bfloat16)
            ws = [(0.05 * torch.randn((c, c), generator=gen, device="cuda"))
                  .to(torch.bfloat16) for _ in range(4)]
            bufs = [torch.empty_like(x) for _ in range(5)]
            scale = (c // 8) ** -0.5
            plans = G.plans_c(*A.absorbed_plans(b, t, c, 8))

            def launch():
                err = fn(1, dev, x.data_ptr(), *(w.data_ptr() for w in ws),
                         *(z.data_ptr() for z in bufs), b, t, c, 8, scale,
                         plans, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            launch()
            ref = A.absorbed_attention_reference(x, *ws, 8, scale)
            ms = _device_ms(launch, iters, per_call=True)
            per_forward += ms * calls
            rows[str((b, t, c))] = {
                "device_ms": ms, "calls_per_unet_forward": calls,
                "max_abs_err": (bufs[4].float() - ref.float()).abs().max()
                .item()}
        result[name] = {"shapes": rows,
                        "device_ms_per_unet_forward": per_forward}
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--k16", action="store_true",
                        help="K16's one-launch and three-launch Q/K/V")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_attention_fwd: needs a CUDA device")
    if args.k16:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "k16": ablate_k16(args.iters)}), flush=True)
        return 0
    libs = _build_all(
        variants((_build.CSRC / "attention_sm90.cuh").read_text()),
        "attention_sm90.cuh", "attention_fwd.cu")
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {s: [torch.randn(s, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(3)] for s in SHAPES}
    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    argtypes = A._forward_kernel().argtypes
    for name, lib in libs.items():
        fn = ctypes.CDLL(str(lib)).ldmseg_attention_fwd
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        rows = {}
        for shape, (q, k, v) in inputs.items():
            out = torch.empty_like(q)
            b, t, h, d = shape
            launch_args = (1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b, t, h, d,
                           A._strides(q, k, v, out), d ** -0.5,
                           A._plan_c(b * h, t, d),
                           torch.cuda.current_stream().cuda_stream)

            def launch():
                err = fn(*launch_args)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            launch()
            ref = A.attention_reference(q, k, v, d ** -0.5)
            rows[str(shape)] = {
                "device_ms": _device_ms(launch, args.iters),
                "max_abs_err": (out.float() - ref.float()).abs().max().item()}
        result["variants"][name] = rows
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
