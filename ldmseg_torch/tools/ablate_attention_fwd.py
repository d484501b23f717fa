"""What bounds K1's bf16 kernel on the card: its time with parts taken out.

    python -m ldmseg_torch.tools.ablate_attention_fwd [--iters N]

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


def _device_ms(fn, iters: int) -> float:
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
             if "attention_fwd_kernel_sm90" in e.name]
    return sum(times) / len(times) / 1e3 if times else float("nan")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_attention_fwd: needs a CUDA device")
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
