"""What bounds K2's bf16 kernels on the card: their time with parts taken
out.

    python -m ldmseg_torch.tools.ablate_attention_bwd [--iters N]

Builds copies of ``csrc/attention_bwd.cu`` with one part of the main
kernel (``attention_bwd_main_kernel``) removed by a textual edit, loads
each with ``ctypes`` in place of the real library, and prints one JSON
line: the device time per launch (``torch.profiler``) of the stats kernel
and of the main kernel for each variant at the training path's three
largest shapes, with the max abs error of dQ against the plain version (a
removed part gives wrong numbers; the error only shows that the variant
ran). The variants:

* ``kernel``: the source as it is;
* ``no exponentials``: ``ex2`` returns its argument (both kernels);
* ``no products``: the main kernel issues no ``wgmma`` (fences, waits,
  the softmax algebra and the dQ hand-offs stay);
* ``no dQ write``: the consumers write nothing into the block's dQ tile
  (its hand-offs, the reducers' bulk adds and the conversion stay);
* ``no dQ sum``: the reducers' bulk stores and adds move 16 bytes instead
  of a 64 x D tile (the ordered turns stay).

An edit that no longer matches the source raises. Needs a CUDA device and
``nvcc``; the copies are built under ``ldmseg_torch/_build/ablate_bwd/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from ..ops import _build
from ..ops import attention as A
from .ablate_attention_fwd import _build_all, _edit
from .profile_sampling import _kernels

SHAPES = [(8, 1920, 8, 40), (8, 480, 8, 80), (8, 120, 8, 160)]

_NO_EXP = [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
            "y = x;")]
_NO_PRODUCTS = [
    ("      sm90::WgmmaSs<64>::ss(s, ",
     "      if (kk < 0) sm90::WgmmaSs<64>::ss(s, "),
    ("      sm90::WgmmaSs<64>::ss(dp, ",
     "      if (kk < 0) sm90::WgmmaSs<64>::ss(dp, "),
    ("      sm90::WgmmaRs<kDN>::rs(dv, ",
     "      if (kk < 0) sm90::WgmmaRs<kDN>::rs(dv, "),
    ("      sm90::WgmmaRs<kDN>::rs(dk, ",
     "      if (kk < 0) sm90::WgmmaRs<kDN>::rs(dk, "),
    ("        sm90::WgmmaSsT<kN>::ss(acc, ",
     "        if (kk < 0) sm90::WgmmaSsT<kN>::ss(acc, "),
]
_NO_DQ_WRITE = [("      const int col = col0 + 8 * j + 2 * (lane % 4);\n"
                 "      if (col >= d) continue;",
                 "      const int col = col0 + 8 * j + 2 * (lane % 4);\n"
                 "      if (col >= 0) continue;")]
_NO_DQ_SUM = [("sm90::bulk_store<false>(dst, src, 4 * tile_floats);",
               "sm90::bulk_store<false>(dst, src, 16);"),
              ("sm90::bulk_store<true>(dst, src + w * C::kDqBytes,\n"
               "                                   4 * tile_floats);",
               "sm90::bulk_store<true>(dst, src + w * C::kDqBytes, 16);")]


def variants(src: str) -> dict:
    """The ablated sources by name."""
    return {
        "kernel": src,
        "no exponentials": _edit(src, _NO_EXP),
        "no products": _edit(src, _NO_PRODUCTS),
        "no dQ write": _edit(src, _NO_DQ_WRITE),
        "no dQ sum": _edit(src, _NO_DQ_SUM),
    }


def _device_ms(fn, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for part in ("stats", "main"):
        times = [e.time_range.elapsed_us() for e in _kernels(prof)
                 if f"attention_bwd_{part}_kernel" in e.name]
        out[f"{part}_device_ms"] = (sum(times) / len(times) / 1e3 if times
                                    else float("nan"))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_attention_bwd: needs a CUDA device")
    libs = _build_all(variants((_build.CSRC / "attention_bwd.cu").read_text()),
                      "attention_bwd.cu", "attention_bwd.cu", "ablate_bwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {s: [torch.randn(s, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4)] for s in SHAPES}
    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    real = A._backward_kernel
    try:
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).ldmseg_attention_bwd
            fn.argtypes, fn.restype = real().argtypes, ctypes.c_int
            A._backward_kernel = lambda fn=fn: fn
            rows = {}
            for shape, (q, k, v, do) in inputs.items():
                scale = shape[3] ** -0.5

                def launch():
                    return A.fused_self_attention_backward(q, k, v, do, scale)

                dq = launch()[0]
                ref = A.attention_backward_reference(q, k, v, do, scale)[0]
                rows[str(shape)] = {
                    **_device_ms(launch, args.iters),
                    "max_abs_err_dq": (dq.float() - ref.float()).abs().max()
                    .item()}
            result["variants"][name] = rows
    finally:
        A._backward_kernel = real
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
