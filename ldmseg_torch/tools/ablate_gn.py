"""What bounds K5 and K6 on the card: their device time at the UNet's 44
resnet norms with parts taken out.

    python -m ldmseg_torch.tools.ablate_gn [--iters N] [--variants a,b,...]

Builds copies of ``csrc/groupnorm_silu.cu`` with its header in which one
part of the cluster kernel is removed or changed by a textual edit (or the
plan changed), loads each with ``ctypes`` in place of the real library and
measures K5 and K6 at the 44 halves of one UNet forward (batch 2, 32x64
latent; ``tools/profile_gn.py``'s ``site_shapes`` and ``measure``), each
variant in a process of its own (each library carries its own CUDA
runtime). It prints one JSON line per variant: K5's and K6's device time
per forward, by kernel, and, for the unedited kernel, how many clusters of
1 to 8 CTAs the card holds at once (``cudaOccupancyMaxActiveClusters``). A
removed part gives wrong numbers; the variants only time. The variants:

* ``kernel``: the source as it is;
* ``without gn_silu's arithmetic``: y = x + mean·inv + scale + bias in
  place of ``gn_silu`` (the loads, sums, exchange and stores stay);
* ``without the cluster exchange``: each CTA takes its own sums, no
  cluster barrier, no distributed shared memory;
* ``more CTAs a span``: the plan raises k toward 8, as far as each thread
  keeps one 16-byte pack (the kernel as it is);
* ``64 values a thread``: a thread holds 64 values (k about halved).

An edit that no longer matches the source raises. Needs a CUDA device and
``nvcc``; the copies are built under ``ldmseg_torch/_build/ablate_gn/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ..ops import _build
from ..ops import groupnorm_silu as GN

SOURCE = "groupnorm_silu"

_NO_APPLY = [("      y[e] = gn_silu(to_f(p.v[e]), mean, inv, sc, bi);",
              "      y[e] = to_f(p.v[e]) + mean * inv + sc + bi;")]
_NO_EXCHANGE = [
    ("  if (k == 1) {\n    __syncthreads();",
     "  if (true) {\n    __syncthreads();"),
    ("  } else {\n    cluster_arrive();\n    cluster_wait();",
     "  } else if (false) {\n    cluster_arrive();\n    cluster_wait();"),
    ("  if (k > 1) cluster_wait();", "")]
_VALUES_64 = [("constexpr int kValues = 32;", "constexpr int kValues = 64;")]
# the occupancy of the cluster kernel, appended to the unedited copy
_OCCUPANCY = '''
extern "C" int ldmseg_gn_max_clusters(int k) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k);
  cfg.blockDim = dim3(kThreads);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, gn_cluster_kernel<__nv_bfloat16, __nv_bfloat16, 8, false>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
'''

# variant -> (source edits, plan option)
VARIANTS = {
    "kernel": ([], None),
    "without gn_silu's arithmetic": (_NO_APPLY, None),
    "without the cluster exchange": (_NO_EXCHANGE, None),
    "more CTAs a span": ([], "more"),
    "64 values a thread": (_VALUES_64, "values64"),
}


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablation edit no longer matches: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(names=None) -> dict:
    """One directory per variant with the edited copies, every copy
    compiled at once; returns the library path of each variant."""
    root = _build.BUILD_DIR / "ablate_gn"
    nvcc = _build._nvcc()
    procs, libs = [], {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        if names is not None and name not in names:
            continue
        out = root / f"variant{i}"
        out.mkdir(parents=True, exist_ok=True)
        for path in _build.CSRC.glob("*.cuh"):
            (out / path.name).write_text(path.read_text())
        text = _edit((_build.CSRC / f"{SOURCE}.cu").read_text(), edits)
        if name == "kernel":
            text += _OCCUPANCY
        (out / f"{SOURCE}.cu").write_text(text)
        libs[name] = out / f"lib{SOURCE}.so"
        procs.append((name, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(libs[name]),
             str(out / f"{SOURCE}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
    return libs


def _plan_option(option):
    """The plan of the variant (``GN.sm90_gn_plan`` replaced)."""
    if option is None:
        return
    plan = GN.sm90_gn_plan
    if option == "values64":
        GN.VALUES = 64
        return

    def more(b, c, hw, groups, dtype=torch.bfloat16, aligned=True):
        p = plan(b, c, hw, groups, dtype, aligned)
        k = max(p.cluster, min(GN.MAX_CLUSTER,
                               p.span // (GN.THREADS * p.vec)))
        while True:
            per = -(-p.span // k)
            per = -(-per // p.vec) * p.vec
            if k == 1 or (k - 1) * per < p.span:
                break
            k -= 1
        return GN.GNPlan(span=p.span, spans=p.spans, vec=p.vec, cluster=k,
                         per_cta=per, rounds=p.rounds)
    GN.sm90_gn_plan = more


def run_variant(name: str, lib: str, iters: int) -> dict:
    """K5's and K6's device time per forward under the variant."""
    from .profile_gn import measure, site_shapes
    _build._loaded[SOURCE] = ctypes.CDLL(lib)
    _plan_option(VARIANTS[name][1])
    row = {"variant": name, "device": torch.cuda.get_device_name(0)}
    if name == "kernel":
        query = _build._loaded[SOURCE].ldmseg_gn_max_clusters
        row["max_active_clusters"] = {k: query(k) for k in range(1, 9)}
    gen = torch.Generator(device="cuda").manual_seed(3)
    total = {"K5": {}, "K6": {}}
    with torch.inference_mode():
        for shape, _ in site_shapes():
            c = shape[1]
            x = (torch.randn(shape, generator=gen, device="cuda") + 0.3).to(
                torch.bfloat16)
            sc = (1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
                  ).to(torch.bfloat16)
            bi = (0.1 * torch.randn(c, generator=gen, device="cuda")).to(
                torch.bfloat16)
            for kid, fn in (
                    ("K5", lambda: GN.group_norm_silu(x, sc, bi, 32, 1e-5)),
                    ("K6", lambda: GN.group_norm_silu_quant(x, sc, bi, 32,
                                                            1e-5))):
                m = measure(fn, iters)
                for k, v in m["kernels_device_ms"].items():
                    total[kid][k] = total[kid].get(k, 0.0) + v
    row["per_unet_forward_device_ms"] = {
        kid: sum(v.values()) for kid, v in total.items()}
    row["by_kernel_per_unet_forward_ms"] = total
    return row


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--variants", default=None,
                        help="comma-separated variant names (default all)")
    parser.add_argument("--run", help=argparse.SUPPRESS)  # one variant
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gn: needs a CUDA device")
    if args.run is not None:
        spec = json.loads(args.run)
        print(json.dumps(run_variant(spec["name"], spec["lib"], args.iters)),
              flush=True)
        return 0
    names = None if args.variants is None else args.variants.split(",")
    for name, lib in build_variants(names).items():
        proc = subprocess.run(
            [sys.executable, "-m", "ldmseg_torch.tools.ablate_gn",
             "--iters", str(args.iters),
             "--run", json.dumps({"name": name, "lib": str(lib)})],
            capture_output=True, text=True)
        if proc.returncode:
            print(json.dumps({"variant": name, "failed": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            continue
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
