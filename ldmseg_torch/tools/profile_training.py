"""Where the time of the training path goes on the card.

    python -m ldmseg_torch.tools.profile_training [--gn] [--packed] [--absorbed]

Builds the deployment ``chip_smoke.py`` trains (SD-1.4 UNet with
self-conditioning, DEFAULT_CONFIG seg VAE, bf16 compute on fp32 masters,
AdamW, batch 8 of 192x640 ``SyntheticDVPS`` frames) with seeded random
weights and traces, with ``torch.profiler``, 3 ``train_step`` calls on one
loaded batch. It prints one JSON line: wall time, device time summed over
kernels, the device's busy share (the union of kernel intervals over the
wall time), device time by kernel family (K1, K2, convolutions, optimizer,
...), the top kernels, and the device time split by the host thread that
launched it. Autograd runs the backward on a thread of its own, so that
split separates the backward (the thread that launches K2) from the rest of
the step (encode, casts, the self-conditioning pass, the forward, the loss
and the optimizer, on the caller's thread). ``--gn`` builds the UNet with
``UNetConfig.use_pallas_gn``: the resnets' GN + SiLU pairs on K5 (the
backward recomputes them in plain PyTorch). ``--packed`` builds it with
``UNetConfig.use_packed_attention``: the self-attention on K14 with K2 as
its backward (the mid block's T = 30 on the float fallback). ``--absorbed``
builds it with ``UNetConfig.use_absorbed_attention``: the self-attention
with its projections on K16, K2 in its backward (T = 30 on the fallback).

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .profile_sampling import _family, _kernels, _profile, unet_config_for

STEPS = 3


def _by_thread(prof, per: int) -> dict:
    """Device ms by launching thread. A kernel shares its correlation id
    with the runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...)
    that launched it, and that call's event carries the thread."""
    cpu = torch.autograd.DeviceType.CPU
    thread_of = {e.id: e.thread for e in prof.events()
                 if e.device_type == cpu and e.name.startswith("cu")}
    kernels = _kernels(prof)
    backward = {thread_of.get(e.id) for e in kernels
                if _family(e.name).startswith("K2")} - {None}
    groups = {"backward": {}, "rest of the step": {}, "unattributed": {}}
    for e in kernels:
        tid = thread_of.get(e.id)
        group = ("unattributed" if tid is None else
                 "backward" if tid in backward else "rest of the step")
        fam = _family(e.name)
        groups[group][fam] = (groups[group].get(fam, 0.0)
                              + e.time_range.elapsed_us())
    return {"by_launching_thread_ms": {
        group: {"total": sum(fams.values()) / 1e3 / per,
                "families": {k: v / 1e3 / per for k, v in sorted(
                    fams.items(), key=lambda kv: -kv[1])}}
        for group, fams in groups.items()}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gn", action="store_true",
                        help="UNetConfig.use_pallas_gn (K5)")
    parser.add_argument("--packed", action="store_true",
                        help="UNetConfig.use_packed_attention (K14)")
    parser.add_argument("--absorbed", action="store_true",
                        help="UNetConfig.use_absorbed_attention (K16)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 1
    from ..data.loader import Loader
    from ..data.synthetic import SyntheticDVPS
    from ..train.trainer_ldm import TrainerDiffusion
    from ..utils.config import DEFAULT_CONFIG, merge_dicts

    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True, "weight_dtype": "bfloat16",
                         "batch_size": 8},
        "ignore_label": 0})
    ds = SyntheticDVPS(length=8, size=(192, 640), num_bits=8)
    trainer = TrainerDiffusion(cfg, unet_config=unet_config_for(
        gn=args.gn, packed=args.packed, absorbed=args.absorbed), dataset=ds)
    trainer.init_params(seed=0)
    batch = next(iter(Loader(ds, 8, seed=0)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps(_profile(
        lambda: trainer.train_step(batch, generator=gen), STEPS,
        "train_step, bf16 on fp32 masters, batch 8 x 192x640, one loaded "
        "batch" + (", GN on K5" if args.gn else "")
        + (", packed attention" if args.packed else "")
        + (", absorbed attention" if args.absorbed else ""),
        extra=_by_thread)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
