"""Where the time of the training path goes on the card.

    python -m ldmseg_torch.tools.profile_training [--gn] [--packed] [--absorbed]
    python -m ldmseg_torch.tools.profile_training --remat-sweep [--batch 16]
        [--iters 5]

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

``--remat-sweep`` (the JAX package's ``tools/perf/remat_sweep.py``) times
the bare UNet step at batch ``--batch`` of 32x64 latents under each
rematerialisation setting: full remat (``gradient_checkpointing`` with
``remat_policy`` None), remat keeping the weight products
(``dots_with_no_batch_dims_saveable``, :data:`~..models.unet.REMAT_POLICIES`)
and no remat. The step is JAX's: the SD-1.4 UNet with 8 input channels on
K1 (its backward K2), bf16 parameters, noise at a random timestep, the MSE
against it, the port's AdamW (``train/optim.py``) at lr 1e-4. One warm-up
step, then ``--iters`` timed steps (host clock ending in
``torch.cuda.synchronize()``); it prints one JSON line with each setting's
samples/s and peak device memory. A setting that runs out of device memory
is reported as such and the sweep goes on.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc as gc_module
import json
import sys
import time

import torch

from .profile_sampling import _family, _kernels, _profile, unet_config_for

STEPS = 3
# (name, gradient_checkpointing, remat_policy): JAX's remat_sweep.py:75-77
REMAT_SETTINGS = (("full-remat", True, None),
                  ("remat-dots-saved", True,
                   "dots_with_no_batch_dims_saveable"),
                  ("no-remat", False, None))
LATENT_HW = (32, 64)


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


def remat_step_rate(batch: int, gc: bool, policy, iters: int = 5) -> dict:
    """Samples/s and peak device memory of JAX's bare UNet step
    (``remat_sweep.py:30-58``) under one remat setting, on the card."""
    from ..diffusion.ddim import add_noise, make_ddim_schedule
    from ..models.layers import init_random_
    from ..models.unet import UNet2DCondition, UNetConfig
    from ..train.optim import Optimizer
    device = torch.device("cuda")
    sched = make_ddim_schedule(beta_schedule="scaled_linear",
                               beta_start=0.00085, beta_end=0.012,
                               clip_sample=False, set_alpha_to_one=False,
                               device=device)
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(
            in_channels=8, use_fused_attention=True,
            gradient_checkpointing=gc, remat_policy=policy))
    unet.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    init_random_(unet, gen)
    unet.to(torch.bfloat16).train()
    opt = Optimizer(list(unet.named_parameters()), "adamw",
                    learning_rate=1e-4)
    lh, lw = LATENT_HW
    latents = torch.randn((batch, 4, lh, lw), generator=gen, device=device)
    rgbl = torch.randn((batch, 4, lh, lw), generator=gen,
                       device=device).to(torch.bfloat16)

    def step():
        t = torch.randint(0, 1000, (batch,), generator=gen, device=device)
        noise = torch.randn(latents.shape, generator=gen, device=device)
        noisy = add_noise(sched, latents, noise, t)
        inp = torch.cat([noisy.to(torch.bfloat16), rgbl], dim=1)
        loss = torch.mean((unet(inp, t).float() - noise) ** 2)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss

    torch.cuda.reset_peak_memory_stats(device)
    loss = step()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = step()
    torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("remat sweep: non-finite loss")
    return {"samples_per_s": batch / dt, "s_per_step": dt,
            "peak_bytes": torch.cuda.max_memory_allocated(device),
            "loss": float(loss.detach())}


def remat_sweep(batch: int = 16, iters: int = 5) -> dict:
    """:func:`remat_step_rate` under each of :data:`REMAT_SETTINGS`; a
    setting that runs out of device memory reads ``{"error": ...}``."""
    out = {}
    for name, gc, policy in REMAT_SETTINGS:
        try:
            out[name] = remat_step_rate(batch, gc, policy, iters)
        except torch.cuda.OutOfMemoryError as e:
            out[name] = {"error": f"OutOfMemoryError: {str(e)[:120]}"}
        finally:
            gc_module.collect()
            torch.cuda.empty_cache()
        res = out[name]
        print(f"{name:18s} " + (res["error"] if "error" in res else
                                f"{res['samples_per_s']:7.2f} samples/s, "
                                f"peak {res['peak_bytes'] / 2**30:.2f} GiB"),
              flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gn", action="store_true",
                        help="UNetConfig.use_pallas_gn (K5)")
    parser.add_argument("--packed", action="store_true",
                        help="UNetConfig.use_packed_attention (K14)")
    parser.add_argument("--absorbed", action="store_true",
                        help="UNetConfig.use_absorbed_attention (K16)")
    parser.add_argument("--remat-sweep", action="store_true",
                        help="the bare UNet step under each remat setting")
    parser.add_argument("--batch", type=int, default=16,
                        help="--remat-sweep's batch of 32x64 latents")
    parser.add_argument("--iters", type=int, default=5,
                        help="--remat-sweep's timed steps a setting")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 1
    if args.remat_sweep:
        from .bench import smi_line
        print(json.dumps({
            "metric": "remat_sweep", "batch": args.batch,
            "latent_hw": list(LATENT_HW), "iters": args.iters,
            "settings": remat_sweep(args.batch, args.iters),
            "device": torch.cuda.get_device_name(),
            "nvidia_smi": smi_line()}), flush=True)
        return 0
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
