"""The port's flagship forward, the counterpart of ``__graft_entry__.entry()``
(``__graft_entry__.py:27-49``): the SD-1.4-width UNet (8 input channels, no
cross-attention, self-attention on K1) with random weights from seed 0 in
bf16, on a zero ``[1, 8, 32, 64]`` sample (one 256x512 frame's latent,
NCHW) at timestep 0.

    from ldmseg_torch.entry import entry
    fn, args = entry()          # on the card; entry("cpu") for the CPU
    out = fn(*args)             # [1, 4, 32, 64] bf16

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: n data-parallel ranks through the
trainer's composition at toy widths.
"""

from __future__ import annotations

import torch

from .models.layers import init_random_
from .models.unet import UNet2DCondition, UNetConfig

SEED = 0


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` runs the flagship UNet forward under
    ``torch.inference_mode``; ``args`` are the zero sample and timesteps.
    ``fn.unet`` is the UNet (``use_fused_attention``, eval mode, no
    gradients)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: device 'cuda' asked for but "
                           "torch.cuda.is_available() is False")
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(in_channels=8,
                                          use_fused_attention=True))
    unet.to_empty(device=device)
    init_random_(unet, torch.Generator(device=device).manual_seed(SEED))
    unet = unet.to(torch.bfloat16).eval().requires_grad_(False)
    sample = torch.zeros((1, 8, 32, 64), dtype=torch.bfloat16, device=device)
    timesteps = torch.zeros((1,), dtype=torch.long, device=device)

    def fn(sample, timesteps):
        with torch.inference_mode():
            return unet(sample, timesteps)

    fn.unet = unet
    return fn, (sample, timesteps)


# the dry run's toy widths: UNet levels of 32 and 64 channels, 2 heads (head
# dims 16 and 32, which K1 and K2 take), the seg and image VAEs of the JAX
# dry run, 32x64 frames
DRYRUN_UNET = dict(block_out_channels=(32, 64), attn_down=(True, False),
                   layers_per_block=1, attention_head_dim=2,
                   norm_num_groups=8, use_fused_attention=True)
DRYRUN_HW = (32, 64)


def _dryrun_config(n: int, device: str, **train):
    """bf16 compute on the card; fp32 on the CPU, whose bf16 convolutions
    are emulated and slow."""
    from .utils.config import DEFAULT_CONFIG, merge_dicts
    return merge_dicts(DEFAULT_CONFIG, {
        "vae_model_kwargs": {
            "in_channels": 10, "int_channels": 16, "out_channels": 24,
            "block_out_channels": [8, 8, 16, 16], "num_upscalers": 2,
            "upscale_channels": 16, "norm_num_groups": 8},
        "image_vae_kwargs": {"block_out_channels": [8, 8, 16, 16],
                             "groups": 8},
        "train_kwargs": dict({"batch_size": 2 * n, "self_condition": True,
                              "weight_dtype": ("bfloat16" if device == "cuda"
                                               else "float32"),
                              "accumulate": 2}, **train),
        "optimizer_zero_redundancy": True, "ignore_label": 0})


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    """Stages A and D on this rank (:func:`dryrun_multichip`); returns each
    stage's seconds, its checks' values, and K1's and K2's launches beside
    every other kernel count summed."""
    import time

    import numpy as np

    from .data.loader import Loader
    from .data.synthetic import SyntheticDVPS
    from .data.video import ClipDataset
    from .models.posenet import PoseExpNet
    from .ops.attention import (fused_self_attention,
                                fused_self_attention_backward)
    from .ops.counters import COUNTERS, counted_wrappers
    from .parallel.mesh import (make_mesh, prefetch_to_device, rank_seed,
                                shard_batch)
    from .train.trainer_ldm import TrainerDiffusion

    counted = counted_wrappers()
    for fn in counted:
        for name in COUNTERS:
            if hasattr(fn, name):
                setattr(fn, name, 0)
    mesh = make_mesh()
    out = {}
    # A: ZeRO-1, accumulate 2, the self-conditioning double forward; then
    # a 4-step DDIM sample and the seg-VAE decode
    t0 = time.perf_counter()
    ds = SyntheticDVPS(length=4 * n, size=DRYRUN_HW, num_classes=20)
    trainer = TrainerDiffusion(
        _dryrun_config(n, device), unet_config=UNetConfig(in_channels=12,
                                                  **DRYRUN_UNET),
        device=device, mesh=mesh)
    trainer.init_params(seed=0)
    # the draws from (seed, rank), as train_loop takes them
    gen = torch.Generator(device=device).manual_seed(rank_seed(0, mesh))
    losses = []
    # each global batch cut to this rank's rows, then to the device
    for batch in prefetch_to_device(Loader(ds, 2 * n, shuffle=False), mesh,
                                    device):
        loss, _, _ = trainer.train_step(batch, gen)
        losses.append(float(loss))
    if trainer.state.step != 1 or not np.isfinite(losses).all():
        raise RuntimeError(f"stage A: {trainer.state.step} optimizer steps, "
                           f"losses {losses}")
    logits, _ = trainer.sample_panoptic(batch, gen, num_inference_steps=4)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("stage A: sampled logits not finite")
    out["A"] = {"seconds": time.perf_counter() - t0, "losses": losses,
                "logits": tuple(logits.shape),
                "state_bytes": trainer.state.optimizer.state_bytes()}
    del trainer
    # D: one pose-consistent train step on 2-frame clips
    t0 = time.perf_counter()
    clips = ClipDataset(SyntheticDVPS(length=4 * n, size=DRYRUN_HW,
                                      num_classes=20, frames_per_scene=2),
                        clip_len=2)
    trainer = TrainerDiffusion(
        _dryrun_config(n, device, batch_size=n, accumulate=1,
                       self_condition=False,
                       temporal_consistency_weight=0.1),
        unet_config=UNetConfig(in_channels=8, **DRYRUN_UNET), device=device,
        mesh=mesh)
    trainer.init_params(seed=1)
    with torch.device("meta"):
        pose = PoseExpNet(nb_ref_imgs=1)
    pose.to_empty(device=device)
    init_random_(pose, torch.Generator(device=device).manual_seed(3))
    trainer.attach_pose(pose)
    clip_batch = next(iter(Loader(clips, n, shuffle=False)))
    _, metrics, _ = trainer.train_step(shard_batch(mesh, clip_batch), gen)
    cons = float(metrics["consistency"])
    if not (np.isfinite(cons) and cons > 0):
        raise RuntimeError(f"stage D: consistency {cons}")
    out["D"] = {"seconds": time.perf_counter() - t0, "consistency": cons}
    k1, k2 = (fused_self_attention.launches,
              fused_self_attention_backward.launches)
    # every other count (launches, fallbacks, K1's wide class) summed
    other = sum(getattr(fn, name, 0) for fn in counted
                for name in COUNTERS) - k1 - k2
    out["launches"] = {"K1": k1, "K2": k2, "other": other}
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = 600.0) -> list:
    """``n_devices`` data-parallel ranks (``parallel/launch.py:run_ranks``:
    gloo on the CPU, NCCL with a card each, gloo when they must share fewer
    cards), each through stage A (one train step with ZeRO-1, accumulate 2
    and the self-conditioning double forward, then a 4-step DDIM sample and
    the seg-VAE decode) and stage D (one pose-consistent clip train step)
    of ``__graft_entry__.dryrun_multichip``. Stages B and C shard over a
    model axis, which the port does not have yet: they are reported as not
    run. Prints each stage's seconds; returns the ranks' results."""
    import time

    from .parallel.launch import run_ranks
    device = torch.device(device).type
    backend, local_rank = None, None
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: device 'cuda' asked for "
                               "but torch.cuda.is_available() is False")
        if torch.cuda.device_count() < n_devices:
            # NCCL refuses two ranks on one device
            backend, local_rank = "gloo", 0
    t0 = time.perf_counter()
    ranks = run_ranks(_dryrun_rank, n_devices, args=(n_devices, device),
                      device=device, backend=backend, local_rank=local_rank,
                      timeout_s=timeout_s)
    a, d = ranks[0]["A"], ranks[0]["D"]
    print(f"dryrun_multichip({n_devices}, {device}): A: DP train step "
          f"(ZeRO-1, accumulate 2, self-conditioning) + 4-step DDIM + "
          f"decode OK, losses {a['losses']}, logits {a['logits']} "
          f"[{a['seconds']:.1f} s]", flush=True)
    print("dryrun_multichip: B, C: not run (tensor and spatial parallelism "
          "need a model axis, not ported yet)", flush=True)
    print(f"dryrun_multichip: D: pose-consistent clip train step OK "
          f"(consistency {d['consistency']:.4f}) [{d['seconds']:.1f} s]; "
          f"all ranks in {time.perf_counter() - t0:.1f} s", flush=True)
    return ranks
