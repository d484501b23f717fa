"""The port's flagship forward, the counterpart of ``__graft_entry__.entry()``
(``__graft_entry__.py:27-49``): the SD-1.4-width UNet (8 input channels, no
cross-attention, self-attention on K1) with random weights from seed 0 in
bf16, on a zero ``[1, 8, 32, 64]`` sample (one 256x512 frame's latent,
NCHW) at timestep 0.

    from ldmseg_torch.entry import entry
    fn, args = entry()          # on the card; entry("cpu") for the CPU
    out = fn(*args)             # [1, 4, 32, 64] bf16

:func:`dryrun_multichip` is the counterpart of
``__graft_entry__.dryrun_multichip``: n ranks through the trainer's
composition at toy widths, data-parallel (stages A and D) and, from 4
ranks, on a ``(n/2, 2)`` mesh with a model axis (stages B and C).
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


def _stage_b(n: int, device: str) -> dict:
    """Stage B (``__graft_entry__.py:178-221``): on a ``(n/2, 2)`` mesh the
    tensor-parallel UNet's forward and gradients against the replicated
    UNet's on the same weights, fp32: the replicated one on the global
    batch, the TP one on this data rank's rows with its gradients averaged
    over the data group; a shard's gradient is held against its slice of
    the replicated one. JAX's bound: 1e-2."""
    import copy
    import time

    import numpy as np

    from .parallel import tp
    from .parallel.mesh import make_mesh, reduce_gradients, shard_batch
    from .parallel.sp import model_axis
    t0 = time.perf_counter()
    mesh = make_mesh(n // 2, 2)
    cin = 12
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(in_channels=cin, **DRYRUN_UNET))
    unet.to_empty(device=device)
    init_random_(unet, torch.Generator(device=device).manual_seed(1))
    ref = copy.deepcopy(unet)
    tp.apply_tp(mesh, unet)
    x = torch.from_numpy(np.random.RandomState(0).randn(
        n // 2, cin, 8, 16).astype(np.float32)).to(device)
    y = torch.from_numpy(np.random.RandomState(1).randn(
        n // 2, 4, 8, 16).astype(np.float32)).to(device)
    t = torch.zeros((n // 2,), dtype=torch.long, device=device)
    out_ref = ref(x, t)
    ((out_ref - y) ** 2).mean().backward()
    xb, yb, tb = (shard_batch(mesh, v) for v in (x, y, t))
    out = unet(xb, tb)
    ((out - yb) ** 2).mean().backward()
    reduce_gradients(list(unet.parameters()), mesh.data_group)
    ferr = float((out - shard_batch(mesh, out_ref)).detach().abs().max())
    lay, ax = tp.layout(unet), model_axis(mesh)
    refs = dict(ref.named_parameters())
    gerr = 0.0
    for name, p in unet.named_parameters():
        g = refs[name].grad
        if name in lay:
            g = tp.local_tensor(g, lay[name][0], ax, lay[name][1])
        gerr = max(gerr, float((p.grad - g).abs().max()))
    if not (ferr < 1e-2 and gerr < 1e-2):
        raise RuntimeError(f"stage B: TP fwd err {ferr}, grad err {gerr}")
    share = (sum(p.numel() for p in unet.parameters())
             / sum(p.numel() for p in ref.parameters()))
    return {"seconds": time.perf_counter() - t0, "fwd_err": ferr,
            "grad_err": gerr, "param_share": share,
            "sharded": len(lay)}


def _stage_c(n: int, device: str) -> dict:
    """Stage C (``__graft_entry__.py:223-251``): one ``TrainerDiffusion``
    step with tensor parallelism, ZeRO-1 and spatial parallelism on a
    ``(n/2, 2)`` mesh, a global batch of n/2 frames of 32x64."""
    import time

    import numpy as np

    from .data.loader import Loader
    from .data.synthetic import SyntheticDVPS
    from .parallel import sp
    from .parallel.mesh import make_mesh, rank_seed, shard_batch
    from .train.trainer_ldm import TrainerDiffusion
    from .utils.config import merge_dicts
    t0 = time.perf_counter()
    mesh = make_mesh(n // 2, 2)
    cfg = merge_dicts(_dryrun_config(n, device, batch_size=n // 2,
                                     accumulate=1),
                      {"tensor_parallel": True, "spatial_parallel": True})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(
        in_channels=12, **DRYRUN_UNET), device=device, mesh=mesh)
    trainer.init_params(seed=0)
    ds = SyntheticDVPS(length=n, size=DRYRUN_HW, num_classes=20)
    batch = next(iter(Loader(ds, n // 2, shuffle=False)))
    sharded = sp.run_stage.sharded
    gen = torch.Generator(device=device).manual_seed(rank_seed(2, mesh))
    loss, _, _ = trainer.train_step(shard_batch(mesh, batch), gen)
    loss = float(loss)
    if not (np.isfinite(loss) and trainer.spatial_parallel
            and sp.run_stage.sharded > sharded):
        raise RuntimeError(f"stage C: loss {loss}, spatial_parallel "
                           f"{trainer.spatial_parallel}")
    return {"seconds": time.perf_counter() - t0, "loss": loss,
            "state_bytes": trainer.state.optimizer.state_bytes(),
            "sp_stages": sp.run_stage.sharded - sharded}


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    """The stages of :func:`dryrun_multichip` on this rank (B and C from 4
    ranks); returns each stage's seconds, its checks' values, and K1's and
    K2's launches beside every other kernel count summed."""
    from .ops.attention import (fused_self_attention,
                                fused_self_attention_backward)
    from .ops.counters import COUNTERS, counted_wrappers
    from .parallel.mesh import make_mesh, rank_seed

    counted = counted_wrappers()
    for fn in counted:
        for name in COUNTERS:
            if hasattr(fn, name):
                setattr(fn, name, 0)
    mesh = make_mesh()
    out = {}
    gen = torch.Generator(device=device).manual_seed(rank_seed(0, mesh))
    out["A"] = _stage_a(n, device, mesh, gen)
    if n >= 4 and n % 2 == 0:
        out["B"] = _stage_b(n, device)
        out["C"] = _stage_c(n, device)
    out["D"] = _stage_d(n, device, mesh, gen)
    k1, k2 = (fused_self_attention.launches,
              fused_self_attention_backward.launches)
    # every other count (launches, fallbacks, K1's wide class) summed
    other = sum(getattr(fn, name, 0) for fn in counted
                for name in COUNTERS) - k1 - k2
    out["launches"] = {"K1": k1, "K2": k2, "other": other}
    return out


def _stage_a(n: int, device: str, mesh, gen) -> dict:
    """Stage A: ZeRO-1, accumulate 2, the self-conditioning double forward
    on n data ranks; then a 4-step DDIM sample and the seg-VAE decode."""
    import time

    import numpy as np

    from .data.loader import Loader
    from .data.synthetic import SyntheticDVPS
    from .parallel.mesh import prefetch_to_device
    from .train.trainer_ldm import TrainerDiffusion
    t0 = time.perf_counter()
    ds = SyntheticDVPS(length=4 * n, size=DRYRUN_HW, num_classes=20)
    trainer = TrainerDiffusion(
        _dryrun_config(n, device), unet_config=UNetConfig(in_channels=12,
                                                  **DRYRUN_UNET),
        device=device, mesh=mesh)
    trainer.init_params(seed=0)
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
    return {"seconds": time.perf_counter() - t0, "losses": losses,
            "logits": tuple(logits.shape),
            "state_bytes": trainer.state.optimizer.state_bytes()}


def _stage_d(n: int, device: str, mesh, gen) -> dict:
    """Stage D: one pose-consistent train step on 2-frame clips."""
    import time

    import numpy as np

    from .data.loader import Loader
    from .data.synthetic import SyntheticDVPS
    from .data.video import ClipDataset
    from .models.posenet import PoseExpNet
    from .parallel.mesh import shard_batch
    from .train.trainer_ldm import TrainerDiffusion
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
    return {"seconds": time.perf_counter() - t0, "consistency": cons}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = 600.0) -> list:
    """``n_devices`` ranks (``parallel/launch.py:run_ranks``: gloo on the
    CPU, NCCL with a card each, gloo when they must share fewer cards),
    each through the stages of ``__graft_entry__.dryrun_multichip``:
    A (one data-parallel train step with ZeRO-1, accumulate 2 and the
    self-conditioning double forward, then a 4-step DDIM sample and the
    seg-VAE decode), from 4 ranks (an even count) B (the tensor-parallel
    UNet's forward and gradients against the replicated one on a
    ``(n/2, 2)`` mesh) and C (one train step with tensor parallelism,
    ZeRO-1 and spatial parallelism there), and D (one pose-consistent clip
    train step). Below 4 ranks B and C are reported as needing 4, as JAX
    skips them. Prints each stage's seconds; returns the ranks' results."""
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
    r0 = ranks[0]
    a, d = r0["A"], r0["D"]
    print(f"dryrun_multichip({n_devices}, {device}): A: DP train step "
          f"(ZeRO-1, accumulate 2, self-conditioning) + 4-step DDIM + "
          f"decode OK, losses {a['losses']}, logits {a['logits']} "
          f"[{a['seconds']:.1f} s]", flush=True)
    if "B" not in r0:
        print(f"dryrun_multichip: B, C: need 4 ranks (an even count: a "
              f"(n/2, 2) mesh), not run on {n_devices}", flush=True)
    else:
        b, c = r0["B"], r0["C"]
        print(f"dryrun_multichip: B: (data={n_devices // 2}, model=2) TP "
              f"UNet fwd+grad parity OK, max err "
              f"{max(b['fwd_err'], b['grad_err']):.2e}, a rank's UNet "
              f"{b['param_share']:.3f} of the parameters "
              f"[{b['seconds']:.1f} s]", flush=True)
        total = sum(r["C"]["state_bytes"] for r in ranks)
        print(f"dryrun_multichip: C: TP+ZeRO-1+SP TrainerDiffusion step OK "
              f"(loss={c['loss']:.4f}), optimizer state a rank "
              f"{[round(r['C']['state_bytes'] / total, 3) for r in ranks]} "
              f"of the ranks' sum [{c['seconds']:.1f} s]", flush=True)
    print(f"dryrun_multichip: D: pose-consistent clip train step OK "
          f"(consistency {d['consistency']:.4f}) [{d['seconds']:.1f} s]",
          flush=True)
    print(f"dryrun_multichip: all ranks in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return ranks
