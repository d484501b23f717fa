#!/usr/bin/env python3
"""Drive the PyTorch port (``ldmseg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  0. device: name, count and ``nvidia-smi`` name/power limit;
  1. build every CUDA kernel under ``ldmseg_torch/csrc/`` (one nvcc each,
     all at once);
  2. K1 (self-attention forward) against its plain PyTorch version at the
     sampling path's shapes, with times, the bound and the library yardstick;
  3. the full-width SD-1.4 UNet forward on K1 against the same module on the
     plain attention;
  4. ``TrainerDiffusion.sample_panoptic`` end to end at full width (50 DDIM
     steps, batch 2 of 256x512 frames) and ``panoptic_post_process``, with
     K1's and K2's launch counts over that run;
  5. K2 (self-attention backward) against its plain PyTorch version at the
     training path's shapes, with times, the bound and the library
     yardstick (SDPA's backward);
  6. ``TrainerDiffusion.train_loop`` at full width (bf16 on fp32 masters,
     self-conditioning, AdamW, batch 8 of 192x640 ``SyntheticDVPS`` frames):
     2 warm-up steps, 5 timed steps with K1's and K2's launch counts, the
     update checks, and one step's loss and gradients on K1/K2 against the
     same step on the plain attention;
  7. a JSON line ``{"kernels": [...]}``;
  8. the last line, ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. Without a CUDA device
it exits 1 at once. Weights are random, made from a seed; fp32 comparisons
run with TF32 off.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a call
# is the larger of its operations over the peak rate of their type and its
# bytes over the memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

BF16_ATOL = 1.6e-2  # two bf16 ulps at 1.0: sums run in another order
FP32_ATOL = 1e-4

# (B, T, H, D) of K1's launches in one UNet forward on a 32x64 latent at
# batch 2, with the number of launches of each
K1_SHAPES = [((2, 2048, 8, 40), 5), ((2, 512, 8, 80), 5),
             ((2, 128, 8, 160), 5), ((2, 32, 8, 160), 1)]
# (B, T, H, D) of K2's launches in one UNet backward on a 24x80 latent at
# batch 8 (192x640 frames), with the number of launches of each
K2_SHAPES = [((8, 1920, 8, 40), 5), ((8, 480, 8, 80), 5),
             ((8, 120, 8, 160), 5), ((8, 30, 8, 160), 1)]
TRAIN_BATCH, TRAIN_HW = 8, (192, 640)
WARMUP_STEPS, TIMED_STEPS = 2, 5


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype_name: str, products: int = 2,
                       tensors: int = 4):
    """The bound of ``products`` [T x T x D] products over B*H heads that
    read and write ``tensors`` [B, T, H, D] tensors: forward 2 and 4 (q, k,
    v in, o out), backward 5 and 7 (q, k, v, dO in, dQ, dK, dV out)."""
    b, t, h, d = shape
    esize = 2 if dtype_name == "bfloat16" else 4
    flops = 2.0 * products * b * h * t * t * d
    nbytes = float(tensors) * b * h * t * d * esize
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else
                                 "bytes"), flops, nbytes


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"phase 0 device: {name}, count {count}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}", flush=True)
    print(smi_line, flush=True)
    return name, count, smi_line


def phase_build():
    from ldmseg_torch.ops import _build
    t0 = time.monotonic()
    report = _build.build()
    secs = time.monotonic() - t0
    for name, r in report.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  [{name}] {line.strip()}", file=sys.stderr)
    print(f"phase 1 build: {len(report)} kernel source(s) "
          f"{sorted(report)} in {secs:.2f} s", flush=True)
    return secs


def phase_attention():
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape, dtype):
        return [torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype) for _ in range(3)]

    cases = [(s, n, torch.bfloat16) for s, n in K1_SHAPES]
    cases += [((2, 512, 8, 80), 0, torch.float32),
              ((2, 100, 8, 40), 0, torch.bfloat16),
              ((1, 100, 2, 160), 0, torch.float32)]
    rows = []
    for shape, per_fwd, dtype in cases:
        q, k, v = inputs(shape, dtype)
        scale = shape[3] ** -0.5
        out = A.fused_self_attention(q, k, v, scale)
        torch.cuda.synchronize()
        ref = A.attention_reference(q, k, v, scale)
        err = (out.float() - ref.float()).abs().max().item()
        dname = str(dtype).split(".")[-1]
        tol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
        check(math.isfinite(err) and err <= tol,
              f"K1 {shape} {dname}: max abs err {err} > {tol}")
        ms = time_ms(lambda: A.fused_self_attention(q, k, v, scale))
        plain_ms = time_ms(lambda: A.attention_reference(q, k, v, scale))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale))
        bound, by, flops, nbytes = attention_bound_ms(shape, dname)
        rows.append({"shape_btHd": list(shape), "dtype": dname,
                     "per_unet_forward": per_fwd, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bound, "bound_by": by, "flops": flops,
                     "bytes": nbytes})
        print(f"phase 2 K1 {tuple(shape)} {dname}: err {err:.3e} (tol {tol})"
              f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return rows


def _config():
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts
    # the default deployment: SD-1.4 UNet and image VAE, the seg VAE of
    # DEFAULT_CONFIG, bf16 compute, self-conditioning, 50 DDIM steps
    return merge_dicts(DEFAULT_CONFIG, {"train_kwargs": {
        "self_condition": True, "weight_dtype": "bfloat16"}})


def phase_unet(trainer, seed: int = 1):
    """Full-width UNet forward on K1 against the same module with the plain
    attention (the einsum path), bf16, batch 2, 32x64 latent."""
    import torch
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.ops import attention as A

    unet = trainer.inference_unet()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, unet.config.in_channels, 32, 64), generator=gen,
                    device="cuda").to(torch.bfloat16)
    t = torch.tensor([999, 19], device="cuda")
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    with torch.inference_mode():
        before = A.fused_self_attention.launches
        fused = unet(x, t).float()
        torch.cuda.synchronize()
        per_forward = A.fused_self_attention.launches - before
        fused_ms = time_ms(lambda: unet(x, t), iters=10)
        for m in attn:
            m.use_fused = False
        try:
            plain = unet(x, t).float()
            plain_ms = time_ms(lambda: unet(x, t), iters=10)
        finally:
            for m in attn:
                m.use_fused = True
    check(per_forward == 16, f"UNet forward made {per_forward} K1 launches, "
          f"expected 16")
    check(bool(torch.isfinite(fused).all()), "UNet output not finite")
    rel = ((fused - plain).abs().max() / plain.abs().max()).item()
    check(rel <= 2e-2, f"UNet on K1 vs plain attention: max rel err {rel}")
    n_params = sum(p.numel() for p in unet.parameters())
    print(f"phase 3 UNet forward: {n_params / 1e6:.1f} M params, bf16 "
          f"[2, {unet.config.in_channels}, 32, 64]: K1 path {fused_ms:.3f} ms,"
          f" plain-attention path {plain_ms:.3f} ms, max rel err {rel:.3e} "
          f"(tol 2e-2), {per_forward} K1 launches", flush=True)
    return {"fused_ms": fused_ms, "plain_ms": plain_ms, "max_rel_err": rel}


def phase_sample(trainer, smi_line: str, seed: int = 0):
    """``sample_panoptic`` end to end at full width: 50 DDIM steps on 2
    frames of 256x512, then ``panoptic_post_process``. Returns K1's launch
    count over the timed call (the main path)."""
    import numpy as np
    import torch
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops.panoptic import panoptic_post_process

    image = np.random.RandomState(seed).randn(2, 256, 512, 3).astype(
        np.float32)
    batch = {"image": image}
    steps = trainer.num_inference_steps
    trainer.sample_panoptic(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.fused_self_attention.launches = 0
    A.fused_self_attention_backward.launches = 0
    t0 = time.perf_counter()
    logits, x0 = trainer.sample_panoptic(batch)
    cleaned, keep = panoptic_post_process(
        logits, mask_th=trainer.mask_th, count_th=trainer.count_th,
        overlap_th=trainer.overlap_th, ignore_label=trainer.ignore_label)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = A.fused_self_attention.launches
    bwd_launches = A.fused_self_attention_backward.launches
    peak = torch.cuda.max_memory_allocated()
    c = trainer.num_classes
    check(tuple(logits.shape) == (2, 256, 512, c),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "logits not finite")
    check(tuple(x0.shape) == (2, 32, 64, 4), f"x0 shape {tuple(x0.shape)}")
    check(tuple(cleaned.shape) == (2, 256, 512) and
          cleaned.dtype == torch.int32, "cleaned map shape/dtype")
    check(tuple(keep.shape) == (2, c), f"keep shape {tuple(keep.shape)}")
    check(launches == 16 * steps, f"K1 launches {launches} != 16 x {steps}")
    check(bwd_launches == 0, f"sampling launched K2 {bwd_launches} times")
    print(f"phase 4 sample_panoptic: {steps} DDIM steps, 2 x 256x512 "
          f"frames -> logits {tuple(logits.shape)}: {secs:.3f} s per call "
          f"(post-process included), {2 / secs:.3f} frames/s, peak memory "
          f"{peak / 2**30:.2f} GiB, K1 launches {launches} [{smi_line}]",
          flush=True)
    return launches, {"seconds": secs, "frames_per_s": 2 / secs,
                      "peak_bytes": peak}


def phase_attention_backward():
    """K2 against its plain version at the training path's shapes, plus one
    fp32 and two ragged-T cases. Each of dQ, dK and dV is held to the
    tolerance times its own max|ref|: two bf16 ulps at the gradient's
    largest value, 1e-4 in fp32."""
    import torch
    import torch.nn.functional as F
    from ldmseg_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(s, n, torch.bfloat16) for s, n in K2_SHAPES]
    cases += [((8, 480, 8, 80), 0, torch.float32),
              ((8, 100, 8, 40), 0, torch.bfloat16),
              ((1, 100, 2, 160), 0, torch.float32)]
    rows = []
    for shape, per_bwd, dtype in cases:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(4))
        scale = shape[3] ** -0.5
        grads = A.fused_self_attention_backward(q, k, v, do, scale)
        torch.cuda.synchronize()
        refs = A.attention_backward_reference(q, k, v, do, scale)
        dname = str(dtype).split(".")[-1]
        rtol = BF16_ATOL if dtype == torch.bfloat16 else FP32_ATOL
        per_grad = {}
        for gname, g, r in zip(("dQ", "dK", "dV"), grads, refs):
            e = (g.float() - r.float()).abs().max().item()
            m = r.float().abs().max().item()
            check(m > 0 and math.isfinite(e) and e <= rtol * m,
                  f"K2 {shape} {dname} {gname}: max abs err {e} > {rtol} x "
                  f"max|ref| {m}")
            per_grad[gname] = {"max_abs_err": e, "max_abs_ref": m,
                               "tol": rtol * m}
        del grads, refs
        err = max(x["max_abs_err"] for x in per_grad.values())
        ms = time_ms(lambda: A.fused_self_attention_backward(
            q, k, v, do, scale), iters=10)
        plain_ms = time_ms(lambda: A.attention_backward_reference(
            q, k, v, do, scale), iters=5, warmup=1)
        # the library yardstick: SDPA's backward alone on [B, H, T, D]
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), iters=10)
        del out
        bound, by, flops, nbytes = attention_bound_ms(shape, dname, 5, 7)
        rows.append({"shape_btHd": list(shape), "dtype": dname,
                     "per_unet_backward": per_bwd, "max_abs_err": err,
                     "per_gradient": per_grad, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                     "flops": flops, "bytes": nbytes})
        errs = ", ".join(f"{g} {x['max_abs_err']:.3e} of max|ref| "
                         f"{x['max_abs_ref']:.3e}"
                         for g, x in per_grad.items())
        print(f"phase 5 K2 {tuple(shape)} {dname}: err {errs} (tol {rtol} "
              f"x max|ref|), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa-bwd {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)
    return rows


def _train_config():
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts
    # the default deployment trained as the reference trains it: SD-1.4
    # UNet with self-conditioning (12 input channels), bf16 compute on fp32
    # masters, AdamW lr 1e-4 with warm-up, clip_grad 3.0, time_embedding
    # frozen; SyntheticDVPS's ignore label (0)
    return merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True, "weight_dtype": "bfloat16",
                         "batch_size": TRAIN_BATCH},
        "ignore_label": 0})


def _flat_grads(unet):
    import torch
    return torch.cat([p.grad.reshape(-1) for p in unet.parameters()])


def phase_train(smi_line: str, seed: int = 0):
    """``train_loop`` at full width: warm-up, then the timed steps with the
    launch counts (the training path), then the update and gradient checks.
    Returns the counts over the timed steps and the measurements."""
    import torch
    from ldmseg_torch.data.loader import Loader
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.models.unet import CrossAttention
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion

    ds = SyntheticDVPS(length=2 * TRAIN_BATCH, size=TRAIN_HW, num_bits=8)
    trainer = TrainerDiffusion(_train_config(), dataset=ds)
    trainer.init_params(seed=seed)
    unet = trainer.unet
    masters = {n: p.detach().clone() for n, p in unet.named_parameters()}
    warm = trainer.train_loop(max_steps=WARMUP_STEPS, log_every=WARMUP_STEPS,
                              seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.fused_self_attention.launches = 0
    A.fused_self_attention_backward.launches = 0
    t0 = time.perf_counter()
    timed = trainer.train_loop(max_steps=TIMED_STEPS, log_every=TIMED_STEPS,
                               seed=seed + 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    fwd, bwd = (A.fused_self_attention.launches,
                A.fused_self_attention_backward.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = warm + timed
    check(len(losses) == WARMUP_STEPS + TIMED_STEPS
          and all(math.isfinite(x) for x in losses),
          f"train losses not finite: {losses}")
    check(fwd == 32 * TIMED_STEPS and bwd == 16 * TIMED_STEPS,
          f"train steps launched K1 {fwd} and K2 {bwd} times, expected "
          f"{32 * TIMED_STEPS} and {16 * TIMED_STEPS}")
    check(trainer.state.step == WARMUP_STEPS + TIMED_STEPS,
          f"optimizer steps {trainer.state.step}")
    frozen, moved = [], []
    for n, p in unet.named_parameters():
        same = torch.equal(p.detach(), masters[n])
        if n.startswith("time_embedding"):
            frozen.append(same)
        else:
            moved.append(not same)
    check(frozen and all(frozen), "a time_embedding parameter changed")
    check(all(moved), f"{moved.count(False)} trained parameters unchanged")
    del masters
    print(f"phase 6 train_loop: {TIMED_STEPS} steps, batch {TRAIN_BATCH} x "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 on fp32 masters: "
          f"{secs / TIMED_STEPS:.4f} s/step, "
          f"{TRAIN_BATCH * TIMED_STEPS / secs:.3f} samples/s, peak memory "
          f"{peak / 2**30:.2f} GiB, K1 {fwd} / K2 {bwd} launches, losses "
          f"{[round(x, 4) for x in losses]} [{smi_line}]", flush=True)

    # the host's data path alone, and train_step on a batch already loaded
    t0 = time.perf_counter()
    batch = next(iter(Loader(ds, TRAIN_BATCH, seed=seed + 2)))
    data_secs = time.perf_counter() - t0
    trainer.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    step_secs = (time.perf_counter() - t0) / 3
    print(f"phase 6 train_step on a loaded batch: {step_secs:.4f} s/step; "
          f"loading and collating one batch: {data_secs:.4f} s", flush=True)

    # one step's loss and gradients on K1/K2 against the plain attention
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    lh, lw = TRAIN_HW[0] // 8, TRAIN_HW[1] // 8
    noise = torch.randn((TRAIN_BATCH, lh, lw, 4), generator=gen, device=dev)
    steps = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen, device=dev)
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    results = {}
    for fused in (True, False):
        for m in attn:
            m.use_fused = fused
        trainer.state.zero_grad()
        loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                              timesteps=steps)
        if fused:
            for m in attn:
                g = m.to_q.weight.grad
                check(g is not None and bool(torch.isfinite(g).all())
                      and g.abs().max().item() > 0,
                      "a to_q.weight.grad is missing, zero or not finite")
        results[fused] = (loss.item(), _flat_grads(unet))
    for m in attn:
        m.use_fused = True
    trainer.state.zero_grad()
    (loss_f, g_f), (loss_p, g_p) = results[True], results[False]
    norm_f, norm_p = g_f.norm().item(), g_p.norm().item()
    cos = (torch.dot(g_f, g_p) / (g_f.norm() * g_p.norm())).item()
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    norm_rel = abs(norm_f - norm_p) / norm_p
    del results, g_f, g_p
    check(loss_rel <= 1e-2, f"train loss on K1/K2 vs plain: rel {loss_rel}")
    check(norm_rel <= 2e-2, f"gradient norm on K1/K2 vs plain: rel "
          f"{norm_rel}")
    check(cos >= 0.99, f"gradient cosine on K1/K2 vs plain: {cos}")
    print(f"phase 6 one step on K1/K2 vs plain attention: loss {loss_f:.6f} "
          f"vs {loss_p:.6f} (rel {loss_rel:.2e}, tol 1e-2), gradient norm "
          f"{norm_f:.6f} vs {norm_p:.6f} (rel {norm_rel:.2e}, tol 2e-2), "
          f"cosine {cos:.6f} (>= 0.99); every to_q.weight.grad finite and "
          f"non-zero ({len(attn)} layers)", flush=True)
    return fwd, bwd, {"seconds_per_step": secs / TIMED_STEPS,
                      "samples_per_s": TRAIN_BATCH * TIMED_STEPS / secs,
                      "train_step_seconds_loaded_batch": step_secs,
                      "batch_load_seconds": data_secs,
                      "peak_bytes": peak, "losses": losses,
                      "loss_rel": loss_rel, "grad_norm_rel": norm_rel,
                      "grad_cosine": cos}


def _per_unit(rows, per_key):
    main = [r for r in rows if r[per_key]]

    def total(key):
        return sum(r[key] * r[per_key] for r in main)

    ops = sum(r["flops"] * r[per_key] for r in main)
    nbytes = sum(r["bytes"] * r[per_key] for r in main)
    return {
        "max_abs_err": max(r["max_abs_err"] for r in main),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if ops / PEAK_FLOPS["bfloat16"]
                     >= nbytes / PEAK_BYTES else "bytes"),
        "library_ms": total("library_ms"),
    }


def k2_entry(rows, launches, by_path):
    """The kernels-line entry for K2: times summed over the 16 launches of
    one UNet backward (the training path's shapes at batch 8)."""
    return {
        "name": "attention_bwd",
        "id": "K2",
        "route": "cuda",
        "source": "ldmseg_torch/csrc/attention_bwd.cu",
        "replaces": "ldmseg_tpu/ops/pallas/attention.py:1298",
        "tpu_kernel": "ldmseg_tpu/ops/pallas/attention.py:_attn_bwd_kernel",
        "launches": launches,
        "launches_by_path": by_path,
        "checked": True,
        **_per_unit(rows, "per_unet_backward"),
        "unit": "one UNet backward (16 launches, bf16, batch 8, 24x80 "
                "latent)",
        "shapes": rows,
    }


def k1_entry(rows, launches, by_path):
    """The kernels-line entry for K1: times summed over the 16 launches of
    one UNet forward (the sampling path's shapes at batch 2), per-shape rows
    beside them."""
    return {
        "name": "attention_fwd",
        "id": "K1",
        "route": "cuda",
        "source": "ldmseg_torch/csrc/attention_fwd.cu",
        "replaces": "ldmseg_tpu/ops/pallas/attention.py:28",
        "tpu_kernel": "ldmseg_tpu/ops/pallas/attention.py:_attn_kernel",
        "launches": launches,
        "launches_by_path": by_path,
        "checked": True,
        **_per_unit(rows, "per_unet_forward"),
        "unit": "one UNet forward (16 launches, bf16, batch 2, 32x64 latent)",
        "shapes": rows,
    }


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch missing: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        import ldmseg_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ldmseg_torch package is missing: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        name, count, smi_line = phase_device()
        phase_build()
        rows = phase_attention()
        from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
        trainer = TrainerDiffusion(_config())
        trainer.init_params(seed=0)
        unet_result = phase_unet(trainer)
        launches, sample_result = phase_sample(trainer, smi_line)
        del trainer
        torch.cuda.empty_cache()
        bwd_rows = phase_attention_backward()
        train_fwd, train_bwd, train_result = phase_train(smi_line)
        print(json.dumps({"results": {"device": smi_line,
                                      "unet_forward": unet_result,
                                      "sample_panoptic": sample_result,
                                      "train": train_result}}),
              flush=True)
        train_path = f"train_loop, {TIMED_STEPS} steps"
        print(json.dumps({"kernels": [
            k1_entry(rows, launches, {"sample_panoptic": launches,
                                      train_path: train_fwd}),
            k2_entry(bwd_rows, train_bwd, {"sample_panoptic": 0,
                                           train_path: train_bwd}),
        ]}), flush=True)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
