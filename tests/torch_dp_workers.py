"""The ranks' side of the data-parallel tests: functions that
``ldmseg_torch.parallel.launch.run_ranks`` starts in fresh processes. This
module imports torch and the port only (never JAX, never the conftest), so
that a rank starts in about a second; the tests that hold the ranks'
results against the JAX package import it.

Each worker takes a ``spec`` of numpy arrays: ``params`` the JAX
package's parameter trees (numpy leaves, adopted through
``load_jax_params``), ``micro`` a list of global micro-batches, each
``(batch, draws)``; a rank trains its rows of each (``shard_batch``), with
its rows of the global draws.
"""

from __future__ import annotations

import torch

from ldmseg_torch.parallel.mesh import make_mesh, shard_batch


def _rows(x, mesh):
    return None if x is None else shard_batch(mesh, x)


def _capture_steps(optimizer, out: list) -> None:
    """Record every gradient as the optimizer's step reads it (after the
    reduction over the data group, before clipping)."""
    step = optimizer.step

    def recorded():
        out.append({i: p.grad.detach().clone()
                    for i, p in enumerate(optimizer.params)
                    if p.grad is not None})
        step()
    optimizer.step = recorded


def _named(params, named_grads):
    names = [n for n, _ in params]
    return [{names[i]: g for i, g in step.items()} for step in named_grads]


def stage2(rank: int, spec: dict) -> dict:
    """``TrainerDiffusion`` steps on this rank's rows: the shares of the
    loss, the group's mean loss, the per-rank OHEM loss (``group=None`` on
    the same inputs), the reduced gradients at each optimizer step, the
    masters after, the optimizer state's bytes; optionally a checkpoint
    after ``save_after`` micro-batches, or a resume first."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.parallel.mesh import group_mean

    torch.set_num_threads(1)
    mesh = make_mesh()
    trainer = tl.TrainerDiffusion(
        spec["cfg"], unet_config=UNetConfig(**spec["unet_kw"]),
        device="cpu", results_folder=spec.get("folder"), mesh=mesh)
    trainer.load_jax_params(*spec["params"])
    if spec.get("resume"):
        trainer.resume(spec["resume"])
    per_rank = []
    loss_fn = tl.diffusion_loss

    def both(*args, **kw):
        per_rank.append(loss_fn(*args, **dict(kw, group=None)).detach())
        return loss_fn(*args, **kw)
    tl.diffusion_loss = both
    steps: list = []
    _capture_steps(trainer.state.optimizer, steps)
    losses, means, saved = [], [], None
    for i, (batch, draws) in enumerate(spec["micro"]):
        loss, _, _ = trainer.forward_backward(
            shard_batch(mesh, batch), noise=_rows(draws["noise"], mesh),
            timesteps=_rows(draws["timesteps"], mesh))
        trainer.state.apply_gradients()
        losses.append(float(loss))
        means.append(float(group_mean(loss, mesh)))
        if spec.get("save_after") == i + 1:
            saved = trainer.save(tag="dp_checkpoint")
    tl.diffusion_loss = loss_fn
    per_rank = [float(group_mean(x, mesh)) for x in per_rank]
    return {"losses": losses, "means": means, "per_rank_ohem": per_rank,
            "grads": _named(list(trainer.unet.named_parameters()), steps),
            "masters": {n: p.detach().clone()
                        for n, p in trainer.unet.named_parameters()},
            "state_bytes": trainer.state.optimizer.state_bytes(),
            "step": trainer.state.step, "saved": saved}


def stage2_all(rank: int, specs: list) -> list:
    """:func:`stage2` for each spec in turn, the ranks meeting at a barrier
    between them (a later spec may resume a checkpoint an earlier one
    wrote)."""
    import torch.distributed as dist
    out = []
    for spec in specs:
        out.append(stage2(rank, spec))
        dist.barrier()
    return out


def stage1(rank: int, spec: dict) -> dict:
    """One ``TrainerAE`` step on this rank's rows with its rows of the
    global draws: the loss and parts (the group's means), the point losses
    with this rank's own counts (``group=None`` on the same inputs), the
    reduced gradients, the masters after."""
    import ldmseg_torch.train.trainer_ae as ta
    from ldmseg_torch.parallel.mesh import group_mean
    from ldmseg_torch.train.trainer_ae import TrainerAE

    torch.set_num_threads(1)
    mesh = make_mesh()
    trainer = TrainerAE(spec["cfg"], device="cpu", mesh=mesh)
    trainer.load_jax_params(spec["params"])
    steps: list = []
    _capture_steps(trainer.state.optimizer, steps)
    draws = spec["draws"]
    k = trainer.loss_cfg.max_masks
    b = mesh.local_batch(len(spec["batch"]["semseg"]))
    sl = slice(rank * b, (rank + 1) * b)
    sk = slice(rank * b * k, (rank + 1) * b * k)
    mine = {"noise": draws["noise"][sl],
            "corrupt": tuple(u[sl] for u in draws["corrupt"]),
            "points": {"ce": tuple(u[sl] for u in draws["points"]["ce"]),
                       "mask": tuple(u[sk] for u in
                                     draws["points"]["mask"])}}
    own = {}
    losses_fn = ta.point_losses

    def both(*args, **kw):
        own.update(losses_fn(*args, **dict(kw, group=None)))
        return losses_fn(*args, **kw)
    ta.point_losses = both
    loss, parts = trainer.train_step(shard_batch(mesh, spec["batch"]),
                                     draws=mine)
    ta.point_losses = losses_fn
    return {"loss": float(group_mean(loss, mesh)),
            "parts": {n: float(group_mean(v, mesh))
                      for n, v in parts.items()},
            "own_parts": {n: float(group_mean(v.detach(), mesh))
                          for n, v in own.items()},
            "grads": _named(list(trainer.vae.named_parameters()), steps),
            "masters": {n: p.detach().clone()
                        for n, p in trainer.vae.named_parameters()}}


def pose(rank: int, spec: dict) -> dict:
    """One ``TrainerPose`` step on this rank's clips: the group's mean
    loss, the reduced gradients, the masters after."""
    from ldmseg_torch.parallel.mesh import group_mean
    from ldmseg_torch.train.trainer_pose import TrainerPose

    torch.set_num_threads(1)
    mesh = make_mesh()
    trainer = TrainerPose(spec["cfg"], results_folder=spec["folder"],
                          nb_ref_imgs=spec["nb_ref"], device="cpu",
                          mesh=mesh)
    trainer.load_jax_params(spec["params"])
    steps: list = []
    _capture_steps(trainer.state.optimizer, steps)
    metrics = trainer.train_step(shard_batch(mesh, spec["batch"]))
    return {"loss": float(group_mean(metrics["loss"], mesh)),
            "grads": _named(list(trainer.model.named_parameters()), steps),
            "masters": {n: p.detach().clone()
                        for n, p in trainer.model.named_parameters()}}


def adafactor_steps(mesh=None) -> dict:
    """Adafactor (one factored parameter, three not) with ZeRO-1 on
    ``mesh`` (none: one process): two steps on seeded gradients, the state
    dict gathered onto data rank 0 (None elsewhere), a fresh optimizer on
    every rank loading rank 0's dict, a third step."""
    from ldmseg_torch.parallel.multihost import broadcast_host
    from ldmseg_torch.train.optim import Optimizer

    def params():
        gen = torch.Generator().manual_seed(0)
        shapes = {"dense.weight": (160, 130), "dense.bias": (130,),
                  "norm.weight": (7,), "conv.weight": (14, 8, 3, 3)}
        return [(n, torch.nn.Parameter(torch.randn(s, generator=gen)))
                for n, s in shapes.items()]
    kw = dict(learning_rate=1e-2, weight_decay=0.1, weight_decay_norm=0.0,
              clip_grad=1.0, mesh=mesh, zero1=True)
    named = params()
    opt = Optimizer(named, "adafactor", **kw)
    gen = torch.Generator().manual_seed(1)
    grads = [[torch.randn(p.shape, generator=gen) for _, p in named]
             for _ in range(3)]

    def step(opt, named, g):
        for (_, p), gi in zip(named, g):
            p.grad = gi.clone()
        opt.step()
    for g in grads[:2]:
        step(opt, named, g)
    sd = opt.state_dict()
    again = params()
    with torch.no_grad():
        for (_, a), (_, b) in zip(again, named):
            a.copy_(b)
    fresh = Optimizer(again, "adafactor", **kw)
    # every rank reads what the main process wrote
    fresh.load_state_dict_(broadcast_host(sd))
    step(fresh, again, grads[2])
    return {"state": sd, "masters": {n: p.detach() for n, p in again},
            "state_bytes": fresh.state_bytes()}


def collectives(rank: int, spec: dict) -> dict:
    """``all_gather_host``, ``replicate``, the evaluators' sums on this
    rank's share of the images, the segmentation warp term on its rows,
    and Adafactor under ZeRO-1 (:func:`adafactor_steps`)."""
    from ldmseg_torch.evals import PanopticEvaluator, SemsegMeter
    from ldmseg_torch.parallel import all_gather_host, replicate

    mesh = make_mesh()
    gathered = all_gather_host({"rank": rank, "tag": spec["tags"][rank]})
    t = torch.full((3, 2), float(rank + 5))
    module = torch.nn.Linear(2, 3)
    with torch.no_grad():
        module.weight.fill_(rank + 1.0)
    replicate(mesh, {"t": t, "m": module})
    ev = PanopticEvaluator(**spec["pq_kw"], group=mesh.data_group)
    meter = SemsegMeter(spec["num_classes"], ignore_index=spec["ignore"],
                        group=mesh.data_group)
    for pred, gt in spec["images"][rank]:
        ev.add_image(pred, gt)
        meter.update(pred[None], gt[None])
    res = ev.evaluate()
    meter.synchronize()
    # the warp term on this rank's rows, with the global valid count and
    # with its own
    from ldmseg_torch.losses.pose_consistency import \
        segmentation_consistency_loss as warp_loss
    from ldmseg_torch.parallel.mesh import group_mean
    rows = [torch.from_numpy(shard_batch(mesh, x)) for x in spec["warp"]]
    warp = {k: float(group_mean(warp_loss(*rows, group=g), mesh))
            for k, g in (("global", mesh.data_group), ("own", None))}
    return {"gathered": gathered, "t": t, "w": module.weight.detach(),
            "warp": warp, "adafactor": adafactor_steps(mesh),
            "pq": {k: res[k] for k in ("pq", "sq", "rq", "tp", "fp", "fn",
                                       "iou_sum")},
            "per_class": res["per_class"],
            "inter": meter.inter, "union": meter.union,
            "miou": meter.return_score()["mIoU"]}


def fail_on(rank: int, which: int) -> int:
    """Raise on rank ``which`` (the launcher's failure path)."""
    if rank == which:
        raise ValueError(f"from rank {rank}")
    return rank


def main_ldm_runs(rank: int, runs: list) -> list:
    """``tools/main_ldm.main`` for each argument list in turn, the ranks
    meeting at a barrier between runs: each run's optimizer steps and
    masters."""
    import torch.distributed as dist
    from ldmseg_torch.tools import main_ldm

    torch.set_num_threads(1)
    out = []
    for argv in runs:
        trainer = main_ldm.main(argv)
        out.append({"step": trainer.state.step,
                    "masters": {n: p.detach().clone()
                                for n, p in trainer.unet.named_parameters()}})
        dist.barrier()
    return out


def hang_on(rank: int, which: int) -> int:
    """Outlive any deadline on rank ``which`` (the launcher's kill)."""
    import time
    if rank == which:
        time.sleep(600)
    return rank


# ---------------------------------------------------------------------------
# the model axis: tensor and spatial parallelism
# ---------------------------------------------------------------------------
def tp_unet(rank: int, cases: list) -> list:
    """For each case ``{"unet_kw", "sd", "x", "t"}`` on a ``(1, 2)`` mesh:
    the whole UNet of ``sd`` cut by ``apply_tp``, its forward on ``x``
    (NCHW) and the gradients of ``mean(out ** 2)``: the output, the loss,
    this rank's gradient shards and the layout."""
    from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig
    from ldmseg_torch.parallel import tp

    torch.set_num_threads(1)
    mesh = make_mesh(1, 2)
    out = []
    for case in cases:
        with torch.device("meta"):
            unet = UNet2DCondition(UNetConfig(**case["unet_kw"]))
        unet.to_empty(device="cpu")
        unet.load_state_dict(case["sd"], strict=True)
        tp.apply_tp(mesh, unet)
        y = unet(torch.from_numpy(case["x"]), torch.from_numpy(case["t"]))
        loss = (y ** 2).mean()
        loss.backward()
        out.append({"out": y.detach(), "loss": loss.item(),
                    "grads": {n: p.grad for n, p in unet.named_parameters()},
                    "layout": tp.layout(unet),
                    "attn_tp": [isinstance(m.to_q, tp.ColumnLinear)
                                and isinstance(m.to_out[0], tp.RowLinear)
                                for m in unet.modules()
                                if hasattr(m, "to_q")]})
    return out


def _sp_module(kind: str, sd: dict):
    """The port module of an SP case, its weights from ``sd``."""
    from torch import nn

    from ldmseg_torch.models import image_vae, layers, seg_vae
    from ldmseg_torch.parallel import sp
    kinds = {
        "conv_s2": lambda: nn.Conv2d(8, 8, 3, stride=2, padding=1),
        "down_pad": lambda: image_vae._Downsample(8),
        "nearest_conv": lambda: image_vae._Upsample(8),
        "bilinear_2": lambda: seg_vae.SegVAE(**sd["kw"]),
        "bilinear_4": lambda: seg_vae.SegVAE(**sd["kw"]),
        "resize": lambda: seg_vae.Resize(8),
        "group_norm": lambda: layers.GroupNorm(4, 8, 1e-6),
        "seg_encode": lambda: seg_vae.SegVAE(**sd["kw"]),
        "seg_decode": lambda: seg_vae.SegVAE(**sd["kw"]),
        "image_encode": lambda: image_vae.ImageVAE(**sd["kw"]),
        "replicated": lambda: seg_vae.SegVAE(**sd["kw"]),
    }
    m = kinds[kind]()
    if sd.get("state"):
        m.load_state_dict(sd["state"], strict=True)
    m = sp.apply_sp(m.to(sd.get("dtype", torch.float32)))
    if kind.startswith("bilinear"):
        return m.upsample, 1
    if kind in ("seg_encode", "replicated"):
        return m.encoder, m.downsample_factor
    if kind == "seg_decode":
        return (lambda z: m.decode(z, True)), 1
    if kind == "image_encode":
        return (lambda x: m.quant_conv(m.encoder(x))), 8
    if kind == "resize":
        return m, 8
    return m, (2 if kind in ("conv_s2", "down_pad") else 1)


def sp_layers(rank: int, cases: list) -> list:
    """For each case ``(kind, sd, x)`` on a ``(1, 2)`` mesh: the port's
    layer or VAE stage run by ``sp.run_stage`` on this rank's rows of
    ``x`` (NCHW), the output gathered; with the stage's sharded and
    replicated counts."""
    from ldmseg_torch.parallel import sp

    torch.set_num_threads(1)
    mesh = make_mesh(1, 2)
    out = []
    for kind, sd, x in cases:
        fn, stride = _sp_module(kind, sd)
        before = (sp.run_stage.sharded, sp.run_stage.replicated)
        x = torch.from_numpy(x).to(sd.get("dtype", torch.float32))
        with torch.no_grad():
            y = sp.run_stage(fn, x, mesh, stride)
        out.append({"out": y.float(),
                    "sharded": sp.run_stage.sharded - before[0],
                    "replicated": sp.run_stage.replicated - before[1]})
    return out


def model_axis_stage2(rank: int, spec: dict) -> dict:
    """On a ``(2, 2)`` mesh: one ``TrainerDiffusion`` step with
    ``tensor_parallel``, ``spatial_parallel`` and ZeRO-1 on this data
    rank's rows and draws (the loss, this rank's gradient shards before the
    clip, its masters after, the optimizer state's bytes, a checkpoint and
    whether a fresh trainer on the mesh resumes it bit-equal);
    one step of ``acc_cfg`` (accumulation, EMA) over ``acc_micro`` (the
    gradients, masters and EMA shards); then a bf16 trainer's
    ``sample_panoptic`` on the same weights with the given initial noise
    (logits and x0)."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.parallel.mesh import group_mean

    torch.set_num_threads(1)
    mesh = make_mesh(2, 2)
    trainer = tl.TrainerDiffusion(
        spec["cfg"], unet_config=UNetConfig(**spec["unet_kw"]),
        device="cpu", results_folder=spec["folder"], mesh=mesh)
    trainer.load_jax_params(*spec["params"])
    steps: list = []
    _capture_steps(trainer.state.optimizer, steps)
    batch, draws = spec["micro"]
    loss, _, _ = trainer.forward_backward(
        shard_batch(mesh, batch), noise=_rows(draws["noise"], mesh),
        timesteps=_rows(draws["timesteps"], mesh))
    trainer.state.apply_gradients()
    saved = trainer.save(tag="tp_checkpoint")
    named = list(trainer.unet.named_parameters())
    # the one-rank checkpoint resumed onto the mesh: this rank's shards
    import torch.distributed as dist
    dist.barrier()  # the main process has written it
    again = tl.TrainerDiffusion(
        spec["cfg"], unet_config=UNetConfig(**spec["unet_kw"]),
        device="cpu", mesh=mesh)
    again.load_jax_params(*spec["params"])
    again.resume(saved)
    opt, opt2 = (t.state.optimizer.torch_opt for t in (trainer, again))
    resumed = (again.state.step == trainer.state.step and all(
        torch.equal(p, q) for (_, p), q in zip(
            named, again.unet.parameters())) and all(
        torch.equal(v, opt2.state[q][k])
        for p, q in zip(trainer.unet.parameters(), again.unet.parameters())
        for k, v in opt.state.get(p, {}).items()))
    del again
    out = {"loss": float(group_mean(loss, mesh)),
           "grads": _named(named, steps)[0],
           "masters": {n: p.detach().clone() for n, p in named},
           "layout": tp.layout(trainer.unet),
           "state_bytes": trainer.state.optimizer.state_bytes(),
           "saved": saved, "resumed": resumed,
           "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank}
    del trainer
    # accumulation and EMA on the mesh: two micro-batches, one step
    acc = tl.TrainerDiffusion(
        spec["acc_cfg"], unet_config=UNetConfig(**spec["unet_kw"]),
        device="cpu", mesh=mesh)
    acc.load_jax_params(*spec["params"])
    acc_steps: list = []
    _capture_steps(acc.state.optimizer, acc_steps)
    for batch, draws in spec["acc_micro"]:
        acc.forward_backward(shard_batch(mesh, batch),
                             noise=_rows(draws["noise"], mesh),
                             timesteps=_rows(draws["timesteps"], mesh))
        acc.state.apply_gradients()
    named = list(acc.unet.named_parameters())
    out["acc"] = {"step": acc.state.step,
                  "grads": _named(named, acc_steps)[0],
                  "masters": {n: p.detach().clone() for n, p in named},
                  "ema": {n: e.detach().clone() for (n, _), e in
                          zip(named, acc.state.ema_params)}}
    del acc
    sampler = tl.TrainerDiffusion(
        spec["sample_cfg"], unet_config=UNetConfig(**spec["unet_kw"]),
        device="cpu", mesh=mesh)
    sampler.load_jax_params(*spec["params"])
    logits, x0 = sampler.sample_panoptic(
        shard_batch(mesh, spec["sample_batch"]),
        init_noise=_rows(spec["init"], mesh), num_inference_steps=2)
    out.update(logits=logits, x0=x0)
    return out
