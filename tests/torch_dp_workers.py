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


# ---------------------------------------------------------------------------
# serving on the model axis: the int8 UNet under tensor parallelism, the
# int8 VAEs under spatial parallelism, contexts and guidance
# ---------------------------------------------------------------------------
def _int8_codes(unet) -> dict:
    """Every code and scale a prepared int8 UNet holds: the s8 convs' and
    linears' buffers, K3's and K4's packs (by module name and field)."""
    from ldmseg_torch.ops.quant import QuantConv2d, QuantLinear
    out = {}
    for name, m in unet.named_modules():
        if isinstance(m, (QuantConv2d, QuantLinear)) and m.w_q is not None:
            out[f"{name}.w_q"] = m.w_q.clone()
            out[f"{name}.w_scale"] = m.w_scale.clone()
        pack = getattr(m, "pack", None)
        if pack is not None and hasattr(pack, "w_qkv"):
            for f in ("w_qkv", "m_qkv", "wo", "wo_q", "w_scale", "out_b"):
                out[f"{name}.pack.{f}"] = getattr(pack, f).clone()
            out[f"{name}.pack.heads"] = pack.heads
        elif pack is not None and hasattr(pack, "w1"):
            for f in ("w1", "s1", "b1", "w2", "s2", "b2"):
                out[f"{name}.pack.{f}"] = getattr(pack, f).clone()
    return out


def _cut(ax, layers: list) -> None:
    """``apply_tp``'s cut of loose layers: ``(linear, dim, pairs)``, a
    row-parallel one (dim 1) given ``RowLinear``'s class and axis."""
    from ldmseg_torch.parallel import tp
    for m, dim, pairs in layers:
        m.weight.data = tp.local_tensor(m.weight.data, dim, ax, pairs)
        if m.bias is not None and dim == 0:
            m.bias.data = tp.local_tensor(m.bias.data, 0, ax, pairs)
        if dim == 1:
            m.__class__, m.tp = tp.RowLinear, ax


def _partial_modes(mesh, cases: list) -> list:
    """The K3/K4/K12/K13 plain versions' partial modes on this rank's
    shard of each case: the op with the model group (what the int8 blocks
    pass as ``group``), on a whole pack cut by
    ``apply_tp``'s rules."""
    from ldmseg_torch.ops import attention_s8 as A
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.parallel.sp import model_axis
    ax = model_axis(mesh)
    group = tp.ModelGroup(ax)
    out = []
    for case in cases:
        x, kind = case.get("x"), case["kind"]
        if kind == "K3":
            norm, attn = case["modules"]
            _cut(ax, [(attn.to_q, 0, 1), (attn.to_k, 0, 1),
                      (attn.to_v, 0, 1), (attn.to_out[0], 1, 1)])
            p = A.pack_ln_attention(norm, attn, case["heads"], case["xs"])
            y = A.ln_attention_s8(x, p, group)
        elif kind in ("K4", "K12"):
            norm, ff = case["modules"]
            _cut(ax, [(ff.net[0].proj, 0, 2), (ff.net[2], 1, 1)])
            p = G.pack_geglu(norm, ff.net[0].proj, ff.net[2], case["xs"],
                             case["gs"])
            if kind == "K4":
                y = G.geglu_ln_s8(x, p, group)
            else:
                y = G.fused_geglu_s8(x, p, group)
        else:  # K13 on this rank's heads
            q, k, v = (tp.local_tensor(t, 2, ax) for t in case["qkv"])
            y = A.fused_self_attention_s8(q, k, v, case["scale"],
                                          case["act_scale"], group)
            y = tp.gather_from(y, ax, 2)
        out.append(y)
    return out


def serving(rank: int, spec: dict) -> dict:
    """On a ``(1, 2)`` mesh: the plain versions' partial modes of the cases
    ``spec["partial"]``; for each of ``spec["trainers"]`` (``{key: {"cfg",
    "calibrate", "direct"}}``, the tiny UNet of ``unet_kw``, the JAX
    weights of ``params``) a trainer on the mesh: its calibrated scales
    (and ``calibrate_act_scale_tree`` on its cut masters at ``calib_x``,
    ``calib_t`` with ``direct``), its int8 UNet's codes (with the scales
    ``code_scales``), an int8
    ``sample_panoptic`` from ``init`` (x0, logits, the stages run whole,
    the int8 UNet's bytes); and with ``spec["vaes"]`` the int8 VAEs alone
    under spatial parallelism (the image encoder's moments, the seg
    decode)."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.ops.quant import QuantConv2d, calibrate_act_scale_tree
    from ldmseg_torch.parallel import sp

    torch.set_num_threads(1)
    mesh = make_mesh(1, 2)
    out = {"partial": _partial_modes(mesh, spec.get("partial", []))}
    for key, run in spec.get("trainers", {}).items():
        tr = tl.TrainerDiffusion(run["cfg"], unet_config=UNetConfig(
            **spec["unet_kw"]), device="cpu", mesh=mesh)
        tr.load_jax_params(*spec["params"])
        res = out[key] = {}
        if run.get("calibrate"):
            res["scales"] = tr.calibrate_int8({"image": spec["image"]},
                                              noise=spec["calib_noise"])
        else:
            tr._params_pretrained = False  # the default scales
        if run.get("direct"):
            with torch.no_grad():
                res["direct"] = calibrate_act_scale_tree(
                    tr._eval_unet, torch.from_numpy(spec["calib_x"]),
                    torch.from_numpy(spec["calib_t"]))
        before = sp.run_stage.replicated
        # the dynamic per-tensor amax that each s8 conv without a static
        # scale (the Down- and Upsample convs) reads from its input
        amaxes = res["dynamic_amax"] = []
        hooks = [m.register_forward_pre_hook(
            lambda m, args: amaxes.append(args[0].detach().abs().amax()))
            for m in tr._unet_int8.modules()
            if isinstance(m, QuantConv2d) and m.site_scale() is None]
        res["logits"], res["x0"] = tr.sample_panoptic(
            {"image": spec["image"]}, init_noise=spec["init"],
            num_inference_steps=spec["steps"])
        for h in hooks:
            h.remove()
        res["replicated"] = sp.run_stage.replicated - before
        # the codes with the same scales as the one-rank UNet's
        tr._int8_act_scales = spec.get("code_scales")
        res["codes"] = _int8_codes(tr.int8_unet())
        res["bytes"] = sum(p.numel() * p.element_size()
                           for p in tr._unet_int8.parameters())
        del tr
    vaes = spec.get("vaes")
    if vaes:
        from ldmseg_torch.models.image_vae import ImageVAE
        from ldmseg_torch.models.seg_vae import SegVAE
        from ldmseg_torch.ops.quant import prepare_int8_vae
        ivae = ImageVAE(**vaes["image_kw"])
        ivae.load_state_dict(vaes["image_sd"], strict=True)
        svae = SegVAE(**vaes["seg_kw"])
        svae.load_state_dict(vaes["seg_sd"], strict=True)
        for m in (ivae, svae):
            sp.apply_sp(prepare_int8_vae(m.to(vaes["dtype"]).eval()))
        before = sp.run_stage.replicated
        with torch.no_grad():
            moments = sp.run_stage(
                lambda x: ivae.quant_conv(ivae.encoder(x)),
                vaes["rgb"].to(vaes["dtype"]), mesh, 8)
            logits = sp.run_stage(lambda z: svae.decode(z, True),
                                  vaes["z"].to(vaes["dtype"]), mesh)
        out["vaes"] = {"moments": moments.float(), "logits": logits.float(),
                       "replicated": sp.run_stage.replicated - before}
    if spec.get("context"):
        out["context"] = _context_runs(mesh, spec["context"])
    return out


def _context_runs(mesh, spec: dict) -> dict:
    """The conditioning paths on the mesh, each a trainer with
    ``tensor_parallel`` and ``spatial_parallel``: a guided
    ``sample_panoptic`` with the ``none`` descriptor on a caller's context
    (``encoder_hid_proj`` on it), and one training step with ``learnable``
    queries (the loss, this rank's gradient shards, the layout)."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.models.descriptors import DescriptorSpec
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.parallel import tp

    out = {}
    g = spec["guided"]
    tr = tl.TrainerDiffusion(
        g["cfg"], unet_config=UNetConfig(**g["unet_kw"]), device="cpu",
        mesh=mesh, descriptor=DescriptorSpec(kind="none",
                                             use_cross_attention=True))
    tr.load_jax_params(*g["params"])
    logits, x0 = tr.sample_panoptic(g["batch"], init_noise=g["init"],
                                    num_inference_steps=g["steps"],
                                    guidance_scale=g["guidance"])
    blk = tr.unet.down_blocks[0].attentions[0].transformer_blocks[0]
    out["guided"] = {
        "logits": logits, "x0": x0,
        "column_attn2": isinstance(blk.attn2.to_k, tp.ColumnLinear)
        and not blk.attn2.to_k.gather
        and isinstance(blk.attn2.to_out[0], tp.RowLinear),
        "column_hid_proj": isinstance(tr.unet.encoder_hid_proj,
                                      tp.ColumnLinear)
        and tr.unet.encoder_hid_proj.gather}
    del tr
    q = spec["learnable"]
    tr = tl.TrainerDiffusion(
        q["cfg"], unet_config=UNetConfig(**q["unet_kw"]), device="cpu",
        mesh=mesh, descriptor=DescriptorSpec(
            kind="learnable", use_cross_attention=True,
            num_object_queries=q["unet_kw"]["num_object_queries"]))
    tr.load_jax_params(*q["params"])
    loss, _, _ = tr.forward_backward(q["batch"], noise=q["noise"],
                                     timesteps=q["timesteps"])
    out["learnable"] = {
        "loss": float(loss), "layout": tp.layout(tr.unet),
        "grads": {n: p.grad.detach().clone()
                  for n, p in tr.unet.named_parameters()}}
    return out


def uneven_axis(rank: int, spec: dict) -> dict:
    """On a ``(1, spec["model"])`` mesh with tensor parallelism, for each
    of ``spec["trainers"]`` (``{key: cfg}``, the UNet of ``unet_kw`` or of
    ``unet_kws[key]``, the
    weights of ``init_params(seed)``): an int8 (or float)
    ``sample_panoptic`` from ``init`` (x0), the int8 (or float) UNet's
    modules that hold the model group (``tp_group``) and its cut
    parameters."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.parallel import tp

    torch.set_num_threads(1)
    mesh = make_mesh(1, spec["model"])
    out = {}
    for key, cfg in spec["trainers"].items():
        kw = spec.get("unet_kws", {}).get(key, spec.get("unet_kw"))
        tr = tl.TrainerDiffusion(cfg, unet_config=UNetConfig(**kw),
                                 device="cpu", mesh=mesh)
        tr.init_params(seed=spec["seed"])
        _, x0 = tr.sample_panoptic({"image": spec["image"]},
                                   init_noise=spec["init"],
                                   num_inference_steps=spec["steps"])
        unet = tr._unet_int8 if tr._unet_int8 is not None else tr.unet
        out[key] = {"x0": x0,
                    "grouped": {n for n, m in unet.named_modules()
                                if getattr(m, "tp_group", None) is not None},
                    "cut": set(tp.layout(unet))}
        del tr
    return out


# ---------------------------------------------------------------------------
# packed and absorbed attention on the model axis (K14-K17 on a rank's
# heads), and compute_pq there
# ---------------------------------------------------------------------------
def _absorbed_packs(unet) -> dict:
    """Every K17 pack a prepared int8 UNet holds, by module name and field
    (``heads`` as an int)."""
    out = {}
    for name, m in unet.named_modules():
        pack = getattr(m, "pack", None)
        if pack is not None and hasattr(pack, "wo_p"):
            for f in ("w_qkv", "wo_q", "w_scale", "wo_p"):
                out[f"{name}.pack.{f}"] = getattr(pack, f).clone()
            out[f"{name}.pack.heads"] = pack.heads
    return out


def attention_axis(rank: int, spec: dict) -> dict:
    """On a ``(1, 2)`` mesh, for each ``{key: run}`` of ``spec["runs"]`` a
    trainer of ``run["cfg"]`` on the UNet of ``run["unet_kw"]`` with the
    JAX weights ``spec["params"]``: ``run["kind"]`` "step" (one
    ``forward_backward`` on ``spec["batch"]`` with ``spec["draws"]``, then
    the optimizer step: the group's mean loss, this rank's gradient shards
    before the clip, its masters after, the layout), "sample" (a
    ``sample_panoptic`` from ``spec["init"]``: logits, x0) or "int8"
    (``calibrate_int8`` on ``spec["calib_noise"]``, then, on
    ``run["scales"]`` where given, one int8 UNet forward of
    ``spec["forward"]`` and the sample: the scales, forward, logits, x0,
    the int8 UNet's K17 packs and the modules holding the model group).
    Each also returns the fallbacks of K14-K17 it took."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.parallel.mesh import group_mean

    torch.set_num_threads(1)
    mesh = make_mesh(1, 2)
    counters = (A.fused_self_attention_packed, A.absorbed_self_attention,
                S8.fused_self_attention_packed_s8,
                S8.absorbed_self_attention_s8)
    out = {}
    for key, run in spec["runs"].items():
        before = [f.fallbacks for f in counters]
        tr = tl.TrainerDiffusion(run["cfg"], unet_config=UNetConfig(
            **run["unet_kw"]), device="cpu", mesh=mesh)
        tr.load_jax_params(*spec["params"])
        res = out[key] = {}
        if run["kind"] == "step":
            steps: list = []
            _capture_steps(tr.state.optimizer, steps)
            loss, _, _ = tr.forward_backward(
                spec["batch"], noise=spec["draws"]["noise"],
                timesteps=spec["draws"]["timesteps"])
            tr.state.apply_gradients()
            named = list(tr.unet.named_parameters())
            res.update(loss=float(group_mean(loss, mesh)),
                       grads=_named(named, steps)[0],
                       masters={n: p.detach().clone() for n, p in named},
                       layout=tp.layout(tr.unet))
        else:
            if run["kind"] == "int8":
                res["scales"] = tr.calibrate_int8(
                    {"image": spec["image"]}, noise=spec["calib_noise"])
                if "scales" in run:
                    # sample on the given scales (one rank's): the mesh's
                    # own are an ulp apart from them, which flips codes
                    tr._int8_act_scales = dict(run["scales"])
                x, t = spec["forward"]
                with torch.no_grad():
                    res["forward"] = tr.int8_unet()(
                        x.to(tr.compute_dtype), t).float().permute(
                            0, 2, 3, 1).contiguous()
            res["logits"], res["x0"] = tr.sample_panoptic(
                {"image": spec["image"]}, init_noise=spec["init"],
                num_inference_steps=spec["steps"])
            if run["kind"] == "int8":
                unet = tr.int8_unet()
                res["packs"] = _absorbed_packs(unet)
                res["grouped"] = {n for n, m in unet.named_modules()
                                  if getattr(m, "tp_group", None)
                                  is not None}
        res["fallbacks"] = [f.fallbacks - b for f, b in zip(counters,
                                                             before)]
        del tr
    return out


def attention_partials(rank: int, cases: list) -> list:
    """On a ``(1, 2)`` mesh, each case on this rank's heads of whole
    inputs, through the ops as the UNet calls them: K14 ("K14": q, k, v
    sliced on C, the output gathered), K15 ("K15": the same with the model
    group, and the three scales ``s8_scales`` gives on the rank's head
    views with the group), K16 ("K16": wq, wk, wv's rows and wo's columns,
    the fp32 partial summed over the group and rounded once) and K17
    ("K17": a pack of the cut attention, whose fields are returned, its
    fp32 partial summed and rounded once to bf16). Returns each case's
    output (and fields)."""
    from ldmseg_torch.ops import attention as A
    from ldmseg_torch.ops import attention_s8 as S8
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.parallel.sp import model_axis

    torch.set_num_threads(1)
    mesh = make_mesh(1, 2)
    ax = model_axis(mesh)
    group = tp.ModelGroup(ax)
    out = []
    for case in cases:
        kind, heads = case["kind"], case["heads"] // 2
        res = {}
        if kind in ("K14", "K15"):
            q, k, v = (tp.local_tensor(z, 2, ax) for z in case["qkv"])
            if kind == "K14":
                y = A.fused_self_attention_packed(q, k, v, heads,
                                                  case["scale"])
            else:
                y = S8.fused_self_attention_packed_s8(q, k, v, heads,
                                                      case["scale"], group)
                qh, kh, vh = (z.unflatten(-1, (heads, -1)) for z in (q, k, v))
                res["scales"] = torch.stack(S8.s8_scales(qh, kh, vh, None,
                                                         group))
            res["out"] = tp.gather_from(y, ax, 2)
        elif kind == "K16":
            wq, wk, wv = (tp.local_tensor(w, 0, ax) for w in case["w"][:3])
            wo = tp.local_tensor(case["w"][3], 1, ax)
            x = group.copy_to(case["x"])
            part = A.absorbed_self_attention(x, wq, wk, wv, wo, heads,
                                             case["scale"], partial=True)
            res["partial"] = part
            res["out"] = group.reduce_from(part).to(x.dtype)
        else:  # K17
            attn = case["attn"]
            _cut(ax, [(attn.to_q, 0, 1), (attn.to_k, 0, 1),
                      (attn.to_v, 0, 1), (attn.to_out[0], 1, 1)])
            p = S8.pack_absorbed_attention(attn, heads, case["xs"])
            part = S8.absorbed_self_attention_s8(
                case["x"], p.w_qkv, p.wo_q, p.w_scale, heads, case["scale"],
                p.xs, p.wo_p, partial=True)
            res["pack"] = {f: getattr(p, f)
                           for f in ("w_qkv", "wo_q", "w_scale", "wo_p")}
            res["partial"] = part
            res["out"] = group.sum(part).to(torch.bfloat16)
        out.append(res)
    return out


def _sharpen_seg_decoder(trainer, factor: float) -> None:
    """Random weights give flat logits, which post-processing drops: the
    seg decoder's last convolution scaled by ``factor`` and shifted so that
    about one class a pixel has a positive logit on a seeded latent
    (``test_torch_port_sampling._sharpen``'s rule, in the weights)."""
    conv = [m for m in trainer.vae_seg.modules()
            if isinstance(m, torch.nn.Conv2d)][-1]
    gen = torch.Generator().manual_seed(0)
    z = torch.randn((2, 4, 4, 8), generator=gen).to(conv.weight.dtype)
    with torch.no_grad():
        logits = trainer.vae_seg.decode(z, False).float() * factor
        shift = float(torch.quantile(logits.flatten()[::7], 0.96))
        conv.weight.mul_(factor)
        conv.bias.mul_(factor).sub_(shift)


def compute_pq_axis(rank: int, spec: dict) -> dict:
    """``compute_pq`` on a ``(1, 2)`` mesh with ``tensor_parallel``: the
    trainer of ``spec["cfg"]`` from ``init_params(spec["seed"])`` (the seg
    decoder sharpened by ``spec["sharpen"]``) on the KITTI-DVPS val tree at
    ``spec["root"]``, ``spec["steps"]`` DDIM steps. Returns its results."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.data import KittiDVPS
    from ldmseg_torch.models.unet import UNetConfig

    torch.set_num_threads(1)
    mesh = make_mesh(1, 2)
    ds = KittiDVPS(prefix=spec["root"], split="val", size=spec["size"],
                   keep_fullres_gt=True)
    tr = tl.TrainerDiffusion(spec["cfg"], unet_config=UNetConfig(
        **spec["unet_kw"]), device="cpu", val_dataset=ds, mesh=mesh)
    tr.init_params(seed=spec["seed"])
    _sharpen_seg_decoder(tr, spec["sharpen"])
    return tr.compute_pq(num_inference_steps=spec["steps"])


# ---------------------------------------------------------------------------
# the last int8 options on the model axis: use_fused_projs (K8, K9), K11 on
# a rank's heads, int8_fuse_gn (K6), fused norms on undivided heads
# ---------------------------------------------------------------------------
def int8_packs(unet) -> dict:
    """Every tensor and number of every kernel pack a prepared int8 UNet
    holds (K3/K8's, K4/K9's, K11's, K12's), by module name and field."""
    import dataclasses
    out = {}
    for name, m in unet.named_modules():
        pack = getattr(m, "pack", None)
        if pack is None:
            continue
        for f in dataclasses.fields(pack):
            v = getattr(pack, f.name)
            if v is not None:
                out[f"{name}.pack.{f.name}"] = (
                    v.clone() if isinstance(v, torch.Tensor) else v)
    return out


def int8_option_partials(mesh, cases: list) -> list:
    """K8's, K9's and K11's plain versions (and fallbacks) in their
    model-axis modes on this rank's shard of each case, through the ops as
    the int8 blocks call them: the attention's and the feed-forward's
    layers cut by ``apply_tp``'s rules, the 1x1 convs whole, the packs
    made with the model group (K11's ``max(wos)``), the op with it. With
    ``mesh`` None the one-rank op on the whole pack."""
    from ldmseg_torch.ops import attention_s8 as A
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.parallel.sp import model_axis
    ax = model_axis(mesh)
    group = None if ax is None else tp.ModelGroup(ax)
    out = []
    for case in cases:
        x, kind = case["x"], case["kind"]
        if kind in ("K8", "K11"):
            attn = case["attn"]
            if ax is not None:
                _cut(ax, [(attn.to_q, 0, 1), (attn.to_k, 0, 1),
                          (attn.to_v, 0, 1), (attn.to_out[0], 1, 1)])
        if kind == "K8":
            p = A.with_proj_in(A.pack_ln_attention(
                case["norm"], attn, case["heads"], case["xs"]),
                case["conv"])
            y = A.ln_attention_s8_pin(x, p, group)
        elif kind == "K9":
            ff = case["ff"]
            if ax is not None:
                _cut(ax, [(ff.net[0].proj, 0, 2), (ff.net[2], 1, 1)])
            p = G.with_proj_out(G.pack_geglu(
                case["norm"], ff.net[0].proj, ff.net[2], case["xs"],
                case["gs"]), case["conv"])
            y = G.geglu_ln_s8_pout(x, p, group)
        else:
            p = A.pack_padded_attention(attn, case["heads"], case["xs"],
                                        group=group)
            y = A.padded_attention_s8(x, p, group)
        out.append(y)
    return out


def int8_option_runs(mesh, spec: dict) -> dict:
    """For each ``{key: run}`` of ``spec["runs"]`` a trainer of
    ``run["cfg"]`` (on ``mesh``; None: one rank) on the UNet of
    ``run["unet_kw"]`` with the weights of ``init_params(spec["seed"])``:
    ``calibrate_int8`` on the whole ``spec["image"]`` and
    ``spec["calib_noise"]`` (the scales), then on ``run["scales"]`` where
    given (one rank's) a ``sample_panoptic`` of this data rank's rows of
    ``spec["image"]`` from its rows of ``spec["init"]`` (x0); or with
    ``run["k11"]`` (the K11 UNet's flags) the UNet-level path:
    ``int8_unet_from`` the cut masters (``apply_tp``, then
    ``prepare_int8_unet``) on ``run["scales"]`` and ``spec["steps"]``
    steps of ``ddim_sample`` on its rows of ``spec["rgb"]``. Each with one
    int8 UNet forward of ``spec["forward"]`` (NCHW input, timesteps), the
    int8 UNet's packs, the modules holding the model group, the cut
    parameters and the fallbacks of K3, K4, K6, K8, K9, K11 and K12 it
    took; K11 also with each grouped pack's ``out_scale`` from a
    rank-local ``max(wos)`` (the planted control). ``run["float"]``: the
    float x0 and forward too (the quantization's effect)."""
    import ldmseg_torch.train.trainer_ldm as tl
    from ldmseg_torch.models.unet import PaddedAttentionS8, UNetConfig
    from ldmseg_torch.ops import attention_s8 as A
    from ldmseg_torch.ops import geglu as G
    from ldmseg_torch.ops import groupnorm_silu as GN
    from ldmseg_torch.parallel import tp
    from ldmseg_torch.parallel.mesh import make_mesh as one_rank
    from ldmseg_torch.tools.profile_sampling import (int8_unet_from,
                                                     padded_sample)
    counters = (A.ln_attention_s8, G.geglu_ln_s8, GN.group_norm_silu_quant,
                A.ln_attention_s8_pin, G.geglu_ln_s8_pout,
                A.padded_attention_s8, G.fused_geglu_s8)
    rows = (lambda x: x) if mesh is None else (lambda x: _rows(x, mesh))
    out = {}
    for key, run in spec["runs"].items():
        before = [f.fallbacks for f in counters]
        tr = tl.TrainerDiffusion(run["cfg"], unet_config=UNetConfig(
            **run["unet_kw"]), device="cpu",
            mesh=one_rank() if mesh is None else mesh)
        tr.init_params(seed=spec["seed"])
        res = out[key] = {}
        if run.get("k11"):
            unet = int8_unet_from(tr._eval_unet, run["k11"],
                                  dtype=torch.float32, scales=run["scales"],
                                  mesh=mesh)
            # NCHW latents: the RGB ones beside the noise
            rgb, noise = (torch.from_numpy(rows(spec[k])).permute(0, 3, 1, 2)
                          for k in ("rgb", "init"))
            res["x0"] = padded_sample(unet, rgb, noise, steps=spec["steps"],
                                      graph=False)
            if run.get("float"):
                res["float_x0"] = padded_sample(
                    tr._eval_unet, rgb, noise, steps=spec["steps"],
                    graph=False)
            res["local_out_scale"] = {
                n: A.pack_padded_attention(tr._eval_unet.get_submodule(n),
                                           m.heads, m._xs()).out_scale
                for n, m in unet.named_modules()
                if isinstance(m, PaddedAttentionS8)
                and m.tp_group is not None}
        else:
            res["scales"] = tr.calibrate_int8({"image": spec["image"]},
                                              noise=spec["calib_noise"])
            if "scales" in run:
                tr._int8_act_scales = dict(run["scales"])
            _, res["x0"] = tr.sample_panoptic(
                {"image": rows(spec["image"])}, init_noise=rows(spec["init"]),
                num_inference_steps=spec["steps"])
            if run.get("float"):
                tr.int8_inference = False
                _, res["float_x0"] = tr.sample_panoptic(
                    {"image": rows(spec["image"])},
                    init_noise=rows(spec["init"]),
                    num_inference_steps=spec["steps"])
                tr.int8_inference = True
            unet = tr.int8_unet()
        x, t = (torch.from_numpy(v) for v in spec["forward"])
        with torch.no_grad():
            res["forward"] = unet(x.to(tr.compute_dtype), t).float()
            if run.get("float"):
                res["float_forward"] = tr.inference_unet()(
                    x.to(tr.compute_dtype), t).float()
        res["packs"] = int8_packs(unet)
        res["grouped"] = {n for n, m in unet.named_modules()
                          if getattr(m, "tp_group", None) is not None}
        res["cut"] = set(tp.layout(unet))
        res["fallbacks"] = [f.fallbacks - b for f, b in zip(counters,
                                                             before)]
        del tr, unet
    return out


def int8_options(rank: int, spec: dict) -> dict:
    """On a ``(spec["data"], spec["model"])`` mesh: the partial modes of
    ``spec["partial"]`` (:func:`int8_option_partials`) and the runs of
    :func:`int8_option_runs`."""
    torch.set_num_threads(1)
    mesh = make_mesh(spec.get("data", 1), spec.get("model", 2))
    return {"partial": int8_option_partials(mesh, spec.get("partial", [])),
            **int8_option_runs(mesh, spec)}
