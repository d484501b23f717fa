"""Stage-1 seg-VAE trainer (counterpart of
``ldmseg_tpu/train/trainer_ae.py:TrainerAE``; reference trainers_ae.py).

:meth:`TrainerAE.train_step`: analog bits (and the RGB frame under
``fuse_rgb``) -> the optional inpainting corruption (``prob_inpainting``)
-> the seg VAE on a compute-dtype cast of its fp32 masters, a posterior
sample, the latent zeroed at ignored pixels under ``latent_mask`` -> the
point losses (CE and BCE + Dice) in fp32 and the KL, weighted by
``loss_weights`` -> backward -> the optimizer of the JAX trainer (AdamW by
default, Adafactor, Adam or SGD; the lr schedule, clipping, accumulation,
the EMA with ``ema_on``). :meth:`train_loop` feeds it from the port's
loader, saves, evaluates and writes panels on a cadence. Evaluation
encodes to the posterior mode and decodes with the upsample:
:meth:`compute_miou`, and :meth:`compute_pq` (class-agnostic, the logits
restored to the ground truth's resolution). :meth:`save`/:meth:`resume`
write ``torch.save`` checkpoints as ``TrainerDiffusion`` does (JAX writes
orbax trees of the same content), :meth:`export_reference` the
reference's stage-1 ``{'vae': ...}`` dict that ``main_ldm`` reads through
``vae_model_kwargs.pretrained_path``.

Batches are NHWC at this boundary, as in the JAX package; the model runs
NCHW. Every random draw comes from a ``torch.Generator`` or is handed in
(``draws`` of :meth:`forward_loss`).

Data parallelism (``mesh``, as ``TrainerDiffusion``'s): ``batch_size`` is
the global batch, each data rank trains its rows; the CE's valid-point
count and the mask count are the global batch's (``point_losses(group=)``;
the KL is a mean over equal shards); the gradients are averaged before the
optimizer; ``optimizer_zero_redundancy`` partitions its state (ZeRO-1);
``compute_miou`` and ``compute_pq`` score each rank's share of the val set
and sum the meters. Only the main process writes checkpoints, metrics and
panels.
"""

from __future__ import annotations

import copy
import os
import time
from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.loader import make_loader, prefetch_to_device
from ..losses.point_losses import PointLossConfig, point_losses
from ..models.convert import seg_vae_state_dict_from_jax
from ..models.layers import init_random_
from ..models.seg_vae import SegVAE
from ..parallel.mesh import (check_mesh_device, group_mean, make_mesh,
                             rank_seed, replicate)
from ..parallel.multihost import is_main_process
from ..utils.meters import AverageMeter
from ..utils.metrics_sink import MetricsSink
from ..utils.precision import strict_fp32
from ..utils.visualization import save_train_panel, to_numpy
from .optim import Optimizer, make_lr_schedule, norm_param_names
from .restore import PanopticRestore, resize_logits
from .state import TrainState

LOSS_KEYS = ("ce", "mask", "kl")


class TrainerAE(PanopticRestore):
    """Builds the seg VAE from ``vae_model_kwargs`` on ``device``
    (``"cuda"`` unless the caller asks for the CPU). Call
    :meth:`init_params`, :meth:`load_jax_params` or
    :meth:`load_state_dict` before training or evaluating."""

    def __init__(self, p: dict, device="cuda", dataset=None,
                 val_dataset=None, results_folder: Optional[str] = None,
                 mesh=None):
        # fp32 as the reference computes it, in this process: no TF32
        strict_fp32()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TrainerAE: device 'cuda' asked for but "
                "torch.cuda.is_available() is False; pass "
                "device=torch.device('cpu') to run the plain PyTorch path")
        self.mesh = mesh if mesh is not None else make_mesh()
        check_mesh_device(self.mesh, device, "TrainerAE")
        self.zero1 = bool(p.get("optimizer_zero_redundancy", False))
        self.p, self.device = p, device
        tk, lk = p["train_kwargs"], p["loss_kwargs"]
        vk = dict(p["vae_model_kwargs"])
        vk.pop("pretrained_path", None)
        vk["block_out_channels"] = tuple(vk["block_out_channels"])
        self.vae_kwargs = vk
        with torch.device("meta"):
            self.vae = SegVAE(**vk)
        self.num_classes = vk["out_channels"]
        self.ignore_label = p["ignore_label"]
        self.batch_size = tk["batch_size"]  # the global batch
        self.mesh.local_batch(self.batch_size)
        self.train_num_steps = tk["train_num_steps"]
        self.prob_inpainting = tk.get("prob_inpainting", 0.0)
        self.latent_mask = tk.get("latent_mask", False)
        self.fuse_rgb = vk.get("fuse_rgb", False)
        self.loss_weights = p["loss_weights"]
        # bf16 covers the reference's float16 AMP dtype, as in JAX
        self.compute_dtype = (torch.bfloat16 if tk.get("weight_dtype") in
                              ("bfloat16", "float16") else torch.float32)
        # top-k over the [B, num_classes] histogram: k <= num_classes
        self.loss_cfg = PointLossConfig(
            num_points=lk["num_points"],
            oversample_ratio=lk["oversample_ratio"],
            importance_sample_ratio=lk["importance_sample_ratio"],
            ignore_label=self.ignore_label, temperature=lk["temperature"],
            max_masks=min(lk.get("max_masks", self.num_classes),
                          self.num_classes))
        if self.loss_cfg.max_masks < self.num_classes:
            print(f"WARNING: max_masks={self.loss_cfg.max_masks} < "
                  f"num_classes={self.num_classes}; the mask loss drops the "
                  "smallest segments on crowded scenes", flush=True)
        self.ds, self.ds_val = dataset, val_dataset
        self.results_folder = results_folder or p.get("checkpoint_dir")
        if self.results_folder:
            os.makedirs(self.results_folder, exist_ok=True)
        self.metrics = MetricsSink(
            os.path.join(self.results_folder, "metrics.jsonl")
            if self.results_folder and is_main_process() else None,
            use_wandb=p.get("wandb", False))
        self.ema_on = bool(p.get("ema_on", False))
        self.ema_decay = float((p.get("ema_kwargs") or {}).get("decay",
                                                               0.9999))
        self.state: Optional[TrainState] = None
        self._eval_vae = None
        self.best_pq = -1.0
        # the post-processing thresholds of compute_pq (its arguments)
        self.mask_th, self.count_th, self.overlap_th = 0.5, 128, 0.5

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights (the frozen codebook: its own QR)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.vae.to_empty(device=self.device)
        init_random_(self.vae, gen)
        self._ready()

    def load_jax_params(self, variables: Mapping) -> None:
        """Adopt the JAX ``TrainState`` params (the SegVAE's variables as
        nested dicts of numpy arrays; the ``"constants"`` collection beside
        ``"params"`` under ``freeze_codebook``)."""
        self.load_state_dict(seg_vae_state_dict_from_jax(variables,
                                                         self.vae_kwargs))

    def load_state_dict(self, sd: Mapping) -> None:
        self.vae.to_empty(device=self.device)
        self.vae.load_state_dict(sd, strict=True)
        self._ready()

    def _ready(self) -> None:
        replicate(self.mesh, self.vae)  # the first data rank's weights
        self.vae.train().requires_grad_(True)
        self._eval_vae = self.vae
        if self.ema_on:
            self._eval_vae = copy.deepcopy(self.vae).requires_grad_(False)
        p, tk = self.p, self.p["train_kwargs"]
        ok, sk = p["optimizer_kwargs"], p["lr_scheduler_kwargs"]
        schedule = make_lr_schedule(
            p.get("lr_scheduler_name", "warmup"), ok["lr"],
            self.train_num_steps, warmup_iters=sk.get("warmup_iters", 200),
            final_lr=sk.get("final_lr", 1e-6))
        optimizer = Optimizer(
            list(self.vae.named_parameters()),
            p.get("optimizer_name", "adamw"), learning_rate=schedule,
            betas=tuple(ok.get("betas", (0.9, 0.999))),
            weight_decay=ok.get("weight_decay", 0.0),
            weight_decay_norm=ok.get("weight_decay_norm"),
            clip_grad=tk.get("clip_grad", 0.0), mesh=self.mesh,
            zero1=self.zero1, norm_names=norm_param_names(self.vae))
        self.state = TrainState(
            optimizer, accumulate=tk.get("accumulate", 1),
            ema_params=(list(self._eval_vae.parameters()) if self.ema_on
                        else None), ema_decay=self.ema_decay,
            group=self.mesh.data_group)

    def _require_params(self) -> None:
        if self.state is None:
            raise RuntimeError("TrainerAE: call init_params or "
                               "load_jax_params first")

    def _compute_vae(self, vae) -> callable:
        """``vae``'s forward on its weights and buffers cast to the compute
        dtype (differentiable, so the gradients land in fp32 on the
        masters)."""
        if self.compute_dtype == torch.float32:
            return vae
        tensors = {n: t.to(self.compute_dtype) for n, t in
                   [*vae.named_parameters(), *vae.named_buffers()]}
        return lambda *a, **k: torch.func.functional_call(vae, tensors, a, k)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _nchw(self, x, dtype) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device).to(dtype)
        return x.permute(0, 3, 1, 2).contiguous()

    def corrupt_inputs(self, images: torch.Tensor, targets: torch.Tensor,
                       generator=None, draws=None):
        """The sparse-visibility corruption (trainers_ae.py:303-311): per
        image a strength ``u1 * prob_inpainting``, a 32x32 map ``u2 <
        strength`` upsampled nearest to the label size, zero at the ignore
        label; the images are blanked outside it. ``draws`` is ``(u1 [B,
        1, 1], u2 [B, 32, 32])``. Returns ``(images, mask [B, H, W])``."""
        b = images.shape[0]
        if draws is None:
            u1 = torch.rand((b, 1, 1), generator=generator,
                            device=self.device)
            u2 = torch.rand((b, 32, 32), generator=generator,
                            device=self.device)
        else:
            u1, u2 = (torch.as_tensor(np.array(d), device=self.device)
                      .float() for d in draws)
        noise = (u2 < u1 * self.prob_inpainting).float()
        m = F.interpolate(noise[:, None], size=tuple(targets.shape[1:]),
                          mode="nearest-exact")[:, 0]
        m = torch.where(targets == self.ignore_label, torch.zeros_like(m), m)
        images = torch.where(m[:, None] > 0, images,
                             torch.zeros_like(images))
        return images, m

    def forward_loss(self, batch: Mapping,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Mapping] = None):
        """The weighted loss of one batch, with graph, and its parts
        ``{"ce", "mask", "kl"}``. ``draws`` replaces the generator's
        numbers: ``"noise"`` (the posterior sample's, NCHW), ``"corrupt"``
        (:meth:`corrupt_inputs`), ``"points"`` (the point losses')."""
        self._require_params()
        draws = draws or {}
        dt = self.compute_dtype
        images = 2.0 * self._nchw(batch["image_semseg"], dt) - 1.0
        targets = torch.as_tensor(batch["semseg"], device=self.device).long()
        rgbs = None
        if self.fuse_rgb:
            # the RGB frame beside the bits (trainers_ae.py:299-301)
            rgbs = 2.0 * self._nchw(batch["image"], dt) - 1.0
        corrupt = None
        if self.prob_inpainting > 0:
            images, corrupt = self.corrupt_inputs(images, targets, generator,
                                                  draws.get("corrupt"))
        valid = None
        if self.latent_mask:
            f = self.vae.downsample_factor
            t = F.interpolate(targets[:, None].float(),
                              size=(images.shape[2] // f,
                                    images.shape[3] // f),
                              mode="nearest-exact")[:, 0]
            valid = (t != self.ignore_label).to(dt)
        logits, posterior = self._compute_vae(self.vae)(
            images, sample_posterior=True, rgb_sample=rgbs, valid_mask=valid,
            generator=generator, noise=draws.get("noise"))
        losses = point_losses(logits.float(), targets, self.loss_cfg,
                              corrupt_mask=corrupt, generator=generator,
                              draws=draws.get("points"),
                              group=self.mesh.loss_group)
        losses["kl"] = posterior.kl().mean()
        total = sum(self.loss_weights[k] * v for k, v in losses.items())
        return total, losses

    def train_step(self, batch: Mapping,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Mapping] = None):
        """:meth:`forward_loss`, backward, then the optimizer (every
        ``accumulate`` micro-batches). Returns ``(loss, parts)``, detached,
        on the device."""
        loss, parts = self.forward_loss(batch, generator, draws)
        loss.backward()
        self.state.apply_gradients()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}

    def train_loop(self, max_steps: Optional[int] = None,
                   log_every: int = 20, seed: int = 0,
                   save_every: int = 1000,
                   vis_every: Optional[int] = None,
                   eval_every: Optional[int] = None,
                   eval_kwargs: Optional[dict] = None) -> List[float]:
        """Train on ``dataset`` for ``max_steps`` steps (default
        ``train_num_steps``), the draws from a generator seeded ``seed``,
        batches from the threaded loader through the double-buffered H2D.
        Losses are read back every ``log_every`` steps (printed, logged to
        ``metrics.jsonl``); :meth:`save` every ``save_every`` optimizer
        steps; with ``eval_every`` (default ``eval_kwargs.eval_every``) the
        mIoU and PQ before the first step and every ``eval_every`` steps,
        the best PQ saved as ``best_model``; with ``vis_every`` a panel
        every ``vis_every`` steps (:meth:`save_train_images`). Returns
        every step's loss (the data group's means; each data rank draws
        from a generator seeded by ``(seed, data rank)``)."""
        if self.ds is None:
            raise ValueError("TrainerAE.train_loop needs a dataset")
        self._require_params()
        if eval_every is None:
            eval_every = self.p["eval_kwargs"].get("eval_every")
        loader = make_loader(self.ds, self.batch_size, seed=seed,
                             mesh=self.mesh)
        if len(loader) == 0:
            raise ValueError(f"dataset of {len(self.ds)} samples gives no "
                             f"batch of {self.batch_size}")
        max_steps = max_steps or self.train_num_steps
        eval_kw = dict(eval_kwargs or {})
        main = is_main_process()
        generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, self.mesh))
        meters = {k: AverageMeter(k, ":.4f") for k in ("loss",) + LOSS_KEYS}
        losses: List[float] = []
        pending: List[torch.Tensor] = []
        if eval_every:
            self._eval_during_training(self.state.step, eval_kw)
        step, epoch, t0 = 0, 0, time.perf_counter()
        while step < max_steps:
            batches = prefetch_to_device(loader.epoch(epoch), self.device)
            try:
                for batch in batches:
                    before = self.state.step
                    loss, parts = self.train_step(batch, generator)
                    pending.append(torch.stack(
                        [loss] + [parts[k].float() for k in LOSS_KEYS]))
                    step += 1
                    gstep = self.state.step
                    if step % log_every == 0 or step == max_steps:
                        rows = group_mean(torch.stack(pending),
                                          self.mesh).tolist()
                        pending.clear()
                        for row in rows:
                            for meter, v in zip(meters.values(), row):
                                meter.update(v, self.batch_size)
                        losses += [r[0] for r in rows]
                        self.metrics.log(gstep, **dict(zip(meters,
                                                           rows[-1])))
                        if main:
                            print(f"Epoch [{epoch}] step {step}/"
                                  f"{max_steps}: "
                                  + " ".join(f"{k} {m.avg:.4f}"
                                             for k, m in meters.items())
                                  + f" ({time.perf_counter() - t0:.1f} s)",
                                  flush=True)
                    if gstep != before:
                        if save_every and gstep % save_every == 0:
                            self.save(gstep)
                        if eval_every and gstep % eval_every == 0:
                            self._eval_during_training(gstep, eval_kw)
                        if vis_every and gstep % vis_every == 0 and main:
                            self.save_train_images(batch, gstep)
                    if step >= max_steps:
                        break
            finally:
                batches.close()
            epoch += 1
        if main:
            print(f"Training finished in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        return losses

    def _eval_during_training(self, step: int, eval_kw: dict):
        """mIoU and PQ with the best-PQ snapshot (trainers_ae.py:391-445)."""
        if self.ds_val is None:
            return None
        res = self.compute_metrics(("miou", "pq"), **eval_kw)
        pq = res["pq"]["pq"]
        if pq > self.best_pq:
            self.best_pq = pq
            self.save(tag="best_model")
        self.metrics.log(step, pq=pq, miou=res["miou"]["mIoU"],
                         best_pq=self.best_pq)
        if is_main_process():
            print(f"[eval @ step {step}] PQ {pq:.2f} mIoU "
                  f"{res['miou']['mIoU']:.4f} (best {self.best_pq:.2f})",
                  flush=True)
        return res

    def save_train_images(self, batch: Mapping, step: int) -> str:
        """``rgb_gt_pred_ae_<step>.jpg``: the first image, its ground truth
        and the reconstruction's argmax (trainers_ae.py:884)."""
        logits = self.eval_logits({k: batch[k][:1] for k in
                                   ("image", "image_semseg")})
        pred = resize_logits(logits, batch["semseg"].shape[1:3]).argmax(-1)
        path = os.path.join(self._folder(), f"rgb_gt_pred_ae_{step}.jpg")
        save_train_panel(path, to_numpy(batch["image"][0]),
                         to_numpy(batch["semseg"][0]), to_numpy(pred[0]))
        self.metrics.log_image(step, "train_panel", path)
        return path

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_logits(self, batch: Mapping) -> torch.Tensor:
        """Full-resolution logits NHWC fp32 of the posterior mode, on the
        EMA with ``ema_on`` (trainers_ae.py:947-1010)."""
        self._require_params()
        dt = self.compute_dtype
        x = 2.0 * self._nchw(batch["image_semseg"], dt) - 1.0
        if self.fuse_rgb:
            x = torch.cat([x, 2.0 * self._nchw(batch["image"], dt) - 1.0],
                          dim=1)
        logits, _ = self._compute_vae(self._eval_vae)(
            x, sample_posterior=False)
        logits = self._eval_vae.upsample(logits)
        return logits.float().permute(0, 2, 3, 1).contiguous()

    def compute_metrics(self, metrics=("miou", "pq"), **kw) -> dict:
        """Eval dispatcher (trainers_ae.py:398): ``kw`` goes to
        :meth:`compute_miou`, its ``max_batches`` to :meth:`compute_pq`."""
        out = {}
        if "miou" in metrics:
            out["miou"] = self.compute_miou(**kw)
        if "pq" in metrics:
            out["pq"] = self.compute_pq(
                **{k: v for k, v in kw.items() if k == "max_batches"})
        return out

    def _val_batches(self, batch_size: Optional[int] = None):
        if self.ds_val is None:
            raise ValueError("TrainerAE: evaluation needs a val_dataset")
        # this data rank's share, each sample once
        return make_loader(self.ds_val, batch_size or self.batch_size,
                           shuffle=False, drop_last=False, pad=False,
                           mesh=self.mesh).epoch(0)

    def compute_miou(self, max_batches: Optional[int] = None,
                     batch_size: Optional[int] = None) -> dict:
        """mIoU of the reconstructions (trainers_ae.py:947): the logits
        resized to the labels' size (``jax.image.resize`` linear), argmax,
        ``SemsegMeter`` with the ignore label."""
        from ..evals import SemsegMeter
        meter = SemsegMeter(self.num_classes, ignore_index=self.ignore_label,
                            group=self.mesh.data_group)
        batches = self._val_batches(batch_size)
        try:
            for i, batch in enumerate(batches):
                logits = self.eval_logits(batch)
                pred = resize_logits(logits,
                                     batch["semseg"].shape[1:3]).argmax(-1)
                meter.update(pred, torch.as_tensor(batch["semseg"]))
                if max_batches is not None and i + 1 >= max_batches:
                    break
        finally:
            batches.close()
        if self.mesh.data > 1:
            meter.synchronize()
        return meter.return_score()

    def compute_pq(self, mask_th: float = 0.5, count_th: int = 128,
                   overlap_th: float = 0.5,
                   max_batches: Optional[int] = None) -> dict:
        """Class-agnostic PQ of the reconstructions
        (trainers_ae.py:624-727): with ``gt_sem`` in every meta each image
        restored to its ground truth's size under ``gt_mask``
        (:meth:`restore_fullres` without a padding crop, as the JAX
        trainer), else resized to the labels' size; post-processed with
        the thresholds given."""
        from ..evals import PanopticEvaluator
        self.mask_th, self.count_th, self.overlap_th = (mask_th, count_th,
                                                        overlap_th)
        ev = PanopticEvaluator(thing_ids=set(), class_agnostic=True,
                               ignore_label=self.ignore_label,
                               group=self.mesh.data_group)
        batches = self._val_batches()
        try:
            for i, batch in enumerate(batches):
                logits = self.eval_logits(batch)
                metas = batch.get("meta")
                if metas and all("gt_sem" in m for m in metas):
                    metas = [{k: v for k, v in m.items() if k != "padding"}
                             for m in metas]
                    for m, cleaned in zip(metas, self.restore_fullres(
                            logits, metas)):
                        ev.add_image(cleaned, m["gt_sem"])
                else:
                    semseg = to_numpy(batch["semseg"])
                    cleaned = self.restore_resized(
                        logits, semseg.shape[1:3],
                        np.ones(semseg.shape, bool))
                    for bi in range(cleaned.shape[0]):
                        ev.add_image(cleaned[bi], semseg[bi])
                if max_batches is not None and i + 1 >= max_batches:
                    break
        finally:
            batches.close()
        return ev.evaluate(synchronize=self.mesh.data > 1)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _folder(self) -> str:
        if not self.results_folder:
            raise ValueError("TrainerAE: checkpoints and panels need a "
                             "results_folder (or the config's "
                             "checkpoint_dir)")
        return os.path.abspath(self.results_folder)

    def _step_checkpoints(self) -> List[str]:
        root = self._folder()
        steps = [d for d in os.listdir(root)
                 if d.startswith("step_") and d[5:].isdigit()]
        return [os.path.join(root, d)
                for d in sorted(steps, key=lambda d: int(d[5:]))]

    def save(self, step: Optional[int] = None,
             tag: Optional[str] = None) -> str:
        """``torch.save`` of ``{params, buffers, opt_state, step, best_pq,
        ema_params?}`` (by name, on the CPU) as ``tag`` or ``step_N`` under
        ``results_folder``; the newest 3 ``step_*`` are kept. Returns the
        path. Every data rank calls it (ZeRO-1 gathers the optimizer
        state onto the main process); the main process writes."""
        self._require_params()
        name = tag or f"step_{step or self.state.step}"
        path = os.path.join(self._folder(), name)
        opt = self.state.optimizer
        # collective under ZeRO-1; otherwise only the writer copies it
        opt_state = (opt.state_dict() if opt.owner is not None
                     or is_main_process() else None)
        if not is_main_process():
            return path
        named = list(self.vae.named_parameters())
        payload = {"params": {n: p.detach().cpu() for n, p in named},
                   "buffers": {n: b.detach().cpu()
                               for n, b in self.vae.named_buffers()},
                   "opt_state": opt_state,
                   "step": int(self.state.step),
                   "best_pq": float(self.best_pq)}
        if self.state.ema_params is not None:
            payload["ema_params"] = {
                n: e.detach().cpu()
                for (n, _), e in zip(named, self.state.ema_params)}
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self._step_checkpoints()[:-3]:
            os.remove(old)
        return path

    def resume(self, path: Optional[str] = None) -> Optional[str]:
        """Restore a checkpoint of :meth:`save` in place (default the
        newest ``step_*``; none: start fresh and return None)."""
        self._require_params()
        if path is None:
            found = self._step_checkpoints()
            if not found:
                if is_main_process():
                    print("No checkpoint found; starting fresh", flush=True)
                return None
            path = found[-1]
        data = torch.load(path, map_location="cpu", weights_only=True)
        named = dict(self.vae.named_parameters())
        if set(named) != set(data["params"]):
            raise ValueError(f"checkpoint {path} holds another seg VAE")
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(data["params"][n])
            for n, b in self.vae.named_buffers():
                b.copy_(data["buffers"][n])
            if self.state.ema_params is not None and "ema_params" in data:
                for n, e in zip(named, self.state.ema_params):
                    e.copy_(data["ema_params"][n])
        self.state.zero_grad()
        self.state.optimizer.load_state_dict_(data["opt_state"])
        self.state.step = int(data["step"])
        self.state.micro_step = self.state.step * self.state.accumulate
        self.best_pq = float(data.get("best_pq", self.best_pq))
        if is_main_process():
            print(f"Resumed from {path} at step {self.state.step}",
                  flush=True)
        return path

    def export_reference(self, path: str, use_ema: bool = False) -> str:
        """The reference's stage-1 save dict ``{'vae': <GeneralVAESeg state
        dict>, 'step'}`` (trainers_ae.py:534-548), the EMA with
        ``use_ema`` and ``ema_on``: what ``main_ldm`` reads through
        ``vae_model_kwargs.pretrained_path`` and JAX's
        ``load_reference_seg_vae`` reads."""
        from ..models.torch_export import export_reference_ae
        self._require_params()
        vae = self._eval_vae if use_ema and self.ema_on else self.vae
        export_reference_ae(path, vae.state_dict(), self.vae_kwargs,
                            step=int(self.state.step))
        return path
