"""Pose network trainer (counterpart of
``ldmseg_tpu/train/trainer_pose.py:TrainerPose``).

Trains :class:`~..models.posenet.PoseExpNet` on video clips with the
SfMLearner photometric objective (``losses/pose_consistency.py``), using
the DVPS datasets' GT depth and the focal length in each frame's meta
(KITTI's 707 where it gives none). In fp32 (its convolutions at the
process's TF32 setting on the card), AdamW on the config's warmup schedule
with global-norm clipping, as the JAX trainer's optax chain. The learned
poses feed :meth:`~.trainer_ldm.TrainerDiffusion.attach_pose`.
Checkpoints are ``torch.save`` files ``{params, nb_ref}`` (JAX writes
orbax trees; neither reads the other's).

Data parallelism (``mesh``, as ``TrainerDiffusion``'s): ``batch_size`` is
the global batch of clips, each data rank trains its rows, and the
gradients are averaged before the optimizer (the photometric and mask
terms are means over equal shards, so the ranks' mean is the global
batch's). Only the main process prints and writes checkpoints.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from ..data.loader import make_loader, prefetch_to_device
from ..data.video import clip_focal
from ..losses.pose_consistency import photometric_consistency_loss
from ..models.convert import pose_state_dict_from_jax
from ..models.layers import init_random_
from ..models.posenet import PoseExpNet, load_pose_state_dict
from ..parallel.mesh import (check_mesh_device, group_mean, make_mesh,
                             replicate)
from ..parallel.multihost import is_main_process
from ..utils.meters import AverageMeter
from ..utils.precision import strict_fp32
from .optim import Optimizer, make_lr_schedule
from .state import TrainState


class TrainerPose:
    """``dataset`` yields clips (:class:`~..data.video.ClipDataset`);
    ``device`` is ``"cuda"`` unless the caller asks for the CPU. Call
    :meth:`init_params`, :meth:`load_jax_params` or :meth:`resume` before
    :meth:`train_step`; :meth:`train_loop` starts from seeded random
    weights if none are set."""

    def __init__(self, p: dict, dataset=None,
                 results_folder: Optional[str] = None,
                 nb_ref_imgs: int = 2, output_exp: bool = True,
                 device="cuda", mesh=None):
        # fp32 as the reference computes it, in this process: no TF32
        strict_fp32()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TrainerPose: device 'cuda' asked for but "
                "torch.cuda.is_available() is False; pass "
                "device=torch.device('cpu') to run the plain PyTorch path")
        self.mesh = mesh if mesh is not None else make_mesh()
        check_mesh_device(self.mesh, device, "TrainerPose")
        self.p = p
        self.device = device
        tk = p["train_kwargs"]
        self.nb_ref = nb_ref_imgs
        self.output_exp = output_exp
        with torch.device("meta"):
            self.model = PoseExpNet(nb_ref_imgs=nb_ref_imgs,
                                    output_exp=output_exp)
        self.batch_size = tk["batch_size"]  # the global batch
        self.mesh.local_batch(self.batch_size)
        self.train_num_steps = tk["train_num_steps"]
        self.clip_grad = tk.get("clip_grad", 0.0)
        self.ds = dataset
        self.results_folder = results_folder or p.get("checkpoint_dir") \
            or "ldmseg_pose"
        os.makedirs(self.results_folder, exist_ok=True)
        self.state: Optional[TrainState] = None

    # ------------------------------------------------------------------
    def _ready(self) -> None:
        replicate(self.mesh, self.model)  # the first data rank's weights
        self.model.train().requires_grad_(True)
        ok = self.p["optimizer_kwargs"]
        schedule = make_lr_schedule(
            self.p.get("lr_scheduler_name", "warmup"), ok["lr"],
            self.train_num_steps,
            warmup_iters=self.p["lr_scheduler_kwargs"].get("warmup_iters",
                                                           200))
        self.state = TrainState(Optimizer(
            list(self.model.named_parameters()), "adamw",
            learning_rate=schedule,
            weight_decay=ok.get("weight_decay", 0.0),
            clip_grad=self.clip_grad), group=self.mesh.data_group)

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights (LeCun-normal, zero biases) and a fresh
        optimizer."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model.to_empty(device=self.device)
        init_random_(self.model, gen)
        self._ready()

    def load_state_dict(self, sd: Mapping) -> None:
        """Adopt the port's state dict (:func:`load_pose_state_dict`) and
        a fresh optimizer."""
        self.model.to_empty(device=self.device)
        load_pose_state_dict(self.model, sd)
        self._ready()

    def load_jax_params(self, params: Mapping) -> None:
        """Adopt the JAX package's ``PoseExpNet`` tree (numpy arrays)."""
        self.load_state_dict(pose_state_dict_from_jax(params,
                                                      self.output_exp))

    def _require_params(self) -> None:
        if self.state is None:
            raise RuntimeError("TrainerPose: call init_params, "
                               "load_jax_params or resume first")

    # ------------------------------------------------------------------
    def _split_clip(self, batch: Mapping):
        """Clip batch ``[B, T, ...]`` -> target = middle frame, refs = the
        others in order (the first ``nb_ref``), its depth; NHWC fp32 on
        the device."""
        imgs = torch.as_tensor(batch["image"], device=self.device).float()
        t = imgs.shape[1]
        mid = t // 2
        target = imgs[:, mid]
        ref_idx = [i for i in range(t) if i != mid][: self.nb_ref]
        refs = torch.stack([imgs[:, i] for i in ref_idx], dim=1)
        depth = None
        if "depth" in batch:
            depth = torch.as_tensor(batch["depth"],
                                    device=self.device).float()[:, mid]
        return target, refs, depth

    def forward_loss(self, batch: Mapping):
        """``(total, {'loss', 'photo', 'mask_reg'})`` of one clip batch
        (``image``, ``depth``, and ``focal`` ``[B]`` or ``meta``), the
        gradient not taken; the explainability mask is the full-resolution
        one with ``output_exp``."""
        self._require_params()
        target, refs, depth = self._split_clip(batch)
        focal = batch.get("focal")
        if focal is None:
            focal = clip_focal(batch["meta"])
        focal = torch.as_tensor(focal, device=self.device).float()
        nchw = target.permute(0, 3, 1, 2)
        ref_list = [refs[:, i].permute(0, 3, 1, 2)
                    for i in range(self.nb_ref)]
        masks, pose = self.model(nchw, ref_list, train=True)
        exp = None
        if self.output_exp and masks[0] is not None:
            exp = masks[0].permute(0, 2, 3, 1)  # [B, H, W, R]
        losses = photometric_consistency_loss(target, refs, depth, pose,
                                              focal, exp_masks=exp)
        total = losses["photo"] + losses["mask_reg"]
        return total, {"loss": total, "photo": losses["photo"],
                       "mask_reg": losses["mask_reg"]}

    def train_step(self, batch: Mapping) -> dict:
        """One AdamW step; returns the step's metrics (device tensors)."""
        total, metrics = self.forward_loss(batch)
        total.backward()
        self.state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    def train_loop(self, seed: int = 0, max_steps: Optional[int] = None,
                   log_every: int = 20) -> list:
        """Train on ``dataset`` for ``max_steps`` steps (default
        ``train_num_steps``), batches from the threaded loader seeded by
        ``seed`` through the H2D prefetch; seeded random weights from
        ``seed`` if none are set. Returns every step's loss."""
        if self.ds is None:
            raise ValueError("TrainerPose.train_loop needs a dataset")
        if self.state is None:
            self.init_params(seed)
        loader = make_loader(self.ds, self.batch_size, seed=seed,
                             mesh=self.mesh)
        if len(loader) == 0:
            raise ValueError(f"dataset of {len(self.ds)} clips gives no "
                             f"batch of {self.batch_size}")
        max_steps = max_steps or self.train_num_steps
        meter = AverageMeter("loss", ":.4f")
        losses, pending = [], []
        step, epoch = 0, 0
        while step < max_steps:
            host = ({"image": b["image"], "depth": b["depth"],
                     "focal": clip_focal(b["meta"])}
                    for b in loader.epoch(epoch))
            batches = prefetch_to_device(host, self.device)
            try:
                for batch in batches:
                    pending.append(self.train_step(batch)["loss"])
                    step += 1
                    if step % log_every == 0 or step == max_steps:
                        values = group_mean(torch.stack(pending),
                                            self.mesh).tolist()
                        pending.clear()
                        losses += values
                        for v in values:
                            meter.update(v)
                        if is_main_process():
                            print(f"pose step {step}: {meter}", flush=True)
                    if step >= max_steps:
                        break
            finally:
                batches.close()
            epoch += 1
        return losses

    # ------------------------------------------------------------------
    def save(self, step: Optional[int] = None,
             tag: Optional[str] = None) -> str:
        """``torch.save`` of ``{params, nb_ref}`` (the state dict on the
        CPU) under ``results_folder`` as ``tag`` or ``step_N``: the file
        ``main_ldm``'s ``pose_model_kwargs.pretrained_path`` reads (by the
        main process; every rank holds the same weights)."""
        self._require_params()
        name = tag or f"step_{step if step is not None else 0}"
        path = os.path.join(os.path.abspath(self.results_folder), name)
        if not is_main_process():
            return path
        payload = {"params": {k: v.detach().cpu()
                              for k, v in self.model.state_dict().items()},
                   "nb_ref": int(self.nb_ref)}
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        return path

    def resume(self, path: str) -> str:
        """Restore the weights of a :meth:`save` file (the optimizer starts
        afresh, as JAX's ``resume`` replaces only the params)."""
        data = torch.load(path, map_location="cpu", weights_only=True)
        if int(data["nb_ref"]) != self.nb_ref:
            raise ValueError(f"{path} holds a pose net of {data['nb_ref']} "
                             f"reference frames, not {self.nb_ref}")
        if self.state is None:
            self.load_state_dict(data["params"])
        else:
            load_pose_state_dict(self.model, data["params"])
        return path

    @torch.no_grad()
    def predict_poses(self, batch: Mapping) -> torch.Tensor:
        """``[B, T, H, W, 3]`` clip -> ``[B, R, 6]`` poses."""
        self._require_params()
        target, refs, _ = self._split_clip({"image": batch["image"]})
        _, pose = self.model(target.permute(0, 3, 1, 2),
                             [refs[:, i].permute(0, 3, 1, 2)
                              for i in range(self.nb_ref)], train=False)
        return pose


def load_pose_checkpoint(path: str, nb_ref_imgs: Optional[int] = None):
    """A :meth:`TrainerPose.save` file -> ``(PoseExpNet, state dict)`` for
    :meth:`~.trainer_ldm.TrainerDiffusion.attach_pose`: ``nb_ref_imgs``
    from the file unless given, without the explainability decoder as JAX's
    ``main_ldm`` and ``predict`` attach it (the decoder's keys dropped)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    nb_ref = int(nb_ref_imgs or int(data.get("nb_ref", 2)))
    return PoseExpNet(nb_ref_imgs=nb_ref), data["params"]
