"""Stage-2 latent-diffusion trainer (counterpart of
``ldmseg_tpu/train/trainer_ldm.py:TrainerDiffusion``): its training step and
loop, and its sampling path.

``train_step`` runs one step of training: frozen seg-VAE encoder on the
analog bits and frozen SD image-VAE encoder on the RGB frame -> noise at a
random timestep -> optional self-conditioning pass without gradient -> UNet
on a compute-dtype cast of the fp32 masters -> masked, SNR-weighted loss ->
backward (K2 on the card) -> the optimizer. ``train_loop`` feeds it from the
port's loader. A ``unet_config`` with ``use_packed_attention`` runs the
self-attention of both paths on K14 (its backward on K2), as JAX's
``fused_self_attention_packed``. ``sample_panoptic`` runs the serving path:
RGB frames -> image-VAE encoder (posterior mode x 0.18215) -> DDIM with
self-conditioning (or with ``sampling_kwargs.sampler: dpmpp_2m``
DPM-Solver++(2M), ``diffusion/dpm.py``) -> seg-VAE decode to per-instance
logits. ``image_vae_kwargs`` (``use_int8``, ``int8_act_scale``,
``use_fused_attention``, ``decoder_enabled``) and ``vae_model_kwargs.
use_int8`` build the two VAEs as the JAX trainer does; an int8 VAE's codes
are filled from its compute-dtype weights once, whenever the weights are
set (:func:`~..ops.quant.prepare_int8_vae`).
``compute_pq`` scores it on ``val_dataset``: each prediction restored to its
ground truth's resolution by host-built bilinear weight matrices contracted
on the device, panoptic post-processing, then ``PanopticEvaluator``.
Batches and results are NHWC at this boundary, as in the JAX package; the
models run NCHW.

With ``sampling_kwargs.int8_inference`` the 50 steps run on the int8 UNet
(s8 convs; K3 and K4 with ``fused_norms``, the default; K13 and K12, or K13
and the s8 linears with ``fused_ff`` False, without it; K3 and the s8
linears with ``fused_norms`` and not ``fused_ff``; K8 and K9 in place of K3
and K4 when ``unet_config`` sets ``use_fused_projs``; K15 in place of K13
when it sets ``use_packed_attention``), quantized from the fp32 masters once
per call, with
per-site activation scales from :meth:`calibrate_int8` (automatic on
adopted weights). Its other layers run in the compute dtype, as the bf16
path does; the JAX trainer hands that UNet its fp32 masters, so there they
promote the activations to fp32.

With ``ema_on`` the trainer keeps an fp32 EMA of the masters on the device
(decay ``ema_kwargs.decay``, JAX's 0.9999 by default; updated after each
optimizer step) and samples and calibrates with it, as JAX's
``eval_params``. :meth:`save` writes ``torch.save`` checkpoints
``{params, opt_state, step, best_pq, ema_params?}`` under
``results_folder`` (``step_N``, the newest 3 kept, or a tag such as
``best_model``; JAX writes orbax trees), :meth:`resume` restores one in
place, ``compute_pq(save_model=True)`` keeps the best-PQ snapshot, and
:meth:`train_loop` saves and evaluates on a cadence, logging to
``metrics.jsonl``. :meth:`export_reference` writes the reference's torch
save dict.

Training also takes the UNet's input dropout, gradient checkpointing
(``remat_policy``), Adafactor, sampling the RGB posterior
(``sample_posterior_rgb``, in training and sampling as in JAX) and image
logging (:meth:`log_images_train`, :meth:`log_images_val`,
:meth:`visualize_noise_schedule`).

Video clips (JAX :335-369, :569-690, :935-1088): a batch ``[B, T, ...]`` of
:class:`~..data.video.ClipDataset` clips trains with its frames flattened
clip-major onto the batch axis and one timestep per clip; with a pose net
adopted by :meth:`attach_pose` and ``temporal_consistency_weight`` > 0 the
loss gains the pose-warped temporal-consistency term on the frames' x0
estimates. :meth:`sample_panoptic_clip` samples a clip batch with
clip-shared noise, warps the middle frame's x0 into the others by the
inverted predicted poses and refines the blend with a DDIM tail
(:func:`~..diffusion.sampler.ddim_refine`), bf16 or int8, after a DDIM or
DPM first pass.

Conditioning (JAX :78-105, :455-545): ``train_kwargs.image_descriptors``
(with ``descriptor_pretrained_path`` for the CLIP towers) resolves to a
:class:`~..models.descriptors.DescriptorSpec`, from which the UNet is built
(``use_cross_attention``, object queries, ``encoder_hid_proj``); the
surgery's ``model_kwargs.separate_conv``, ``separate_encoder`` and
``add_adaptor`` are read as in JAX. The context of a batch
(:meth:`context`) is ``batch["context"]`` (``none``), the frozen CLIP text
tower on ``text_tokens`` (or on the tokenized ``text``; ``clip_text``) or
the frozen CLIP vision tower on the frame (``clip_vision``); ``learnable``
and ``remove`` give none. The tower's weights are rounded to the compute
dtype and kept in fp32, as the JAX trainer's cast towers compute (Flax
promotes them by their fp32 inputs). The context reaches the UNet in the
compute dtype (JAX hands it over in fp32, so Flax promotes the
cross-attention and what follows it to fp32). With a context and
``guidance_scale`` != 1, sampling runs classifier-free guidance
(:func:`~..diffusion.sampler.cfg_model_fn`: two UNet calls a step, the
unconditional one on zeros, or on the empty caption's embedding, computed
once, for the text tower) in DDIM, DPM-Solver++(2M) and the clip tail, all
on the CUDA-graph loop. A trait copied from JAX: int8 calibration runs the
UNet without a context (JAX :1139-1141), where JAX's ``attn2`` falls back to
self-attention and fails, so :meth:`calibrate_int8` refuses a descriptor
that yields one. Wandb is not ported: a config that asks for it raises
``NotImplementedError`` naming it.

Data parallelism (``mesh``, ``parallel/mesh.py``; by default the
initialised process group's, or one process): ``train_kwargs.batch_size``
stays the global batch, of which each data rank loads and trains
``batch_size / data`` rows (refused unless it divides); the losses are the
global batch's (``diffusion_loss(group=)``, the consistency term's valid
count), the gradients are averaged over the data group before the
optimizer, and ``optimizer_zero_redundancy`` partitions the optimizer
state (ZeRO-1, ``train/optim.py``). The masters are broadcast from the
first data rank when the state is made. ``train_loop`` draws each rank's
noise from a generator seeded with ``(seed, data rank)`` and logs the data
group's mean loss; ``compute_pq`` samples each rank's share of the val set
and sums the evaluator. Only the main process writes checkpoints (their
optimizer state gathered from every rank first), ``metrics.jsonl`` and
images; every rank resumes.

A ``model`` axis (``make_mesh(num_data, num_model)``; rank = data index x
model size + model index): the model ranks of one data index train the same
rows with the same draws (:func:`rank_seed` keys on the data rank). With
``tensor_parallel`` each holds its shards of the UNet
(``parallel/tp.py:apply_tp``: column- and row-parallel layers, K1 and K2
on its local heads, or with ``use_packed_attention`` K14 and K2, with
``use_absorbed_attention`` K16's partial mode and K2), the optimizer (and
ZeRO-1's partition over the data group) runs on the shards, the clip's
global norm sums the shards over the model group, and a checkpoint is
gathered to the one-rank layout (and a one-rank checkpoint resumes onto
the shards). With ``spatial_parallel``
each runs the frozen VAEs on its rows of H (``parallel/sp.py:run_stage``:
the encoders' moments gathered before the posterior's draws, the decode's
logits gathered before post-processing). Serving takes the model axis
whole: the int8 UNet (fused norms or not) is cut as the float one (K3 and
K4, or K13 and K12, on a rank's heads and GEGLU columns, their partials
summed over the model group; with the packed or absorbed flag K15 on a
rank's heads with the group's amaxes, or K17's partial mode; with
``use_fused_projs`` K8 and K9 in their partial modes, Transformer2D's 1x1
convs whole; with ``int8_fuse_gn`` K6 whole into the cut s8 convs; on
heads the axis does not divide, K3 and K8 whole on every rank), its codes
quantized from the cut masters and its calibration taken on them, the
same scales on every rank; the
int8 image VAE and seg decoder run under ``spatial_parallel`` on a rank's
rows; the ``none``, ``learnable`` and CLIP descriptors' context and
classifier-free guidance run on the cut UNet. Sampling then runs the eager
loop: a CUDA graph cannot capture gloo's host-staged collectives. Without
a model axis the two flags do nothing (JAX's ``has_spatial_axis`` rule).
The other options that a model axis does not take yet raise
``NotImplementedError`` naming themselves (:func:`refuse_model_axis`).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.loader import make_loader, prefetch_to_device
from ..data.video import clip_focal
from ..diffusion.ddim import add_noise, make_ddim_schedule, remove_noise
from ..diffusion.dpm import dpmpp_2m_sample
from ..diffusion.sampler import cfg_model_fn, ddim_refine, ddim_sample
from ..losses.pose_consistency import (inverse_warp, invert_pose_mat,
                                       pose_vec_to_mat)
from ..losses.diffusion_losses import diffusion_loss
from ..models.descriptors import DescriptorSpec, get_image_descriptors
from ..models.convert import (image_vae_state_dict_from_jax,
                              seg_vae_state_dict_from_jax,
                              unet_state_dict_from_jax)
from ..models.image_vae import ImageVAE
from ..models.layers import init_random_
from ..models.posenet import PoseExpNet, load_pose_state_dict
from ..ops.resize import resize_weight_matrix
from ..models.seg_vae import DiagonalGaussian, SegVAE
from ..models.unet import UNet2DCondition, UNetConfig, draw_input_dropout
from ..ops.quant import (apply_act_scales, calibrate_act_scale_tree,
                         prepare_int8_unet, prepare_int8_vae)
from ..parallel import sp, tp
from ..parallel.mesh import (check_mesh_device, global_mean, group_mean,
                             make_mesh, rank_seed, replicate)
from ..parallel.multihost import is_main_process
from ..utils.meters import AverageMeter
from ..utils.metrics_sink import MetricsSink
from ..utils.precision import strict_fp32
from .optim import Optimizer, freeze_filter, make_lr_schedule
from .restore import PanopticRestore
from .state import TrainState

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# descriptors whose context comes from outside the UNet
_EXTERNAL_CONTEXT = ("none", "clip_text", "clip_vision")
# the per-frame keys of a clip batch, flattened to [B*T, ...] for a step
_FRAME_KEYS = ("image", "image_semseg", "semseg", "mask", "inpainting_mask")


def refuse_model_axis(p: Mapping, mesh) -> None:
    """The options that a model axis of more than one rank does not take in
    the port yet raise ``NotImplementedError`` naming each of them (JAX
    computes every one of them on a model axis). Without a model axis
    nothing is refused. Every UNet option of the float and the int8 UNet
    is taken but the surgery flags, which ``parallel/tp.py:apply_tp``
    refuses (``add_adaptor``, ``upscaler_classes``) or this names."""
    if mesh.model <= 1:
        return
    tk, mk = p["train_kwargs"], p["model_kwargs"]
    refused = []
    for key in ("separate_conv", "separate_encoder"):
        if mk.get(key, False):
            refused.append(f"model_kwargs.{key}")
    if tk.get("temporal_consistency_weight", 0.0) > 0:
        refused.append("train_kwargs.temporal_consistency_weight (video "
                       "clips and pose)")
    if p.get("optimizer_name", "adamw") == "adafactor":
        refused.append("optimizer_name adafactor")
    if refused:
        raise NotImplementedError(
            f"{', '.join(refused)}: not ported over a model axis of "
            f"{mesh.model} ranks")


def _refuse_video(mesh, what: str) -> None:
    if mesh.model > 1:
        raise NotImplementedError(f"{what} (video clips and pose): not "
                                  f"ported over a model axis of "
                                  f"{mesh.model} ranks")


class TrainerDiffusion(PanopticRestore):
    """Builds the UNet, the image VAE and the seg VAE from the config as the
    JAX trainer does, on ``device`` (``"cuda"`` unless the caller asks for
    the CPU). Call :meth:`init_params`, :meth:`load_jax_params` or
    :meth:`load_state_dicts` before :meth:`train_step`, :meth:`train_loop`
    or :meth:`sample_panoptic`; ``dataset`` feeds :meth:`train_loop`,
    ``val_dataset`` :meth:`compute_pq`. ``results_folder`` (default the
    config's ``checkpoint_dir``) takes the checkpoints and
    ``metrics.jsonl``."""

    def __init__(self, p: dict, unet_config: Optional[UNetConfig] = None,
                 device="cuda", dataset=None, val_dataset=None,
                 results_folder: Optional[str] = None,
                 descriptor: Optional[DescriptorSpec] = None, mesh=None):
        # fp32 as the reference computes it, in this process: no TF32
        strict_fp32()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TrainerDiffusion: device 'cuda' asked for but "
                "torch.cuda.is_available() is False; pass "
                "device=torch.device('cpu') to run the plain PyTorch path")
        self.mesh = mesh if mesh is not None else make_mesh()
        check_mesh_device(self.mesh, device, "TrainerDiffusion")
        # the model axis (JAX :202-208, :311-312): nothing without one
        self.tensor_parallel = (bool(p.get("tensor_parallel", False))
                                and self.mesh.model > 1)
        self.spatial_parallel = (bool(p.get("spatial_parallel", False))
                                 and sp.has_spatial_axis(self.mesh))
        self.zero1 = bool(p.get("optimizer_zero_redundancy", False))
        self.device = device
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
        self.best_pq = -1.0
        tk, mk, sk, ek = (p["train_kwargs"], p["model_kwargs"],
                          p["sampling_kwargs"], p["eval_kwargs"])

        vk = dict(p["vae_model_kwargs"])
        vk.pop("pretrained_path", None)
        vk["block_out_channels"] = tuple(vk["block_out_channels"])
        self.vae_seg_kwargs = vk
        ivk = dict(p.get("image_vae_kwargs") or {})
        ivk.setdefault("decoder_enabled", False)
        if "block_out_channels" in ivk:
            ivk["block_out_channels"] = tuple(ivk["block_out_channels"])
        self.seg_scale = vk.get("scaling_factor", 0.2)
        self.img_scale = p.get("image_scaling_factor", 0.18215)
        self.num_classes = vk["out_channels"]
        self.ignore_label = p["ignore_label"]

        self.self_condition = tk.get("self_condition", False)
        cond_channels = mk.get("cond_channels", 0)
        if self.self_condition and cond_channels == 0:
            # the reference trains self_condition with cond_channels=4
            cond_channels = 4
        # bf16 covers the reference's float16 AMP dtype, as in JAX
        self.compute_dtype = (torch.bfloat16 if tk.get("weight_dtype") in
                              ("bfloat16", "float16") else torch.float32)
        if descriptor is None:
            descriptor = get_image_descriptors(
                tk.get("image_descriptors", "remove"),
                pretrained_path=p.get("descriptor_pretrained_path"))
        self.descriptor = descriptor
        self.descriptor_model = None
        if descriptor.model is not None:
            # frozen; fp32 on weights rounded to the compute dtype
            model = descriptor.model.to(device).eval().requires_grad_(False)
            with torch.no_grad():
                for q in model.parameters():
                    q.copy_(q.to(self.compute_dtype).float())
            self.descriptor_model = model
        self._uncond_embed: Optional[torch.Tensor] = None
        if unet_config is None:
            unet_config = UNetConfig(
                in_channels=mk.get("in_channels", 8) + cond_channels,
                use_cross_attention=descriptor.use_cross_attention,
                num_object_queries=descriptor.num_object_queries,
                encoder_hid_dim=descriptor.encoder_hid_dim,
                separate_conv=mk.get("separate_conv", False),
                separate_encoder=mk.get("separate_encoder", False),
                add_adaptor=mk.get("add_adaptor", False),
                use_fused_attention=tk.get("fused_attention", True),
                dropout=tk.get("dropout", 0.0),
                gradient_checkpointing=tk.get("gradient_checkpointing",
                                              False),
                remat_policy=tk.get("remat_policy"))
        self.unet_config = unet_config
        refuse_model_axis(p, self.mesh)
        # built without storage; init_params / load_jax_params fill them
        # int8 sampling (trainer_ldm.py:157-193): the UNet the JAX trainer
        # builds with the int8 flags (:163-176), beside the float one
        self.int8_inference = bool(sk.get("int8_inference", False))
        self.int8_auto_calibrate = sk.get("int8_auto_calibrate", True)
        with torch.device("meta"):
            self.unet = UNet2DCondition(unet_config)
            self.vae_img = ImageVAE(**ivk)
            self.vae_seg = SegVAE(**vk)
            self._unet_int8 = None
            if self.int8_inference:
                fused_norms = bool(sk.get("fused_norms", True))
                self._unet_int8 = UNet2DCondition(dataclasses.replace(
                    unet_config, use_int8_conv=True,
                    int8_act_scale=sk.get("int8_act_scale", 0.05),
                    use_int8_attention=not fused_norms, use_int8_ff=True,
                    use_fused_ff=bool(sk.get("fused_ff", True)),
                    use_fused_attention=not fused_norms,
                    use_padded_attention=fused_norms,
                    use_fused_norms=fused_norms,
                    int8_attn_act_scale=sk.get("int8_attn_act_scale", 0.1)))
        self._unet_infer: Optional[nn.Module] = None
        # the fp32 module sampling and calibration read: the masters, or
        # with ema_on a copy whose parameters are the EMA
        self._eval_unet: Optional[nn.Module] = None
        # calibrate_int8 fills the scales; adopted weights must not sample
        # with the global defaults unnoticed (:meth:`_ensure_int8_ready`)
        self._int8_act_scales: Optional[dict] = None
        self._params_pretrained = False
        self._said_eager = False

        self.sched = make_ddim_schedule(**p["noise_scheduler_kwargs"],
                                        device=device)
        self.p = p
        self.ds = dataset
        self.ds_val = val_dataset
        self.min_noise_level = tk.get("min_noise_level", 0)
        self.rgb_noise_level = tk.get("rgb_noise_level", 0)
        self.cond_noise_level = tk.get("cond_noise_level", 0)
        self.prob_train_on_pred = tk.get("prob_train_on_pred", 0.0)
        self.prob_inpainting = tk.get("prob_inpainting", 0.0)
        # pose-consistent video training and sampling (attach_pose)
        self.temporal_consistency_weight = tk.get(
            "temporal_consistency_weight", 0.0)
        self.pose_model: Optional[PoseExpNet] = None
        self.type_mask = tk.get("type_mask", "ignore")
        self.loss_type = tk.get("loss", "l2")
        self.ohem_ratio = tk.get("ohem_ratio", 1.0)
        self.sample_posterior = tk.get("sample_posterior", False)
        self.sample_posterior_rgb = tk.get("sample_posterior_rgb", False)
        self.batch_size = tk["batch_size"]  # the global batch
        self.mesh.local_batch(self.batch_size)
        self.train_num_steps = tk["train_num_steps"]
        self.state: Optional[TrainState] = None
        self.num_inference_steps = sk.get("num_inference_steps", 50)
        # "ddim" (the reference's) or "dpmpp_2m" (trainer_ldm.py:145-148)
        self.sampler = sk.get("sampler", "ddim")
        if self.sampler not in ("ddim", "dpmpp_2m"):
            raise ValueError(f"sampling_kwargs.sampler {self.sampler!r}: "
                             "expected 'ddim' or 'dpmpp_2m'")
        self.seed = sk.get("seed", 0)
        # classifier-free guidance (reference base.yaml:118); acts only
        # with a context
        self.guidance_scale = float(sk.get("guidance_scale", 1.0))
        self.mask_th = ek.get("mask_th", 0.5)
        self.count_th = ek.get("count_th", 512)
        self.overlap_th = ek.get("overlap_th", 0.5)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights for the three models."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._whole_unet()
        for model in (self.vae_img, self.vae_seg, self.unet):
            model.to_empty(device=self.device)
            init_random_(model, gen)
        self._params_pretrained = False
        self._frozen_ready()

    def load_jax_params(self, unet: Mapping, vae_img: Mapping,
                        vae_seg: Mapping) -> None:
        """Adopt the JAX package's parameter trees (nested dicts of numpy
        arrays): the UNet's, the image VAE's encoder tree and the seg VAE's."""
        self.load_state_dicts(
            unet_state_dict_from_jax(unet, self.unet_config),
            image_vae_state_dict_from_jax(vae_img),
            seg_vae_state_dict_from_jax(vae_seg, self.vae_seg_kwargs))

    def load_state_dicts(self, unet: Optional[Mapping] = None,
                         vae_img: Optional[Mapping] = None,
                         vae_seg: Optional[Mapping] = None,
                         seed: int = 0) -> None:
        """Adopt the port's state dicts (those of
        :mod:`~..models.torch_import`); a model given none gets the seeded
        random weights of :meth:`init_params`. Adopted UNet weights count as
        pretrained for the int8 scale guard."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._whole_unet()
        for model, sd in ((self.vae_img, vae_img), (self.vae_seg, vae_seg),
                          (self.unet, unet)):
            model.to_empty(device=self.device)
            if sd is None:
                init_random_(model, gen)
            else:
                model.load_state_dict(sd, strict=True)
        self._params_pretrained = unet is not None
        self._frozen_ready()

    def _whole_unet(self) -> None:
        """A UNet cut into shards by an earlier call is built whole again
        (without storage) before new weights fill it."""
        if tp.layout(self.unet):
            with torch.device("meta"):
                self.unet = UNet2DCondition(self.unet_config)

    def _frozen_ready(self) -> None:
        # the two VAEs are frozen and run entirely in the compute dtype (cast
        # once); the UNet keeps trainable fp32 masters, each training forward
        # runs on a differentiable cast (:meth:`_compute_unet`) and
        # sampling on a working copy refreshed once per call; every data
        # rank starts from the first one's weights (DDP's broadcast)
        replicate(self.mesh, [self.vae_img, self.vae_seg, self.unet])
        for model in (self.vae_img, self.vae_seg):
            model.eval().requires_grad_(False)
            model.to(self.compute_dtype)
            prepare_int8_vae(model)  # no-op for a float VAE
            if self.spatial_parallel:
                sp.apply_sp(model)
        if self.tensor_parallel:
            tp.apply_tp(self.mesh, self.unet)
            # the int8 UNet takes the same cut (its codes come from the
            # cut masters by name), once
            if self._unet_int8 is not None and not tp.layout(
                    self._unet_int8):
                tp.apply_tp(self.mesh, self._unet_int8)
        self.unet.eval().requires_grad_(True)
        self._eval_unet = self.unet
        if self.ema_on:  # real copies (TrainState.create's jnp.copy)
            self._eval_unet = copy.deepcopy(self.unet).requires_grad_(False)
        if self.compute_dtype == torch.float32:
            self._unet_infer = self._eval_unet
        else:
            self._unet_infer = copy.deepcopy(self.unet).to(
                self.compute_dtype).requires_grad_(False)
        if self._unet_int8 is not None:
            self._unet_int8.to_empty(device=self.device)
            self._unet_int8.to(self.compute_dtype).eval().requires_grad_(
                False)
        self.state = self._make_state()

    def make_optimizer(self, named, mesh=None, zero1: bool = False,
                       sharded: frozenset = frozenset()) -> Optimizer:
        """The JAX trainer's optimizer (trainer_ldm.py:219-240) over the
        named parameters ``named``: the lr schedule, AdamW with the
        config's decay values, clipping, and lr factor 0 on
        ``freeze_layers``; ``mesh``, ``zero1`` and ``sharded`` as
        :class:`~.optim.Optimizer` takes them."""
        p, tk = self.p, self.p["train_kwargs"]
        ok, sk = p["optimizer_kwargs"], p["lr_scheduler_kwargs"]
        schedule = make_lr_schedule(
            p.get("lr_scheduler_name", "warmup"), ok["lr"],
            self.train_num_steps,
            warmup_iters=sk.get("warmup_iters", 200),
            final_lr=sk.get("final_lr", 1e-6))
        frozen = tuple(tk.get("freeze_layers", ()))
        lr_factor = None
        if frozen:
            flt = freeze_filter(frozen)
            lr_factor = lambda name: 0.0 if flt(name) else 1.0  # noqa: E731
        return Optimizer(
            named, p.get("optimizer_name", "adamw"), learning_rate=schedule,
            betas=tuple(ok.get("betas", (0.9, 0.999))),
            weight_decay=ok.get("weight_decay", 0.0),
            weight_decay_norm=ok.get("weight_decay_norm"),
            clip_grad=tk.get("clip_grad", 0.0), lr_factor_fn=lr_factor,
            mesh=mesh, zero1=zero1, sharded=sharded)

    def _make_state(self) -> TrainState:
        """The training state over the UNet's masters: the optimizer of
        :meth:`make_optimizer` (ZeRO-1 and the model axis's shards on the
        mesh), accumulation, the EMA."""
        tk = self.p["train_kwargs"]
        lay = tp.layout(self.unet)
        optimizer = self.make_optimizer(
            list(self.unet.named_parameters()), mesh=self.mesh,
            zero1=self.zero1, sharded=frozenset(lay))
        return TrainState(
            optimizer, accumulate=tk.get("accumulate", 1),
            ema_params=(list(self._eval_unet.parameters()) if self.ema_on
                        else None), ema_decay=self.ema_decay,
            group=self.mesh.data_group,
            model_group=self.mesh.model_group if lay else None,
            replicated=[q for n, q in self.unet.named_parameters()
                        if lay and n not in lay])

    def _require_params(self) -> None:
        if self._unet_infer is None:
            raise RuntimeError("TrainerDiffusion: call init_params or "
                               "load_jax_params first")

    def inference_unet(self) -> nn.Module:
        """Refresh the compute-dtype working copy from the fp32 masters, or
        their EMA with ``ema_on``: once per call, outside the step loop, in
        place (a graph captured on it reads the same addresses)."""
        self._require_params()
        if self._unet_infer is not self._eval_unet:
            with torch.no_grad():
                for dst, src in zip(self._unet_infer.parameters(),
                                    self._eval_unet.parameters()):
                    dst.copy_(src)
        return self._unet_infer

    def int8_unet(self) -> nn.Module:
        """Quantize the fp32 masters (their EMA with ``ema_on``) into the
        int8 UNet with the current activation scales
        (``prequantize_conv_tree``, ``apply_act_scales`` and
        ``pack_inference_tiles`` of the JAX trainer's ``_prequant``): once
        per call, outside the step loop. With ``tensor_parallel`` each rank
        quantizes its cut masters into its cut int8 UNet (row-parallel
        layers over their whole rows): the slice of the one-rank codes."""
        self._require_params()
        if self._unet_int8 is None:
            raise RuntimeError("int8 inference not enabled "
                               "(sampling_kwargs.int8_inference)")
        apply_act_scales(self._unet_int8, self._int8_act_scales)
        prepare_int8_unet(self._unet_int8, self._eval_unet)
        return self._unet_int8

    def _ensure_int8_ready(self, batch: Mapping,
                           generator: Optional[torch.Generator]) -> None:
        """Adopted weights sample int8 only with calibrated scales
        (trainer_ldm.py:1090-1114): calibrate once on the first batch
        unless ``sampling_kwargs.int8_auto_calibrate`` is False, which
        raises instead. Seeded random weights keep the global defaults."""
        if self._int8_act_scales is not None or not self._params_pretrained:
            return
        if not self.int8_auto_calibrate:
            raise RuntimeError(
                "int8_inference=True on pretrained weights without "
                "calibrated activation scales: call calibrate_int8() or "
                "leave sampling_kwargs.int8_auto_calibrate enabled")
        print("int8 inference on pretrained weights: calibrating per-site "
              "activation scales on this batch", flush=True)
        image = batch["image"]
        if image.ndim == 5:  # a clip batch: calibrate on its frames
            batch = {"image": image.reshape((-1,) + tuple(image.shape[2:]))}
        self.calibrate_int8(batch, generator=generator)

    @torch.no_grad()
    def calibrate_int8(self, batch: Mapping, noise=None,
                       percentile: Optional[float] = None,
                       generator: Optional[torch.Generator] = None) -> dict:
        """Per-site static int8 activation scales from one forward of the
        float UNet on ``batch["image"]`` (trainer_ldm.py:1116-1150): the
        noisy half of its input is ``noise`` (NHWC ``[B, h, w, 4]``) or a
        draw from ``generator``, the timestep ``num_train_timesteps // 2``.
        The forward runs on the fp32 masters (their EMA with ``ema_on``), as
        JAX's on its fp32 ``eval_params``, with the input rounded to the
        compute dtype. Later int8 calls use the scales. Returns them, keyed
        by int8 site. On a model axis every rank runs it on the same batch
        and draws (the cut masters; the gated-interior sites' amax over the
        model group) and gets the one-rank scales."""
        if not self.int8_inference:
            raise RuntimeError("calibrate_int8: int8 inference not enabled")
        if self.descriptor.kind in _EXTERNAL_CONTEXT:
            raise RuntimeError(
                f"calibrate_int8 with the {self.descriptor.kind!r} "
                "descriptor: the calibration forward runs the UNet without "
                "a context (JAX trainer_ldm.py:1139-1141), where JAX's "
                "attn2 falls back to self-attention and fails on its "
                "context-sized to_k/to_v; int8 with a context samples only "
                "with the default scales, on weights not adopted as "
                "pretrained")
        self._require_params()
        rgb = self._encode_rgb(batch["image"], generator)
        b, _, lh, lw = rgb.shape
        if noise is None:
            noisy = torch.randn((b, 4, lh, lw), generator=generator,
                                device=self.device)
        else:
            noisy = self._nchw(noise)
        parts = [noisy, rgb]
        extra = self.unet_config.in_channels - 8
        if extra > 0:  # the self-condition channels, zero
            parts.append(torch.zeros((b, extra, lh, lw), device=self.device))
        inp = torch.cat(parts, dim=1).to(self.compute_dtype).float()
        t = torch.full((b,), self.sched.num_train_timesteps // 2,
                       device=self.device, dtype=torch.long)
        self._int8_act_scales = calibrate_act_scale_tree(
            self._eval_unet, inp, t, percentile=percentile)
        return self._int8_act_scales

    # ------------------------------------------------------------------
    # the pose net (JAX :331-372)
    # ------------------------------------------------------------------
    def attach_pose(self, pose_model: PoseExpNet,
                    state_dict: Optional[Mapping] = None) -> None:
        """Stage-3 handoff: adopt a trained :class:`PoseExpNet`, frozen,
        for the clip-training temporal-consistency term and pose-warped
        clip sampling. ``pose_model.nb_ref_imgs`` must be ``clip_len - 1``
        (target = middle frame, refs = the rest). ``state_dict`` (the
        port's keys; a JAX tree converts with
        :func:`~..models.convert.pose_state_dict_from_jax`) is loaded with
        :func:`~..models.posenet.load_pose_state_dict`; without it the
        model keeps its weights. The weights are rounded to the compute
        dtype and kept in fp32: the JAX trainer casts the frozen pose
        params to the compute dtype and Flax promotes them by the fp32
        frames, so its pose net computes in fp32 on bf16-rounded weights.
        Not over a model axis."""
        _refuse_video(self.mesh, "attach_pose")
        if any(p.is_meta for p in pose_model.parameters()):
            if state_dict is None:
                raise ValueError("attach_pose: the pose model's parameters "
                                 "are on the meta device; pass its "
                                 "state_dict")
            pose_model.to_empty(device=self.device)
        if state_dict is not None:
            load_pose_state_dict(pose_model, state_dict)
        pose_model = pose_model.to(self.device).eval().requires_grad_(False)
        with torch.no_grad():
            for p in pose_model.parameters():
                p.copy_(p.to(self.compute_dtype).float())
        self.pose_model = pose_model

    def _clip_poses(self, images_clip: torch.Tensor):
        """``[B, T, H, W, 3]`` clip -> (poses ``[B, R, 6]``, mid, ref frame
        indices): the middle frame is the target, the others in order (cut
        to ``nb_ref_imgs``) the refs. No gradient reaches the pose net."""
        t = images_clip.shape[1]
        mid = t // 2
        ref_idx = [i for i in range(t) if i != mid]
        ref_idx = ref_idx[: self.pose_model.nb_ref_imgs]
        frames = images_clip.float().permute(0, 1, 4, 2, 3)
        with torch.no_grad():
            _, pose = self.pose_model(frames[:, mid],
                                      [frames[:, i] for i in ref_idx],
                                      train=False)
        return pose, mid, ref_idx

    @staticmethod
    def _latent_depth_focal(depth: torch.Tensor, focal: torch.Tensor,
                            lh: int, lw: int):
        """GT depth ``[B(, T), H, W]`` + focal ``[B]`` -> latent-res depth
        (nearest with half-pixel centres, as ``jax.image.resize``) and the
        focal scaled by the same downsampling factor."""
        h, w = depth.shape[-2:]
        d = F.interpolate(depth.float().reshape(-1, 1, h, w), size=(lh, lw),
                          mode="nearest-exact")
        d = d.reshape(tuple(depth.shape[:-2]) + (lh, lw))
        return d, focal.float() * (lw / w)

    def _clip_depth_focal(self, batch: Mapping):
        """A clip batch's depth ``[B, T, H, W]`` (fp32, on the device) and
        focal ``[B]``: each clip's first frame's ``meta['focal']``, KITTI's
        707 where it gives none (or the batch has no meta)."""
        depth = torch.as_tensor(batch["depth"], device=self.device).float()
        focal = clip_focal(batch.get("meta"), depth.shape[0])
        return depth, torch.from_numpy(focal).to(self.device)

    def _consistency(self, x0p: torch.Tensor, clip_shape, pose_info
                     ) -> torch.Tensor:
        """The temporal-consistency term (JAX :665-690): each ref frame's
        x0 latent warped onto the middle frame by the predicted pose and
        the frame's depth, the L1 disagreement over the valid pixels and
        the channels, averaged over the refs."""
        bc, tt = clip_shape
        x0c = x0p.reshape((bc, tt) + tuple(x0p.shape[1:]))
        poses, mid, ref_idx, d_lat, f_lat = pose_info
        total = 0.0
        for i, r in enumerate(ref_idx):
            warped, valid = inverse_warp(x0c[:, r], d_lat[:, mid],
                                         poses[:, i], f_lat,
                                         channels_last=False)
            valid = valid.float()
            num = ((warped - x0c[:, mid]).abs() * valid[:, None]).sum()
            total = total + global_mean(num, valid.sum() * x0p.shape[1],
                                        self.mesh.loss_group)
        return total / len(ref_idx)

    # ------------------------------------------------------------------
    # shared by both paths
    # ------------------------------------------------------------------
    def _encode_rgb(self, image, generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None,
                    sample: Optional[bool] = None) -> torch.Tensor:
        """ImageNet-normalised NHWC frames -> scaled RGB latents, NCHW
        fp32: the posterior's mode, or under ``sample_posterior_rgb`` a
        sample (``noise``, NCHW, or a draw from ``generator``), in training
        and in sampling as in JAX (:409-423). ``sample`` overrides the
        config (clip sampling takes the mode, as JAX's)."""
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
        rgb = 2.0 * (x * std + mean).clamp(0.0, 1.0).to(
            self.compute_dtype) - 1.0
        rgb = rgb.permute(0, 3, 1, 2).contiguous()
        if self.spatial_parallel:
            # the moments gathered before the posterior's draw (JAX
            # :418-427)
            vae = self.vae_img
            post = DiagonalGaussian.from_moments(sp.run_stage(
                lambda x: vae.quant_conv(vae.encoder(x)), rgb, self.mesh,
                2 ** (len(vae.block_out_channels) - 1)))
        else:
            post = self.vae_img.encode(rgb)
        if sample is None:
            sample = self.sample_posterior_rgb
        lat = post.sample(generator, noise) if sample else post.mode()
        return lat.float() * self.img_scale

    def _seg_encode(self, bits: torch.Tensor):
        """The seg VAE's posterior on NCHW bits; under
        ``spatial_parallel`` each model rank encodes its rows and the
        moments are gathered before the posterior (JAX :380-406)."""
        vae = self.vae_seg
        if not self.spatial_parallel:
            return vae.encode(bits)
        return vae.make_posterior(sp.run_stage(
            vae.encoder, bits, self.mesh, vae.downsample_factor))

    def _seg_decode(self, z: torch.Tensor) -> torch.Tensor:
        """The seg VAE's decode to full-resolution logits; under
        ``spatial_parallel`` each model rank decodes its rows of the latent
        and the logits are gathered (JAX :888-892)."""
        if not self.spatial_parallel:
            return self.vae_seg.decode(z, True)
        return sp.run_stage(lambda x: self.vae_seg.decode(x, True), z,
                            self.mesh)

    def _graph(self, graph: Optional[bool]) -> Optional[bool]:
        """The sampler's ``graph`` flag: on a model axis the eager loop, as a
        CUDA graph cannot capture gloo's host-staged collectives."""
        if self.mesh.model > 1 and graph is not False:
            if self.device.type == "cuda" and not self._said_eager:
                self._said_eager = True
                print(f"sample_panoptic: the eager loop over a model axis of "
                      f"{self.mesh.model} ranks (no CUDA graph)", flush=True)
            return False
        return graph

    def _unet_apply(self, unet: Callable, latents: torch.Tensor,
                    rgb_latents: torch.Tensor,
                    condition: Optional[torch.Tensor], t,
                    dropout: Optional[torch.Tensor] = None,
                    context: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``unet(x, t, context)`` on [latents, rgb(, condition)] in the
        compute dtype, with the input dropout's draw when given; fp32
        out."""
        parts = [latents, rgb_latents]
        if condition is not None:
            parts.append(condition)
        inputs = torch.cat(parts, dim=1).to(self.compute_dtype)
        if dropout is not None:
            return unet(inputs, t, context, dropout=dropout).float()
        return unet(inputs, t, context).float()

    # ------------------------------------------------------------------
    # conditioning (JAX :455-545; reference process_inputs :722-735)
    # ------------------------------------------------------------------
    def tokenize(self, texts) -> Optional[np.ndarray]:
        """Captions -> ``[B, 77]`` int32 token ids (the descriptor's
        tokenizer; None without one)."""
        tok = self.descriptor.tokenizer
        if tok is None:
            return None
        enc = tok(list(texts), padding="max_length", max_length=77,
                  truncation=True, return_tensors="np")
        return enc["input_ids"].astype(np.int32)

    @torch.no_grad()
    def _clip_pixels(self, image) -> torch.Tensor:
        """ImageNet-normalised NHWC frames -> the CLIP vision tower's
        ``[B, 3, 224, 224]`` input (JAX :489-497): [0, 1], the antialiased
        linear resize of ``jax.image.resize`` (host-built weight matrices
        along H and W), CLIP's statistics."""
        x = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        mean = torch.tensor(_IMAGENET_MEAN, device=self.device)
        std = torch.tensor(_IMAGENET_STD, device=self.device)
        x01 = (x * std + mean).clamp(0.0, 1.0)
        wh, ww = (torch.from_numpy(resize_weight_matrix(n, 224)).to(
            self.device) for n in x.shape[1:3])
        pix = torch.einsum("bhwc,hH,wW->bHWc", x01, wh, ww)
        pix = (pix - torch.tensor(_CLIP_MEAN, device=self.device)) / \
            torch.tensor(_CLIP_STD, device=self.device)
        return pix.permute(0, 3, 1, 2).contiguous()

    @torch.no_grad()
    def context(self, batch: Mapping) -> Optional[torch.Tensor]:
        """The batch's ``encoder_hidden_states`` ``[B, T, D]`` (fp32) from
        the descriptor (JAX ``_context_impl`` after ``_device_batch``):
        ``none`` ``batch["context"]``; ``clip_text`` the text tower on
        ``batch["text_tokens"]`` (the tokenized ``batch["text"]``, or empty
        captions, where it has none); ``clip_vision`` the vision tower on
        ``batch["image"]``; ``remove`` and ``learnable`` (and a batch
        without what its descriptor reads) None."""
        kind = self.descriptor.kind
        if kind == "none":
            ctx = batch.get("context")
            return None if ctx is None else torch.as_tensor(
                ctx, device=self.device).float()
        if kind == "clip_text":
            ids = batch.get("text_tokens")
            if ids is None and self.descriptor.tokenizer is not None:
                n = len(batch["image"])
                ids = self.tokenize(batch.get("text", [""] * n))
            if ids is None:
                return None
            ids = torch.as_tensor(ids, device=self.device).long()
            return self.descriptor_model(input_ids=ids)[0].float()
        if kind == "clip_vision":
            return self.descriptor_model(
                pixel_values=self._clip_pixels(batch["image"]))[0].float()
        return None

    @torch.no_grad()
    def _uncond_context(self, context: Optional[torch.Tensor]
                        ) -> Optional[torch.Tensor]:
        """The unconditional branch's context (JAX :501-519): the empty
        caption's embedding for a text tower with a tokenizer (computed
        once, batch 1, and broadcast), zeros otherwise; None without a
        context."""
        if context is None:
            return None
        if (self.descriptor.kind == "clip_text"
                and self.descriptor.tokenizer is not None):
            if self._uncond_embed is None:
                ids = torch.as_tensor(self.tokenize([""]),
                                      device=self.device).long()
                self._uncond_embed = self.descriptor_model(
                    input_ids=ids)[0].float()
            e = self._uncond_embed
            return e.expand((context.shape[0],) + tuple(e.shape[1:]))
        return torch.zeros_like(context)

    def _guidance(self, context: Optional[torch.Tensor],
                  guidance_scale: Optional[float]):
        """(context, unconditional context or None) in the compute dtype,
        made before any capture, for a sampling call at ``guidance_scale``
        (default ``sampling_kwargs.guidance_scale``)."""
        gs = (self.guidance_scale if guidance_scale is None
              else float(guidance_scale))
        uncond = self._uncond_context(context) if gs != 1.0 else None
        cast = (lambda c: None if c is None  # noqa: E731
                else c.to(self.compute_dtype).contiguous())
        return cast(context), cast(uncond), gs

    def _model_fn(self, unet, rgb: torch.Tensor, context, uncond,
                  guidance_scale: float):
        """The sampler's ``model_fn`` on the RGB latents, with CFG when
        there is an unconditional context and the scale is not 1."""
        def model_fn(latents, condition, t):
            return self._unet_apply(unet, latents, rgb, condition, t,
                                    context=context)
        if uncond is None or guidance_scale == 1.0:
            return model_fn

        def uncond_fn(latents, condition, t):
            return self._unet_apply(unet, latents, rgb, condition, t,
                                    context=uncond)
        return cfg_model_fn(model_fn, uncond_fn, guidance_scale)

    # ------------------------------------------------------------------
    # training (the JAX trainer's _encode_impl, _train_step_impl and
    # train_loop)
    # ------------------------------------------------------------------
    def _nchw(self, x, dtype=torch.float32) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device).to(dtype)
        return x.permute(0, 3, 1, 2).contiguous()

    def _encode(self, batch: Mapping,
                generator: Optional[torch.Generator] = None,
                rgb_noise: Optional[torch.Tensor] = None):
        """Frozen encoders: bits -> seg latents (posterior mode, or a sample
        under ``sample_posterior``) and their mean, x ``seg_scale`` in fp32;
        RGB -> scaled RGB latents; the loss mask. All NCHW."""
        bits = self._nchw(batch["image_semseg"])
        post = self._seg_encode((2.0 * bits - 1.0).to(self.compute_dtype))
        latents_mean = (post.mode() * self.seg_scale).float()
        latents = latents_mean
        if self.sample_posterior:
            latents = (post.sample(generator) * self.seg_scale).float()
        rgb_latents = self._encode_rgb(batch["image"], generator, rgb_noise)
        loss_mask = self._loss_weight_mask(batch, latents.shape[-2:])
        return latents, latents_mean, rgb_latents, loss_mask

    def _loss_weight_mask(self, batch: Mapping, latent_hw
                          ) -> Optional[torch.Tensor]:
        """``type_mask`` 'ignore' / 'counts' / 'padding' / 'none' at the
        latent size ``[B, h, w]``; the nearest resize keeps half-pixel
        centres, as ``jax.image.resize`` does."""
        if self.type_mask == "none":
            return None
        key = "mask" if self.type_mask == "padding" else "semseg"
        src = torch.as_tensor(batch[key], device=self.device).float()
        t = F.interpolate(src[:, None], size=tuple(latent_hw),
                          mode="nearest-exact")[:, 0]
        if self.type_mask == "padding":
            return t
        if self.type_mask == "ignore":
            return (t != self.ignore_label).float()
        if self.type_mask != "counts":
            raise ValueError(f"type_mask {self.type_mask!r}")
        # 1 / pixel count of the pixel's class, 0 at ignore
        ti = t.long()
        hist = torch.stack([torch.bincount(x.reshape(-1),
                                           minlength=self.num_classes)
                            [:self.num_classes] for x in ti])
        inv = 1.0 / hist.clamp(min=1).float()
        m = torch.gather(inv, 1, ti.reshape(ti.shape[0], -1)).reshape(t.shape)
        return torch.where(ti == self.ignore_label, torch.zeros_like(m), m)

    def _compute_unet(self) -> Callable:
        """The UNet on the masters cast to the compute dtype, cast once per
        step. The cast is differentiable, so the gradients of a forward on it
        land in fp32 on the masters."""
        params = {n: p.to(self.compute_dtype)
                  for n, p in self.unet.named_parameters()}
        return lambda x, t, context=None, dropout=None: \
            torch.func.functional_call(self.unet, params, (x, t, context),
                                       {"dropout": dropout})

    @torch.no_grad()
    def _predict_sample(self, unet: Callable, latents: torch.Tensor,
                        rgb_latents: torch.Tensor,
                        generator: Optional[torch.Generator], tmax: int,
                        context: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """One denoise at a random t < ``tmax``, clipped to the latents'
        range (the JAX trainer's ``_predict_sample``)."""
        noise = torch.randn(latents.shape, generator=generator,
                            device=self.device)
        t = torch.randint(0, tmax, (latents.shape[0],), generator=generator,
                          device=self.device)
        noisy = add_noise(self.sched, latents, noise, t)
        cond = torch.zeros_like(noisy) if self.self_condition else None
        pred = self._unet_apply(unet, noisy, rgb_latents, cond, t,
                                context=context)
        out = remove_noise(self.sched, noisy, pred, t)
        return out.clamp(latents.min(), latents.max())

    @staticmethod
    def _per_frame(batch: Mapping, bc: int, tt: int) -> dict:
        """A clip batch's conditioning over its flattened frames (JAX
        :1041-1059): ``text``, ``text_tokens`` and ``context`` given per
        clip repeat T times (clip i's frames are contiguous); already flat
        ``[B*T, ...]`` ones pass through."""
        out = {}
        if "text" in batch:
            out["text"] = ([s for s in batch["text"] for _ in range(tt)]
                           if len(batch["text"]) == bc else
                           list(batch["text"]))
        for key in ("text_tokens", "context"):
            if key in batch:
                v = batch[key]
                v = v if isinstance(v, torch.Tensor) else np.asarray(v)
                if v.shape[0] == bc:
                    v = (v.repeat_interleave(tt, 0)
                         if isinstance(v, torch.Tensor)
                         else np.repeat(v, tt, axis=0))
                out[key] = v
        return out

    def forward_backward(self, batch: Mapping,
                         generator: Optional[torch.Generator] = None,
                         noise=None, timesteps=None, rgb_noise=None,
                         dropout=None, context=None):
        """One training step without the optimizer update: the loss's
        gradients are added to the masters' ``.grad``. ``noise`` (NHWC,
        the latents' shape), ``timesteps`` (``[B]``), ``rgb_noise`` (the RGB
        posterior's sample under ``sample_posterior_rgb``, NCHW) and
        ``dropout`` (the UNet's input dropout draw, NCHW, the UNet input's
        shape) replace the draws from ``generator``; ``context`` replaces
        the descriptor's (:meth:`context`; a clip's per-clip conditioning
        repeats over its frames); the other draws
        (posterior sample, predicted latents, inpainting, condition and RGB
        noise) come from it. The input dropout acts on the forward whose
        gradient trains (JAX's trainer never turns it on: its apply keeps
        ``deterministic=True``).

        A clip batch (``image`` ``[B, T, H, W, 3]``) trains its frames
        flattened clip-major to ``[B*T, ...]`` (``noise`` and ``timesteps``
        then have B*T rows) with one timestep per clip drawn and repeated T
        times; with a pose net attached, ``temporal_consistency_weight`` >
        0 and ``depth`` in the batch the loss gains that weight times the
        temporal-consistency term (:meth:`_consistency`), reported as
        ``metrics['consistency']`` (0 otherwise). Returns ``(loss, metrics,
        pred_x0)``, ``pred_x0`` NHWC."""
        clip_image, clip_shape = batch["image"], None
        if getattr(clip_image, "ndim", 4) == 5:
            _refuse_video(self.mesh, "a clip batch")
            clip_shape = tuple(clip_image.shape[:2])
        self._require_params()
        dev = self.device
        if clip_shape is not None:
            batch = dict(batch, **{
                k: batch[k].reshape((-1,) + tuple(batch[k].shape[2:]))
                for k in _FRAME_KEYS if k in batch},
                **self._per_frame(batch, *clip_shape))
        with torch.no_grad():
            latents, latents_mean, rgb_latents, loss_mask = self._encode(
                batch, generator, rgb_noise)
        b = latents.shape[0]
        unet = self._compute_unet()
        if context is None:
            context = self.context(batch)
        else:
            context = torch.as_tensor(context, device=dev).float()

        pose_info = None
        if (clip_shape is not None and self.pose_model is not None
                and self.temporal_consistency_weight > 0
                and "depth" in batch):
            poses, mid, ref_idx = self._clip_poses(torch.as_tensor(
                clip_image, device=dev))
            depth, focal = self._clip_depth_focal(batch)
            d_lat, f_lat = self._latent_depth_focal(
                depth, focal, *latents.shape[-2:])
            pose_info = (poses, mid, ref_idx, d_lat, f_lat)

        if self.prob_train_on_pred > 0:
            pred_latents = self._predict_sample(
                unet, latents, rgb_latents, generator,
                tmax=self.sched.num_train_timesteps // 2, context=context)
            take = torch.rand((b, 1, 1, 1), generator=generator,
                              device=dev) < self.prob_train_on_pred
            latents = torch.where(take, pred_latents, latents)

        if noise is None:
            noise = torch.randn(latents.shape, generator=generator,
                                device=dev)
        else:
            noise = self._nchw(noise)
        if timesteps is None and clip_shape is not None:
            # one timestep per clip, shared by its frames, so that their x0
            # estimates are comparable for the consistency term
            timesteps = torch.randint(
                self.min_noise_level, self.sched.num_train_timesteps,
                clip_shape[:1], generator=generator,
                device=dev).repeat_interleave(clip_shape[1])
        elif timesteps is None:
            timesteps = torch.randint(
                self.min_noise_level, self.sched.num_train_timesteps, (b,),
                generator=generator, device=dev)
        else:
            timesteps = torch.as_tensor(timesteps, device=dev).long()
        noisy = add_noise(self.sched, latents, noise, timesteps)

        inpaint = None
        if self.prob_inpainting > 0:
            m = torch.as_tensor(batch["inpainting_mask"],
                                device=dev).float()[:, None]
            m = F.interpolate(m, size=tuple(latents.shape[-2:]),
                              mode="nearest-exact")
            on = torch.rand((b, 1, 1, 1), generator=generator,
                            device=dev) < self.prob_inpainting
            inpaint = m * on

        condition = None
        if self.self_condition:
            # first pass without gradient, on the same compute-dtype weights
            with torch.no_grad():
                pred0 = self._unet_apply(
                    unet, noisy, rgb_latents, torch.zeros_like(noisy),
                    timesteps, context=context)
                condition = remove_noise(self.sched, noisy, pred0, timesteps)
                if self.cond_noise_level > 0:
                    cn = torch.randn(condition.shape, generator=generator,
                                     device=dev)
                    tc = torch.randint(0, self.cond_noise_level, (b,),
                                       generator=generator, device=dev)
                    condition = add_noise(self.sched, condition, cn, tc)

        rgb_in = rgb_latents
        if self.rgb_noise_level > 0:
            rn = torch.randn(rgb_in.shape, generator=generator, device=dev)
            t_img = torch.randint(0, self.rgb_noise_level, (b,),
                                  generator=generator, device=dev)
            rgb_in = add_noise(self.sched, rgb_in, rn, t_img)
        cfg = self.unet_config
        if cfg.dropout > 0 and dropout is None:
            dropout = draw_input_dropout(
                (b, cfg.in_channels) + tuple(noisy.shape[-2:]),
                cfg.dropout, cfg.dropout_mode, generator, dev)
        pred = self._unet_apply(unet, noisy, rgb_in, condition, timesteps,
                                dropout if cfg.dropout > 0 else None,
                                context=context)
        target = (noise if self.sched.prediction_type == "epsilon"
                  else latents_mean)
        loss = diffusion_loss(
            pred, target, timesteps=timesteps,
            schedule_weights=self.sched.weights, loss_mask=loss_mask,
            loss_type=self.loss_type, ohem_ratio=self.ohem_ratio,
            group=self.mesh.loss_group)
        cons = torch.zeros((), device=dev)
        if pose_info is not None:
            x0p = (remove_noise(self.sched, noisy, pred, timesteps)
                   if self.sched.prediction_type == "epsilon" else pred)
            cons = self._consistency(x0p, clip_shape, pose_info)
            loss = loss + self.temporal_consistency_weight * cons
        loss.backward()

        with torch.no_grad():
            pred = pred.detach()
            if self.sched.prediction_type == "epsilon":
                pred_x0 = remove_noise(self.sched, noisy, pred, timesteps)
            else:
                pred_x0 = pred
            if inpaint is not None:
                pred_x0 = torch.where(inpaint > 0, latents_mean, pred_x0)
        loss = loss.detach()
        metrics = {"loss": loss,
                   "timestep_mean": timesteps.float().mean(),
                   "consistency": cons.detach()}
        return loss, metrics, pred_x0.permute(0, 2, 3, 1).contiguous()

    def train_step(self, batch: Mapping,
                   generator: Optional[torch.Generator] = None,
                   noise=None, timesteps=None):
        """:meth:`forward_backward`, then the optimizer (every
        ``accumulate`` micro-batches). Returns ``(loss, metrics, pred_x0)``;
        the loss stays on the device."""
        out = self.forward_backward(batch, generator, noise, timesteps)
        self.state.apply_gradients()
        return out

    def train_loop(self, max_steps: Optional[int] = None,
                   log_every: int = 20, seed: int = 0,
                   save_every: Optional[int] = None,
                   eval_every: Optional[int] = None,
                   eval_kwargs: Optional[dict] = None,
                   vis_every: Optional[int] = None) -> List[float]:
        """Train on ``dataset`` for ``max_steps`` calls of :meth:`train_step`
        (default ``train_num_steps``), with the draws from a generator
        seeded by ``seed``: batches from the threaded loader
        (:func:`~..data.loader.make_loader`) through the double-buffered H2D
        (:func:`~..data.loader.prefetch_to_device`). Losses are read back
        from the device only every ``log_every`` steps, when the mean is
        printed and the last one logged to ``metrics.jsonl``. Every
        ``save_every`` optimizer steps :meth:`save` writes ``step_N`` (JAX's
        ``train_loop`` saves every 2000 by default; ``main_ldm`` passes
        that); with ``eval_every`` (default ``eval_kwargs.eval_every``)
        :meth:`compute_pq` runs before the first step and every
        ``eval_every`` optimizer steps with ``save_model=True``, its PQ
        logged; every ``vis_every`` steps :meth:`log_images_train` writes
        the step's panel. Returns every step's loss.

        Under data parallelism each rank loads its rows of every global
        batch, draws from a generator seeded by ``(seed, data rank)``
        (:func:`rank_seed`), and the losses read back are the data group's
        means; only the main process prints and writes."""
        if self.ds is None:
            raise ValueError("TrainerDiffusion.train_loop needs a dataset")
        self._require_params()
        if eval_every is None:
            eval_every = self.p["eval_kwargs"].get("eval_every")
        if save_every or eval_every or vis_every:
            self._folder()
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
        meter = AverageMeter("loss", ":.4f")
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
                    loss, _, pred_x0 = self.train_step(batch,
                                                       generator=generator)
                    pending.append(loss)
                    step += 1
                    if vis_every and step % vis_every == 0 and main:
                        self.log_images_train(batch, pred_x0, step)
                    gstep = self.state.step
                    if step % log_every == 0 or step == max_steps:
                        values = group_mean(torch.stack(pending),
                                            self.mesh).tolist()
                        pending.clear()
                        losses += values
                        for v in values:
                            meter.update(v, self.batch_size)
                        self.metrics.log(gstep, loss=meter.val)
                        if main:
                            print(f"Epoch [{epoch}] step {step}/"
                                  f"{max_steps}: loss "
                                  f"{sum(values) / len(values):.4f} "
                                  f"({time.perf_counter() - t0:.1f} s)",
                                  flush=True)
                    if gstep != before:
                        if save_every and gstep % save_every == 0:
                            self.save(gstep)
                        if eval_every and gstep % eval_every == 0:
                            self._eval_during_training(gstep, eval_kw)
                    if step >= max_steps:
                        break
            finally:
                batches.close()
            epoch += 1
        return losses

    # ------------------------------------------------------------------
    # image logging (JAX :724-777)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def log_images_train(self, batch: Mapping, pred_x0, step: int) -> str:
        """``rgb_gt_pred_<step>.jpg``: the first frame, its ground truth and
        the argmax of the seg VAE's decode of its predicted x0 latents
        (``pred_x0`` NHWC, from :meth:`train_step`), resized to the labels'
        size (trainers_ldm_cond.py:1378-1512)."""
        from ..utils.visualization import save_train_panel, to_numpy
        from .restore import resize_logits
        z = torch.as_tensor(pred_x0[:1], device=self.device).permute(
            0, 3, 1, 2) * (1.0 / self.seg_scale)
        logits = self.vae_seg.decode(z.to(self.compute_dtype), True).float()
        pred = resize_logits(logits.permute(0, 2, 3, 1),
                             batch["semseg"].shape[1:3]).argmax(-1)
        path = os.path.join(self._folder(), f"rgb_gt_pred_{step}.jpg")
        save_train_panel(path, to_numpy(batch["image"][0]),
                         to_numpy(batch["semseg"][0]), to_numpy(pred[0]))
        self.metrics.log_image(step, "train_panel", path)
        return path

    def log_images_val(self, batch: Mapping, logits,
                       identifier: str = "") -> str:
        """``overview<identifier>.png``: columns the batch's frames, rows
        RGB, ground truth (when the batch has it), the sampled prediction
        and the inpainting mask (when it has one), the logits resized to
        the frames' size (trainers_ldm_cond.py:1378-1438)."""
        from ..utils.visualization import save_val_overview, to_numpy
        from .restore import resize_logits
        img = to_numpy(batch["image"])
        pred = resize_logits(torch.as_tensor(logits),
                             img.shape[1:3]).argmax(-1)
        path = os.path.join(self._folder(), f"overview{identifier}.png")
        save_val_overview(
            path, img,
            to_numpy(batch["semseg"]) if "semseg" in batch else None,
            to_numpy(pred),
            inpainting=(to_numpy(batch["inpainting_mask"])
                        if "inpainting_mask" in batch else None))
        self.metrics.log_image(self.state.step if self.state else 0,
                               "val_overview", path)
        return path

    def visualize_noise_schedule(self, seed: int = 42) -> str:
        """``noise_schedule.jpg``: the first val (else train) sample's bits
        noised at strided timesteps, decoded and stacked
        (trainers_ldm_cond.py:1625-1660; one normal draw from a CPU
        generator seeded ``seed``)."""
        from ..utils.visualization import noise_schedule_panel
        ds = self.ds_val if self.ds_val is not None else self.ds
        return noise_schedule_panel(
            os.path.join(self._folder(), "noise_schedule.jpg"), self.sched,
            np.asarray(ds[0]["image_semseg"]), seed=seed)

    def _eval_during_training(self, step: int, eval_kw: dict):
        """In-training eval with the best-PQ snapshot (JAX :779-790)."""
        if self.ds_val is None:
            return None
        res = self.compute_pq(save_model=True, **eval_kw)
        self.metrics.log(step, pq=res["pq"], sq=res.get("sq"),
                         rq=res.get("rq"), best_pq=self.best_pq)
        if is_main_process():
            print(f"[eval @ step {step}] PQ {res['pq']:.2f} "
                  f"(best {self.best_pq:.2f})", flush=True)
        return res

    # ------------------------------------------------------------------
    # checkpoints (the JAX trainer's save, resume, _rotate_checkpoints and
    # export_reference, :1287-1400)
    # ------------------------------------------------------------------
    def _folder(self) -> str:
        if not self.results_folder:
            raise ValueError("TrainerDiffusion: checkpoints need a "
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
        """``torch.save`` of ``{params, opt_state, step, best_pq,
        ema_params?}`` (the masters and the EMA by parameter name, the
        optimizer's :meth:`~.optim.Optimizer.state_dict`; all on the CPU)
        under ``results_folder`` as ``tag`` or ``step_N``, then the newest 3
        ``step_*`` are kept. Returns the path. Under data parallelism every
        rank calls it (ZeRO-1 gathers the optimizer state onto the main
        process) and the main process writes. Under tensor parallelism the
        first data rank's model ranks gather their shards of the masters,
        the EMA and the optimizer state onto the main process: the
        checkpoint is the one-rank layout."""
        self._require_params()
        name = tag or f"step_{step or self.state.step}"
        path = os.path.join(self._folder(), name)
        opt = self.state.optimizer
        lay = tp.layout(self.unet)
        writers = self.mesh.data_rank == 0 if lay else is_main_process()
        # collective under ZeRO-1; otherwise only the writers copy it
        opt_state = (opt.state_dict() if opt.owner is not None or writers
                     else None)
        if not writers:
            return path
        main = is_main_process()
        named = list(self.unet.named_parameters())
        names = [n for n, _ in named]
        params = tp.full_tensors(self.mesh, named, lay, main)
        ema = None
        if self.state.ema_params is not None:
            ema = tp.full_tensors(self.mesh, list(zip(
                names, self.state.ema_params)), lay, main)
        if lay:
            opt_state = self._whole_opt_state(opt_state, main)
        if not main:
            return path
        payload = {"params": dict(zip(names, params)),
                   "opt_state": opt_state,
                   "step": int(self.state.step),
                   "best_pq": float(self.best_pq)}
        if ema is not None:
            payload["ema_params"] = dict(zip(names, ema))
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        self._rotate_checkpoints()
        return path

    def _grouped_names(self) -> List[str]:
        """The UNet's parameter names in the optimizer's grouped order (the
        index of its state)."""
        name = {id(q): n for n, q in self.unet.named_parameters()}
        return [name[id(q)] for q in self.state.optimizer.grouped]

    def _opt_tensors(self, opt_state: dict):
        """``(name, state, key)`` of each of the optimizer state's tensors
        that mirror a sharded parameter (AdamW's moments)."""
        lay = tp.layout(self.unet)
        names = self._grouped_names()
        return [(names[i], st, k) for i, st in sorted(
            opt_state["torch"]["state"].items())
            for k, v in st.items() if names[i] in lay
            and isinstance(v, torch.Tensor) and v.dim() > 0]

    def _whole_opt_state(self, opt_state: dict, keep: bool):
        """Tensor parallelism: the model ranks' shards of the optimizer
        state (each a one-rank state dict over its shards) gathered into
        the one-rank state dict on ``keep``'s rank (collective over the
        model group)."""
        items = self._opt_tensors(opt_state)
        whole = tp.full_tensors(
            self.mesh, [(n, st[k].to(self.device)) for n, st, k in items],
            tp.layout(self.unet), keep)
        if keep:
            for (_, st, k), t in zip(items, whole):
                st[k] = t
        return opt_state

    def _local_checkpoint(self, data: dict) -> dict:
        """Tensor parallelism: a one-rank checkpoint cut to this model
        rank's shards (the masters, the EMA, the optimizer's moments)."""
        lay = tp.layout(self.unet)
        ax = sp.model_axis(self.mesh)

        def cut(n, t):
            d, pairs = lay[n]
            return tp.local_tensor(t, d, ax, pairs)
        for key in ("params", "ema_params"):
            if key in data:
                data[key] = {n: cut(n, t) if n in lay else t
                             for n, t in data[key].items()}
        if data.get("opt_state") and "torch" in data["opt_state"]:
            for n, st, k in self._opt_tensors(data["opt_state"]):
                st[k] = cut(n, st[k])
        return data

    def _rotate_checkpoints(self, keep: int = 3) -> None:
        """Keep the newest ``keep`` step checkpoints; tagged ones, such as
        ``best_model``, are never removed."""
        for path in self._step_checkpoints()[:-keep]:
            os.remove(path)

    def resume(self, path: Optional[str] = None) -> Optional[str]:
        """Restore a checkpoint of :meth:`save` (default the newest
        ``step_*``; none: start fresh and return None). It is read on the
        CPU (``weights_only``) and ``copy_``'d into the live masters, EMA
        and optimizer state, never a second copy on the device. A
        checkpoint without ``best_pq`` or ``ema_params`` keeps the current
        ones. Resumed weights count as pretrained for the int8 scale
        guard. Under tensor parallelism each model rank takes its shards of
        the one-rank checkpoint."""
        self._require_params()
        if path is None:
            found = self._step_checkpoints()
            if not found:
                if is_main_process():
                    print("No checkpoint found; starting fresh", flush=True)
                return None
            path = found[-1]
        data = torch.load(path, map_location="cpu", weights_only=True)
        if tp.layout(self.unet):
            # this model rank's shards of the one-rank layout
            data = self._local_checkpoint(data)
        named = dict(self.unet.named_parameters())
        if set(named) != set(data["params"]):
            raise ValueError(f"checkpoint {path} holds another UNet: "
                             f"{sorted(set(named) ^ set(data['params']))[:5]}")
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(data["params"][n])
            if self.state.ema_params is not None and "ema_params" in data:
                for n, e in zip(named, self.state.ema_params):
                    e.copy_(data["ema_params"][n])
        self.state.zero_grad()
        self.state.optimizer.load_state_dict_(data["opt_state"])
        self.state.step = int(data["step"])
        self.state.micro_step = self.state.step * self.state.accumulate
        self.best_pq = float(data.get("best_pq", self.best_pq))
        self._params_pretrained = True
        del data
        if is_main_process():
            print(f"Resumed from {path} at step {self.state.step}",
                  flush=True)
        return path

    def export_reference(self, path: str, use_ema: bool = False) -> str:
        """Write the current model as the reference's torch stage-2 save
        dict ``{step, epoch, vae_image, vae_semseg, unet, ema?}``
        (:func:`~..models.torch_export.export_reference_ldm`), the EMA only
        with ``use_ema`` and ``ema_on``. Under tensor parallelism every
        model rank calls it and the main process writes the gathered
        UNet."""
        from ..models.torch_export import export_reference_ldm
        self._require_params()
        vk = self.p["vae_model_kwargs"]
        lay, main = tp.layout(self.unet), is_main_process()

        def whole(module):
            # under tensor parallelism every model rank gathers with the
            # main process, which writes
            if not lay:
                return module.state_dict()
            named = list(module.named_parameters())
            return dict(zip([n for n, _ in named],
                            tp.full_tensors(self.mesh, named, lay, main)
                            or []))
        unet = whole(self.unet)
        ema = whole(self._eval_unet) if use_ema and self.ema_on else None
        if lay and not main:
            return path
        export_reference_ldm(
            path, unet, self.vae_img.state_dict(),
            self.vae_seg.state_dict(), self.unet_config,
            block_out_channels=tuple(vk["block_out_channels"]),
            num_upscalers=vk.get("num_upscalers", 1), ema=ema,
            step=int(self.state.step))
        return path

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _sample_decode(self, unet: nn.Module, rgb_latents: torch.Tensor,
                       generator: Optional[torch.Generator],
                       init_noise=None, num_inference_steps: int = 50,
                       repeat_noise: bool = False,
                       graph: Optional[bool] = None,
                       context: Optional[torch.Tensor] = None,
                       uncond_context: Optional[torch.Tensor] = None,
                       guidance_scale: float = 1.0):
        b, _, lh, lw = rgb_latents.shape
        if init_noise is not None:
            init = torch.as_tensor(init_noise, dtype=torch.float32,
                                   device=self.device)
            if tuple(init.shape) != (b, lh, lw, 4):
                raise ValueError(f"init_noise must be [B, h, w, 4] = "
                                 f"{(b, lh, lw, 4)}, got {tuple(init.shape)}")
            init = init.permute(0, 3, 1, 2).contiguous()
        else:
            init = torch.randn((b, 4, lh, lw), generator=generator,
                               device=self.device)
        if repeat_noise:
            # one noise map shared by the batch (JAX :859-861)
            init = init[:1].expand_as(init).contiguous()

        model_fn = self._model_fn(unet, rgb_latents, context,
                                  uncond_context, guidance_scale)
        sample_fn = (dpmpp_2m_sample if self.sampler == "dpmpp_2m"
                     else ddim_sample)
        x0 = sample_fn(self.sched, model_fn, init,
                       num_inference_steps=num_inference_steps,
                       self_condition=self.self_condition,
                       graph=self._graph(graph))
        z = (x0 * (1.0 / self.seg_scale)).to(self.compute_dtype)
        logits = self._seg_decode(z).float()
        return logits, x0

    def sample_panoptic(self, batch: Mapping,
                        generator: Optional[torch.Generator] = None,
                        init_noise=None,
                        num_inference_steps: Optional[int] = None,
                        repeat_noise: bool = False,
                        guidance_scale: Optional[float] = None,
                        graph: Optional[bool] = None):
        """``batch["image"]`` ``[B, H, W, 3]`` (ImageNet-normalised) ->
        (logits ``[B, H, W, C]`` fp32, x0 latents ``[B, H/8, W/8, 4]``).
        ``init_noise`` (NHWC) replaces the draw of the initial noise from
        ``generator``; with neither, the generator is seeded from
        ``sampling_kwargs.seed``. ``repeat_noise`` gives every frame row 0
        of that noise. The descriptor's context (:meth:`context`) goes to
        every UNet call; with one, ``guidance_scale`` (default
        ``sampling_kwargs.guidance_scale``) != 1 runs classifier-free
        guidance, two UNet calls a step (JAX :853-932); without one it has
        no effect. With
        ``int8_inference`` the steps run on :meth:`int8_unet`; with
        ``sampling_kwargs.sampler: dpmpp_2m`` they are DPM-Solver++(2M)'s.
        On the card the steps replay a CUDA graph unless ``graph`` is False
        (:func:`~..diffusion.sampler.ddim_sample`,
        :func:`~..diffusion.dpm.dpmpp_2m_sample`)."""
        self._require_params()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed)
        if self.int8_inference:
            self._ensure_int8_ready(batch, generator)
            unet = self.int8_unet()
        else:
            unet = self.inference_unet()
        with torch.inference_mode():
            rgb_latents = self._encode_rgb(batch["image"], generator)
            context, uncond, gs = self._guidance(self.context(batch),
                                                 guidance_scale)
            logits, x0 = self._sample_decode(
                unet, rgb_latents, generator, init_noise,
                num_inference_steps or self.num_inference_steps,
                repeat_noise, graph, context, uncond, gs)
        return (logits.permute(0, 2, 3, 1).contiguous(),
                x0.permute(0, 2, 3, 1).contiguous())

    def _noise(self, given, shape, generator, what: str) -> torch.Tensor:
        """NHWC ``given`` ``[B, n, h, w, 4]`` as ``[B, n, 4, h, w]``, or a
        draw of ``shape`` from ``generator``."""
        if given is None:
            return torch.randn(shape, generator=generator,
                               device=self.device)
        x = (given.to(self.device, torch.float32)
             if isinstance(given, torch.Tensor) else
             torch.tensor(np.asarray(given), dtype=torch.float32,
                          device=self.device))
        want = (shape[0], shape[1], shape[3], shape[4], shape[2])
        if tuple(x.shape) != want:
            raise ValueError(f"{what} must be [B, n, h, w, 4] = {want}, got "
                             f"{tuple(x.shape)}")
        return x.permute(0, 1, 4, 2, 3)

    def sample_panoptic_clip(self, batch: Mapping,
                             generator: Optional[torch.Generator] = None,
                             init_noise=None, refine_noise=None,
                             num_inference_steps: Optional[int] = None,
                             repeat_noise: bool = True,
                             pose_warp: bool = True,
                             refine_strength: float = 0.3,
                             warp_blend: float = 0.5,
                             guidance_scale: Optional[float] = None,
                             graph: Optional[bool] = None):
        """A clip batch ``image`` ``[B, T, H, W, 3]`` -> (logits
        ``[B*T, H, W, C]``, x0 ``[B*T, h, w, 4]``), frames clip-major (JAX
        ``_sample_clip_impl``, :935-1021): every frame encoded in one
        batch (the posterior's mode), then DDIM (or DPM-Solver++(2M)) from
        clip-shared noise (``repeat_noise``: one map per clip, else one
        per frame); then, with a pose net attached and ``pose_warp``, the
        middle frame's x0 warped into each other frame r by the inverse of
        the predicted target->ref pose and the frame's depth
        (``batch['depth']``, focal from ``meta``), blended in by
        ``warp_blend`` where valid, and the whole clip refined by a DDIM
        tail of ``refine_strength`` of the steps
        (:func:`~..diffusion.sampler.ddim_refine`; DDIM after a DPM first
        pass too) from clip-shared re-noising; then the seg-VAE decode.
        ``init_noise`` (NHWC ``[B, 1 or T, h, w, 4]``) and
        ``refine_noise`` (``[B, 1, h, w, 4]``) replace the draws from
        ``generator`` (default: seeded from ``sampling_kwargs.seed``).
        The descriptor's context and ``guidance_scale`` act per flattened
        frame as in :meth:`sample_panoptic`, in both passes; ``text``,
        ``text_tokens`` and ``context`` may be given per clip (repeated
        over its frames) or per frame.
        int8 with ``int8_inference``. On the card both passes replay CUDA
        graphs, each captured afresh, unless ``graph`` is False. Not over
        a model axis."""
        _refuse_video(self.mesh, "sample_panoptic_clip")
        self._require_params()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                self.seed)
        image = torch.as_tensor(batch["image"], device=self.device)
        if image.ndim != 5:
            raise ValueError(f"sample_panoptic_clip needs a clip batch "
                             f"[B, T, H, W, 3], got {tuple(image.shape)}")
        if self.int8_inference:
            self._ensure_int8_ready({"image": image}, generator)
            unet = self.int8_unet()
        else:
            unet = self.inference_unet()
        bc, tt = image.shape[:2]
        steps = num_inference_steps or self.num_inference_steps
        warp = pose_warp and self.pose_model is not None
        with torch.inference_mode():
            rgb = self._encode_rgb(image.reshape((-1,) + image.shape[2:]),
                                   sample=False)
            b, _, lh, lw = rgb.shape
            init = self._noise(init_noise, (bc, 1 if repeat_noise else tt,
                                            4, lh, lw), generator,
                               "init_noise")
            init = init.expand(bc, tt, 4, lh, lw).reshape(b, 4, lh, lw)
            flat = {"image": image.reshape((-1,) + image.shape[2:]),
                    **self._per_frame(batch, bc, tt)}
            context, uncond, gs = self._guidance(self.context(flat),
                                                 guidance_scale)
            model_fn = self._model_fn(unet, rgb, context, uncond, gs)
            sample_fn = (dpmpp_2m_sample if self.sampler == "dpmpp_2m"
                         else ddim_sample)
            x0 = sample_fn(self.sched, model_fn, init.contiguous(),
                           num_inference_steps=steps,
                           self_condition=self.self_condition, graph=graph)
            if warp:
                poses, mid, ref_idx = self._clip_poses(image)
                depth, focal = self._clip_depth_focal(batch)
                d_lat, f_lat = self._latent_depth_focal(depth, focal, lh, lw)
                x0c = x0.reshape(bc, tt, 4, lh, lw)
                anchor = x0c[:, mid]
                frames = [x0c[:, i] for i in range(tt)]
                for i, r in enumerate(ref_idx):
                    # anchor -> frame r: the inverse of the predicted
                    # target->ref pose
                    minv = invert_pose_mat(pose_vec_to_mat(poses[:, i]))
                    warped, valid = inverse_warp(anchor, d_lat[:, r], minv,
                                                 f_lat, channels_last=False)
                    v = valid[:, None].float()
                    frames[r] = (1 - v * warp_blend) * frames[r] + \
                        v * warp_blend * warped
                blended = torch.stack(frames, dim=1).reshape(x0.shape)
                noise = self._noise(refine_noise, (bc, 1, 4, lh, lw),
                                    generator, "refine_noise")
                noise = noise.expand(bc, tt, 4, lh, lw).reshape(x0.shape)
                x0 = ddim_refine(self.sched, model_fn, blended,
                                 noise.contiguous(),
                                 num_inference_steps=steps,
                                 strength=refine_strength,
                                 self_condition=self.self_condition,
                                 graph=graph)
            z = (x0 * (1.0 / self.seg_scale)).to(self.compute_dtype)
            logits = self.vae_seg.decode(z, True).float()
        return (logits.permute(0, 2, 3, 1).contiguous(),
                x0.permute(0, 2, 3, 1).contiguous())

    # ------------------------------------------------------------------
    # eval (the JAX trainer's compute_metrics, compute_pq, _eval_fullres
    # and _fullres_post, :1152-1284)
    # ------------------------------------------------------------------
    def compute_metrics(self, metrics=("pq",), **kw) -> dict:
        """Eval dispatcher (JAX :1152)."""
        out = {}
        if "pq" in metrics:
            out["pq"] = self.compute_pq(**kw)
        return out

    def compute_pq(self, num_inference_steps: Optional[int] = None,
                   max_batches: Optional[int] = None,
                   thing_ids=frozenset(), save_model: bool = False,
                   seed: int = 0, log_images: Optional[bool] = None,
                   evaluator=None) -> dict:
        """Sampled-segmentation PQ on ``val_dataset`` (JAX :1159): its
        batches in order (``shuffle=False, drop_last=False``), each through
        :meth:`sample_panoptic` with the draws from a generator seeded by
        ``seed``; with full-resolution ground truth in every meta
        (``gt_sem``, ``keep_fullres_gt``) :meth:`restore_fullres`, else the
        bilinear resize to ``semseg``'s size and post-processing under
        ``mask``; scored by ``PanopticEvaluator`` (class-agnostic without
        ``thing_ids``). With ``save_model`` a PQ above ``best_pq`` becomes
        it and is saved as ``best_model`` (a ``results_folder`` is needed
        up front). ``log_images`` (default ``eval_kwargs.log_images``)
        writes the first batch's overview strip (:meth:`log_images_val`).
        ``evaluator`` replaces the ``PanopticEvaluator`` it fills. Under
        data parallelism each data rank samples its share of the val set
        (each sample once) with a generator seeded ``(seed, data rank)``,
        and the evaluator sums the ranks' counters before it scores; every
        rank returns the same results."""
        if log_images is None:
            log_images = bool(self.p["eval_kwargs"].get("log_images", False))
        if save_model or log_images:
            self._folder()
        from ..evals import PanopticEvaluator
        if self.ds_val is None:
            raise ValueError("TrainerDiffusion.compute_pq needs a "
                             "val_dataset")
        ev = evaluator
        if ev is None:
            ev = PanopticEvaluator(thing_ids=set(thing_ids),
                                   class_agnostic=not thing_ids,
                                   ignore_label=self.ignore_label)
        ev.group = self.mesh.data_group
        loader = make_loader(self.ds_val, self.batch_size, shuffle=False,
                             drop_last=False, pad=False, mesh=self.mesh)
        generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, self.mesh))
        batches = loader.epoch(0)
        try:
            for i, batch in enumerate(batches):
                logits, _ = self.sample_panoptic(
                    batch, generator,
                    num_inference_steps=num_inference_steps)
                if log_images and i == 0 and is_main_process():
                    self.log_images_val(batch, logits,
                                        identifier=f"_val{self.state.step}")
                metas = batch.get("meta")
                if metas and all("gt_sem" in m for m in metas):
                    self._eval_fullres(ev, logits, metas)
                else:
                    h, w = batch["semseg"].shape[1:3]
                    cleaned = self.restore_resized(logits, (h, w),
                                                   batch["mask"])
                    for bi in range(cleaned.shape[0]):
                        ev.add_image(cleaned[bi], batch["semseg"][bi])
                if max_batches is not None and i + 1 >= max_batches:
                    break
        finally:
            batches.close()
        results = ev.evaluate(synchronize=self.mesh.data > 1)
        if save_model and results["pq"] > self.best_pq:
            self.best_pq = results["pq"]
            self.save(tag="best_model")
        return results

    def _eval_fullres(self, ev, logits: torch.Tensor, metas,
                      bucket: int = 128) -> None:
        """Each prediction restored to its own ground truth's resolution
        (:meth:`restore_fullres`) and scored against ``gt_sem`` (and
        ``gt_inst`` where the reader gives it)."""
        for m, cleaned in zip(metas, self.restore_fullres(logits, metas,
                                                          bucket)):
            ev.add_image(cleaned, m["gt_sem"], m.get("gt_inst"))
