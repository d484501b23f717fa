"""Stage-2 LDM training from the command line (counterpart of
``ldmseg_tpu/tools/main_ldm.py``).

    python -m ldmseg_torch.tools.main_ldm [datasets=synthetic]
        [output_dir=runs] [run_idx=0] [config=path.yaml] [data_prefix=...]
        [device=cpu] [save_every=2000] [key.sub=value ...]

Composes the config (defaults, a YAML file, the dataset preset, the dot
overrides), makes the run directory (``<output_dir>/run_<idx>`` with its
``config.json``), builds the trainer on the card (``device=cpu`` for the
plain PyTorch path) with the conditioning of
``train_kwargs.image_descriptors`` (``remove``, ``none``, ``learnable``;
``clip``/``text`` with a local ``descriptor_pretrained_path``), with
``train_kwargs.video_clips=T`` on T-frame clips
of the train split (:class:`~..data.video.ClipDataset`), adopts a pose net
of ``main_pose`` from ``pose_model_kwargs.pretrained_path`` (the
temporal-consistency term with ``train_kwargs.temporal_consistency_weight``),
adopts the weights (:func:`load_weights`), resumes from the newest
``step_*`` checkpoint of the run, evaluates once (unless
``eval_first=False``; ``eval_only=True`` stops there), trains to
``train_kwargs.train_num_steps`` with a checkpoint every ``save_every``
optimizer steps, saves, and scores PQ on 4 val batches with the best-PQ
snapshot. Without weights the models start from seeded random ones.

On N GPUs: ``torchrun --nproc_per_node=N -m ldmseg_torch.tools.main_ldm
...`` (or one SLURM task a GPU): each rank trains its ``batch_size / N``
rows of the global ``train_kwargs.batch_size`` (``parallel/``).
"""

from __future__ import annotations

import sys

from .main_ae import DATASET_PRESETS, build_datasets


def descriptor_from_config(cfg):
    """The conditioning descriptor of ``train_kwargs.image_descriptors``
    (``descriptor_pretrained_path`` for the CLIP towers), resolved once:
    the trainer and :func:`build_unet_config` take the same one."""
    from ..models.descriptors import get_image_descriptors
    return get_image_descriptors(
        cfg["train_kwargs"].get("image_descriptors", "remove"),
        pretrained_path=cfg.get("descriptor_pretrained_path"))


def build_unet_config(cfg, descriptor=None):
    """The UNetConfig of the run config's ``model_kwargs`` size overrides
    (``block_out_channels`` and the keys beside it, the surgery's
    ``separate_conv``, ``separate_encoder``, ``add_adaptor`` and
    ``cross_attention_dim``) with the descriptor's cross-attention, object
    queries and ``encoder_hid_proj`` (:func:`descriptor_from_config` when
    None), or None: the trainer's SD-1.4-sized default, which it builds
    from the same keys. Shared with ``predict`` and ``export_checkpoint``,
    so that they rebuild the run's UNet."""
    from ..models.unet import UNetConfig
    mk, tk = cfg["model_kwargs"], cfg["train_kwargs"]
    if "block_out_channels" not in mk:
        return None
    if descriptor is None:
        descriptor = descriptor_from_config(cfg)
    cond = mk.get("cond_channels", 0)
    if tk.get("self_condition", False) and cond == 0:
        cond = 4
    kw = {}
    if "attn_down" in mk:
        kw["attn_down"] = tuple(mk["attn_down"])
    return UNetConfig(
        in_channels=mk.get("in_channels", 8) + cond, out_channels=4,
        block_out_channels=tuple(mk["block_out_channels"]),
        layers_per_block=mk.get("layers_per_block", 2),
        attention_head_dim=mk.get("attention_head_dim", 8),
        norm_num_groups=mk.get("norm_num_groups", 32),
        cross_attention_dim=mk.get("cross_attention_dim", 768),
        use_cross_attention=descriptor.use_cross_attention,
        num_object_queries=descriptor.num_object_queries,
        encoder_hid_dim=descriptor.encoder_hid_dim,
        separate_conv=mk.get("separate_conv", False),
        separate_encoder=mk.get("separate_encoder", False),
        add_adaptor=mk.get("add_adaptor", False),
        use_fused_attention=tk.get("fused_attention", True), **kw)


def load_weights(trainer, cfg: dict, seed: int = 0) -> None:
    """Fill the trainer's three models as the JAX ``main_ldm`` does: the
    UNet and the image VAE from a local diffusers SD-1.4 directory
    (``pretrained_model_path``; ``conv_in`` widened by
    ``model_kwargs.init_mode_*``), the seg VAE from a reference stage-1
    ``{'vae': ...}`` file (``vae_model_kwargs.pretrained_path``; JAX reads
    its own orbax checkpoint there), or all three from a reference
    stage-2 save dict (``pretrained_ldm_path``, its EMA preferred); the
    rest seeded random weights."""
    from ..models import torch_import as ti
    unet = vae_img = vae_seg = None
    vk, mk = cfg["vae_model_kwargs"], cfg["model_kwargs"]
    pretrained = cfg.get("pretrained_model_path")
    if pretrained:
        unet = ti.expand_conv_in(
            ti.load_diffusers_unet(pretrained, trainer.unet_config),
            init_mode_seg=mk.get("init_mode_seg", "copy"),
            init_mode_image=mk.get("init_mode_image", "zero"),
            cond_channels=trainer.unet_config.in_channels - 8,
            init_mode_cond=mk.get("init_mode_cond", "zero"))
        vae_img = ti.load_diffusers_vae(pretrained)
    if vk.get("pretrained_path"):
        vae_seg = ti.load_reference_seg_vae(
            vk["pretrained_path"], tuple(vk["block_out_channels"]),
            vk.get("num_upscalers", 1))
    ref_ldm = cfg.get("pretrained_ldm_path")
    if ref_ldm:
        loaded = ti.load_reference_ldm(
            ref_ldm, trainer.unet_config, tuple(vk["block_out_channels"]),
            vk.get("num_upscalers", 1))
        unet = loaded["ema"] or loaded["unet"]
        vae_img, vae_seg = loaded["vae_image"], loaded["vae_semseg"]
        print(f"Loaded reference LDM checkpoint {ref_ldm} (step "
              f"{loaded['step']}, ema={'yes' if loaded['ema'] else 'no'})",
              flush=True)
    trainer.load_state_dicts(unet, vae_img, vae_seg, seed=seed)


def attach_pose_from_config(trainer, cfg: dict) -> bool:
    """Adopt the pose net of ``pose_model_kwargs.pretrained_path`` (a
    ``main_pose`` checkpoint; ``nb_ref_imgs`` from the file unless the
    config gives it), without its explainability decoder, as JAX's
    ``main_ldm`` and ``predict`` do. Returns whether one was attached."""
    from ..train.trainer_pose import load_pose_checkpoint
    pk = cfg.get("pose_model_kwargs") or {}
    if not pk.get("pretrained_path"):
        return False
    model, sd = load_pose_checkpoint(pk["pretrained_path"],
                                     pk.get("nb_ref_imgs"))
    trainer.attach_pose(model, sd)
    print(f"Attached pose net ({model.nb_ref_imgs} ref frames) from "
          f"{pk['pretrained_path']}", flush=True)
    return True


def main(argv=None):
    """Run the stage-2 pipeline; returns the trainer."""
    from ..train.trainer_ldm import TrainerDiffusion
    from ..utils.config import (load_config, merge_dicts,
                                parse_dot_overrides, prepare_config)

    from ..parallel.multihost import initialize_from_env

    overrides = parse_dot_overrides(sys.argv[1:] if argv is None else argv)
    dataset = overrides.pop("datasets", "synthetic")
    config_path = overrides.pop("config", None)
    prefix = overrides.pop("data_prefix", None)
    output_dir = overrides.pop("output_dir", "runs")
    run_idx = overrides.pop("run_idx", -1)
    device = overrides.pop("device", "cuda")
    # one rank a GPU under torchrun or SLURM; one process without them
    device = initialize_from_env(device=device)["device"]
    save_every = overrides.pop("save_every", 2000)

    cfg = load_config(config_path)
    cfg = merge_dicts(cfg, DATASET_PRESETS.get(dataset, {}))
    cfg = merge_dicts(cfg, overrides)
    cfg = prepare_config(cfg, output_dir, run_idx)
    print(f"Run dir: {cfg['output_dir']}", flush=True)

    train_ds, val_ds = build_datasets(cfg, prefix)
    clip_len = cfg["train_kwargs"].get("video_clips")
    if clip_len:
        from ..data.video import ClipDataset
        train_ds = ClipDataset(train_ds, clip_len=int(clip_len))
        print(f"Clip training: {len(train_ds)} clips of {clip_len}",
              flush=True)
    desc = descriptor_from_config(cfg)
    trainer = TrainerDiffusion(cfg, unet_config=build_unet_config(cfg, desc),
                               device=device, dataset=train_ds,
                               val_dataset=val_ds,
                               results_folder=cfg["checkpoint_dir"],
                               descriptor=desc)
    attach_pose_from_config(trainer, cfg)
    load_weights(trainer, cfg)
    trainer.resume()

    if cfg.get("eval_only"):
        print(trainer.compute_pq(max_batches=8), flush=True)
        return trainer
    if cfg.get("eval_first", True):
        print("step-0 eval:", trainer.compute_metrics(
            max_batches=1, num_inference_steps=5), flush=True)
    remaining = trainer.train_num_steps - trainer.state.step
    if remaining > 0:
        trainer.train_loop(max_steps=remaining, save_every=save_every)
    trainer.save()
    print(trainer.compute_pq(max_batches=4, save_model=True), flush=True)
    return trainer


if __name__ == "__main__":
    main()
