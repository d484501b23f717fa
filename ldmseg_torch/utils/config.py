"""The configuration keys the port reads, :func:`load_config`,
:func:`parse_dot_overrides` and :func:`prepare_config`.

Own copy of the matching keys of ``ldmseg_tpu/utils/config.py`` (the
reference's ``tools/configs/base/base.yaml`` as plain dicts), with the same
names and defaults, plus :func:`merge_dicts`. Keys that no port module
reads are not copied, so that a default never stands for a setting that
does nothing. ``sampling_kwargs.int8_auto_calibrate`` is not a key there
either: both trainers read it with the default True. The CLIs also read
keys that the defaults leave out: ``checkpoint_dir`` (set by
:func:`prepare_config`), ``pretrained_ldm_path`` and ``eval_first``.
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import Optional

DEFAULT_CONFIG: dict = {
    "pretrained_model_path": None,
    "wandb": False,
    "eval_only": False,
    "image_scaling_factor": 0.18215,
    "vae_model_kwargs": {
        "in_channels": 16,
        "int_channels": 256,
        "out_channels": 128,
        "block_out_channels": [32, 64, 128, 256],
        "latent_channels": 4,
        "num_latents": 2,
        "num_upscalers": 2,
        "upscale_channels": 256,
        "norm_num_groups": 32,
        "scaling_factor": 0.2,
        "parametrization": "gaussian",
        "act_fn": "none",
        "clamp_output": False,
        "freeze_codebook": False,
        "num_mid_blocks": 0,
        "fuse_rgb": False,
        "resize_input": False,
        "skip_encoder": False,
        "pretrained_path": None,
    },
    "model_kwargs": {
        "in_channels": 8,
        "init_mode_seg": "copy",
        "init_mode_image": "zero",
        "cond_channels": 0,
        "separate_conv": False,
        "separate_encoder": False,
        "add_adaptor": False,
        "init_mode_adaptor": "random",
    },
    "noise_scheduler_kwargs": {
        "prediction_type": "epsilon",
        "beta_schedule": "scaled_linear",
        "num_train_timesteps": 1000,
        "beta_start": 0.00085,
        "beta_end": 0.012,
        "steps_offset": 1,
        "clip_sample": False,
        "set_alpha_to_one": False,
        "thresholding": False,
        "dynamic_thresholding_ratio": 0.995,
        "clip_sample_range": 1.0,
        "sample_max_value": 1.0,
        "weight": "none",
        "max_snr": 5.0,
    },
    "train_kwargs": {
        "dropout": 0.0,
        "type_mask": "ignore",
        "image_descriptors": "remove",
        "prob_train_on_pred": 0.0,
        "prob_inpainting": 0.0,
        "min_noise_level": 0,
        "rgb_noise_level": 0,
        "cond_noise_level": 0,
        "self_condition": False,
        "sample_posterior": False,
        "sample_posterior_rgb": False,
        "latent_mask": False,
        "train_num_steps": 24000,
        "batch_size": 8,
        "accumulate": 1,
        "loss": "l2",
        "ohem_ratio": 1.0,
        "weight_dtype": "float32",
        "clip_grad": 3.0,
        "freeze_layers": ["time_embedding"],
        "gradient_checkpointing": False,
        "remat_policy": None,
        "fused_attention": True,
        "video_clips": None,
        "temporal_consistency_weight": 0.0,
    },
    "pose_model_kwargs": {"pretrained_path": None, "nb_ref_imgs": None},
    "loss_kwargs": {
        "num_points": 12544,
        "oversample_ratio": 3,
        "importance_sample_ratio": 0.75,
        "temperature": 1.0,
        "max_masks": 128,
    },
    "loss_weights": {"ce": 1.0, "mask": 1.0, "kl": 0.0},
    "sampling_kwargs": {
        "num_inference_steps": 50,
        "sampler": "ddim",
        "guidance_scale": 7.5,
        "seed": 0,
        "int8_inference": False,
        "int8_act_scale": 0.05,
        "int8_attn_act_scale": 0.1,
        "fused_norms": True,
        "fused_ff": True,
    },
    "eval_kwargs": {
        "mask_th": 0.5,
        "count_th": 512,
        "overlap_th": 0.5,
        "batch_size": 16,
        "eval_every": None,
    },
    "optimizer_name": "adamw",
    "optimizer_kwargs": {
        "lr": 1.0e-4,
        "betas": [0.9, 0.999],
        "weight_decay": 0.0,
        "weight_decay_norm": 0.0,
    },
    "optimizer_zero_redundancy": False,
    "tensor_parallel": False,
    "spatial_parallel": False,
    "ema_on": False,
    "ema_kwargs": {"decay": 0.9999},
    "lr_scheduler_name": "warmup",
    "lr_scheduler_kwargs": {"final_lr": 0.000001, "warmup_iters": 200},
    "transformation_kwargs": {
        "size": 192,
        "size_2": 640,
        "flip": True,
        "normalize": True,
        "normalize_params": {"mean": [0.485, 0.456, 0.406],
                             "std": [0.229, 0.224, 0.225]},
    },
    "train_db_name": "kitti",
    "val_db_name": "kitti",
    "num_classes": 128,
    "num_bits": 16,
    "ignore_label": 127,
}


def merge_dicts(base: dict, override: dict) -> dict:
    """Recursive dict union, override wins."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: Optional[str] = None,
                overrides: Optional[dict] = None) -> dict:
    """Compose DEFAULT_CONFIG (+ optional YAML file) (+ overrides)."""
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    if path is not None:
        import yaml
        with open(path) as f:
            cfg = merge_dicts(cfg, yaml.safe_load(f) or {})
    if overrides:
        cfg = merge_dicts(cfg, overrides)
    return cfg


def parse_dot_overrides(args: list[str]) -> dict:
    """CLI ``a.b.c=value`` overrides (the reference scripts' hydra style);
    values through ``ast.literal_eval``, else strings."""
    import ast
    out: dict = {}
    for arg in args:
        if "=" not in arg:
            continue
        key, val = arg.split("=", 1)
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def prepare_config(cfg: dict, output_dir: str, run_idx: int = -1) -> dict:
    """Create the run directory tree ``<output_dir>/run_<idx>`` with
    ``checkpoints/`` and ``logs/`` (``run_idx=-1``: a timestamped name) and
    write the composed config to its ``config.json``, from which
    ``tools/export_checkpoint.py`` rebuilds the trainer; returns cfg with
    ``output_dir``, ``checkpoint_dir`` and ``log_dir`` set. Under
    ``torch.distributed`` every rank takes the main process's stamp and
    only the main process writes the file."""
    from ..parallel.multihost import broadcast_host, is_main_process
    cfg = copy.deepcopy(cfg)
    if run_idx == -1:
        stamp = broadcast_host(
            datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))
        run_name = f"run_{stamp}"
    else:
        run_name = f"run_{run_idx}"
    root = os.path.join(output_dir, run_name)
    cfg["output_dir"] = root
    cfg["checkpoint_dir"] = os.path.join(root, "checkpoints")
    cfg["log_dir"] = os.path.join(root, "logs")
    for d in (root, cfg["checkpoint_dir"], cfg["log_dir"]):
        os.makedirs(d, exist_ok=True)
    if is_main_process():
        import json
        with open(os.path.join(root, "config.json"), "w") as f:
            json.dump(cfg, f, indent=1, default=str)
    return cfg
