"""The configuration keys the sampling and training paths read.

Own copy of the matching keys of ``ldmseg_tpu/utils/config.py:DEFAULT_CONFIG``
(the reference's ``tools/configs/base/base.yaml``), with the same names and
defaults, plus :func:`merge_dicts`. Keys that only evaluation, data loading
or the later slices read are not copied. ``sampling_kwargs.
int8_auto_calibrate`` is not a key there either: both trainers read it with
the default True.
"""

from __future__ import annotations

import copy

DEFAULT_CONFIG: dict = {
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
        "train_num_steps": 24000,
        "batch_size": 8,
        "accumulate": 1,
        "loss": "l2",
        "ohem_ratio": 1.0,
        "weight_dtype": "float32",
        "clip_grad": 3.0,
        "freeze_layers": ["time_embedding"],
        "gradient_checkpointing": False,
        "fused_attention": True,
        "video_clips": None,
        "temporal_consistency_weight": 0.0,
    },
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
    "lr_scheduler_name": "warmup",
    "lr_scheduler_kwargs": {"final_lr": 0.000001, "warmup_iters": 200},
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
