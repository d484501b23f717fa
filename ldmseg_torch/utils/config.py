"""The configuration keys the sampling path reads.

Own copy of the matching keys of ``ldmseg_tpu/utils/config.py:DEFAULT_CONFIG``
(the reference's ``tools/configs/base/base.yaml``), with the same names and
defaults, plus :func:`merge_dicts`. Keys that only training, evaluation or
data loading read are not copied.
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
        "image_descriptors": "remove",
        "self_condition": False,
        "sample_posterior_rgb": False,
        "weight_dtype": "float32",
        "fused_attention": True,
    },
    "sampling_kwargs": {
        "num_inference_steps": 50,
        "sampler": "ddim",
        "guidance_scale": 7.5,
        "seed": 0,
        "int8_inference": False,
    },
    "eval_kwargs": {
        "mask_th": 0.5,
        "count_th": 512,
        "overlap_th": 0.5,
    },
    "ema_on": False,
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
