"""The DDIM sampling loop (counterpart of
``ldmseg_tpu/diffusion/sampler.py:ddim_sample``).

A Python loop over the static timestep table: per step the model predicts,
DDIM steps, and with self-conditioning the predicted x0 becomes the next
step's condition. Like the reference it returns the last step's predicted
x0, not the last ``prev_sample``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .ddim import DDIMSchedule, ddim_step, inference_timesteps

ModelFn = Callable[[torch.Tensor, Optional[torch.Tensor], int], torch.Tensor]


def ddim_sample(sched: DDIMSchedule, model_fn: ModelFn,
                init_latents: torch.Tensor, num_inference_steps: int = 50,
                self_condition: bool = False, tmin: int = 0,
                return_all: bool = False):
    """Run the deterministic DDIM sampler.

    ``model_fn(latents, condition_or_None, t)`` predicts the noise (or
    sample); the caller closes over the RGB latents. ``init_latents`` is
    standard-normal noise. Timesteps below ``tmin`` are dropped. Returns
    the predicted x0 of the last step and, with ``return_all``, the
    stacked trajectory of each step's latents ``[S, ...]``.
    """
    latents = init_latents * sched.init_noise_sigma
    condition = torch.zeros_like(init_latents) if self_condition else None
    x0 = torch.zeros_like(init_latents)
    traj = []
    for t in inference_timesteps(sched.num_train_timesteps,
                                 num_inference_steps, tmin=tmin):
        pred = model_fn(latents, condition, int(t))
        latents, x0 = ddim_step(sched, pred, int(t), latents,
                                num_inference_steps)
        if self_condition:
            condition = x0
        if return_all:
            traj.append(latents)
    if return_all:
        return x0, (torch.stack(traj) if traj else
                    init_latents.new_zeros((0,) + init_latents.shape))
    return x0
