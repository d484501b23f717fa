"""DPM-Solver++(2M), the second-order multistep sampler (counterpart of
``ldmseg_tpu/diffusion/dpm.py``, one ``lax.scan`` there).

With α_t = √ᾱ_t, σ_t = √(1-ᾱ_t), λ_t = log(α_t/σ_t) and h_i = λ_{t_{i+1}} -
λ_{t_i}, each step updates

    D_i = (1 + w_i)·x0_i - w_i·x0_{i-1},   w_i = h_i / (2 h_{i-1})
    x_{i+1} = (σ_{t_{i+1}}/σ_{t_i})·x_i + α_{t_{i+1}}(1 - e^{-h_i})·D_i

on the timesteps of :func:`~.ddim.inference_timesteps`, first order (w = 0)
on the first step, the last, and any step whose e^{-h} leaves (0, 1). The
coefficients are worked out in fp32 in the JAX function's order, with its
clamp of e^{-h} at 1e-20 before the log, into one table on the schedule's
device (:func:`dpm_table`). The steps run as :func:`~.sampler.run_steps`
runs DDIM's: on a CUDA tensor the first eagerly and the rest as replays of
a CUDA graph captured afresh on every call, the launch counters replayed;
``graph=False`` (and the CPU) the eager loop. Like the JAX function it
returns the last step's predicted x0.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .ddim import DDIMSchedule, inference_timesteps
from .sampler import ModelFn, run_steps

# the columns of a DPMTable's ``coef`` row
ALPHA, SIGMA, C_X, C_D, W = range(5)


@dataclasses.dataclass(frozen=True)
class DPMTable:
    """``timesteps`` ``[S]`` int64 and ``coef`` ``[S, 5]`` fp32 on the
    schedule's device, row i: α_t = √ᾱ_t, σ_t = √(1-ᾱ_t), c_x = σ_prev /
    σ_t, c_d = α_prev (1 - e^{-h}) and w (0 where the step is first
    order); ``host_timesteps`` their numpy copy."""
    timesteps: torch.Tensor
    coef: torch.Tensor
    host_timesteps: np.ndarray

    def __len__(self) -> int:
        return len(self.host_timesteps)


def dpm_table(sched: DDIMSchedule, num_inference_steps: int,
              tmin: int = 0) -> DPMTable:
    """The :class:`DPMTable` of ``(num_inference_steps, tmin)``, built once
    and cached on ``sched``: each operation in fp32 on the CPU as
    ``dpmpp_2m_sample`` (:75-102) computes it, then moved to the
    schedule's device."""
    key = ("dpmpp_2m", int(num_inference_steps), int(tmin))
    if key in sched.tables:
        return sched.tables[key]
    ts = inference_timesteps(sched.num_train_timesteps, num_inference_steps,
                             tmin=tmin)
    n = len(ts)
    step_ratio = sched.num_train_timesteps // num_inference_steps
    ac = sched.alphas_cumprod.detach().float().cpu()
    final = sched.final_alpha_cumprod.detach().float().cpu()
    idx = torch.as_tensor(ts, dtype=torch.long)
    prev_t = idx - step_ratio
    ac_t = ac[idx]
    ac_p = torch.where(prev_t >= 0, ac[prev_t.clamp_min(0)], final)
    a_t, s_t = torch.sqrt(ac_t), torch.sqrt(1.0 - ac_t)
    a_p, s_p = torch.sqrt(ac_p), torch.sqrt(1.0 - ac_p)
    emh = (a_t * s_p) / (s_t * a_p)
    c_x = s_p / s_t
    c_d = a_p * (1.0 - emh)
    h = -torch.log(torch.clamp_min(emh, 1e-20))
    h_prev = torch.cat([h[:1], h[:-1]])
    w = h / (2.0 * h_prev)
    step = torch.arange(n)
    first_order = ((step == 0) | (step == n - 1) | (emh <= 0.0)
                   | (emh >= 1.0))
    w = torch.where(first_order, torch.zeros_like(w), w)
    coef = torch.stack([a_t, s_t, c_x, c_d, w], dim=1).reshape(-1, 5)
    dev = sched.alphas_cumprod.device
    sched.tables[key] = DPMTable(
        timesteps=torch.as_tensor(ts.astype(np.int64), device=dev),
        coef=coef.to(dev), host_timesteps=ts)
    return sched.tables[key]


def to_x0(sched: DDIMSchedule, model_output: torch.Tensor,
          sample: torch.Tensor, alpha: torch.Tensor,
          sigma: torch.Tensor) -> torch.Tensor:
    """The model output as an x0 prediction (``_to_x0``, :35-50), with α =
    √ᾱ_t and σ = √(1-ᾱ_t) from the table; clipped under ``clip_sample``."""
    if sched.prediction_type == "epsilon":
        x0 = (sample - sigma * model_output) / alpha
    elif sched.prediction_type == "sample":
        x0 = model_output
    elif sched.prediction_type == "v_prediction":
        x0 = alpha * sample - sigma * model_output
    else:
        raise NotImplementedError(sched.prediction_type)
    if sched.clip_sample:
        x0 = x0.clamp(-sched.clip_sample_range, sched.clip_sample_range)
    return x0


def _step(sched, table: DPMTable, model_fn, x, x0, condition, idx):
    """One step on the static buffers: ``x`` the latents, ``x0`` the last
    step's prediction (the history), ``idx`` the ``[1]`` int64 step index
    on the device, which the step advances."""
    row = table.coef.index_select(0, idx)[0]
    t = table.timesteps.index_select(0, idx)[0]
    pred = model_fn(x, condition, t)
    c = row.unbind(0)
    new_x0 = to_x0(sched, pred, x, c[ALPHA], c[SIGMA])
    d = (1.0 + c[W]) * new_x0 - c[W] * x0
    x.copy_(c[C_X] * x + c[C_D] * d)
    x0.copy_(new_x0)
    if condition is not None:
        condition.copy_(new_x0)
    idx.add_(1)


def dpmpp_2m_sample(sched: DDIMSchedule, model_fn: ModelFn,
                    init_latents: torch.Tensor,
                    num_inference_steps: int = 20,
                    self_condition: bool = False, tmin: int = 0,
                    graph: Optional[bool] = None) -> torch.Tensor:
    """Deterministic DPM-Solver++(2M) sampling with
    :func:`~.sampler.ddim_sample`'s contract: ``model_fn(latents,
    condition_or_None, t)``, ``init_latents`` standard-normal noise, the
    predicted x0 of each step the next one's condition under
    ``self_condition``, timesteps below ``tmin`` dropped, ``graph``
    (default: whether the latents are on a CUDA device) for the CUDA-graph
    replay. Returns the last step's predicted x0."""
    cuda = init_latents.device.type == "cuda"
    if graph is None:
        graph = cuda
    if graph and not cuda:
        raise ValueError("dpmpp_2m_sample(graph=True) needs CUDA latents; "
                         f"got {init_latents.device}")
    table = dpm_table(sched, num_inference_steps, tmin)
    x = init_latents * sched.init_noise_sigma
    x0 = torch.zeros_like(init_latents)
    condition = torch.zeros_like(init_latents) if self_condition else None
    if len(table) == 0:
        return x0
    idx = torch.zeros(1, dtype=torch.long, device=init_latents.device)
    step = functools.partial(_step, sched, table, model_fn, x, x0,
                             condition, idx)
    run_steps(step, len(table), x, graph, name="dpmpp_2m_sample",
              what="the DPM-Solver++(2M) step")
    return x0
