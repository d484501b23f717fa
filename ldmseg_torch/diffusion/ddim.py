"""The DDIM noise schedule (counterpart of ``ldmseg_tpu/diffusion/ddim.py``).

The tables are built in numpy exactly as the JAX package builds them
(``alphas_cumprod`` a float64 cumprod cast to float32) and held as fp32
tensors on the caller's device. :func:`ddim_step` runs one step at a Python
timestep on 0-d fp32 tensors, the JAX step's fp32 arithmetic; the sampler
runs :func:`table_step` on a row of :func:`step_table`, whose coefficients
are worked out once per ``(steps, tmin)`` in float64 on the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999
                         ) -> np.ndarray:
    """Glide cosine schedule."""

    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array([min(1 - alpha_bar((i + 1) / num_steps)
                         / alpha_bar(i / num_steps), max_beta)
                     for i in range(num_steps)], dtype=np.float32)


def make_betas(beta_schedule: str, num_train_timesteps: int,
               beta_start: float, beta_end: float) -> np.ndarray:
    """Beta table for the four supported schedules."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps,
                           dtype=np.float32)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5,
                           num_train_timesteps, dtype=np.float32) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        return _betas_for_alpha_bar(num_train_timesteps)
    if beta_schedule == "sigmoid":
        x = np.linspace(-6, 6, num_train_timesteps, dtype=np.float32)
        return (1.0 / (1.0 + np.exp(-x))) * (beta_end - beta_start) \
            + beta_start
    raise NotImplementedError(f"beta_schedule {beta_schedule!r}")


LOSS_WEIGHT_MODES = ("inverse_log_snr", "max_clamp_snr", "linear", "fixed",
                     "none")


def compute_loss_weights(alphas_cumprod: np.ndarray,
                         mode: str = "max_clamp_snr",
                         max_snr: float = 5.0) -> np.ndarray:
    """Per-timestep loss weights from the SNR alpha / (1 - alpha), in numpy
    float64 and returned as float32, as the JAX package computes them."""
    if mode not in LOSS_WEIGHT_MODES:
        raise ValueError(f"loss weight mode {mode!r}: expected one of "
                         f"{LOSS_WEIGHT_MODES}")
    snr = alphas_cumprod / (1.0 - alphas_cumprod)
    if mode == "inverse_log_snr":
        w = np.clip(np.log(1.0 / snr), 1.0, None)
        w = w / w[-1]
    elif mode == "max_clamp_snr":
        w = np.clip(snr, None, max_snr) / snr
    elif mode == "fixed":
        w = snr.copy()
        w[: len(w) // 4] = 0.1
    elif mode == "linear":
        w = np.arange(1, len(snr) + 1, dtype=np.float64) / len(snr)
    else:
        w = np.ones_like(snr)
    return w.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    final_alpha_cumprod: torch.Tensor
    weights: torch.Tensor
    num_train_timesteps: int
    prediction_type: str
    clip_sample: bool
    clip_sample_range: float
    init_noise_sigma: float = 1.0
    # step_table's cache, by (num_inference_steps, tmin)
    tables: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)


def make_ddim_schedule(num_train_timesteps: int = 1000,
                       beta_start: float = 0.0001, beta_end: float = 0.02,
                       beta_schedule: str = "linear",
                       clip_sample: bool = True,
                       set_alpha_to_one: bool = True,
                       prediction_type: str = "epsilon",
                       clip_sample_range: float = 1.0,
                       weight: str = "none", max_snr: float = 5.0,
                       device="cuda", **_unused) -> DDIMSchedule:
    """Build the schedule; the defaults are the reference constructor's, the
    LDM config passes scaled_linear 8.5e-4 -> 0.012, clip_sample=False and
    set_alpha_to_one=False. ``weight`` and ``max_snr`` choose the training
    loss's per-timestep weights (:func:`compute_loss_weights`)."""
    betas = make_betas(beta_schedule, num_train_timesteps, beta_start,
                       beta_end)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    final = np.float32(1.0) if set_alpha_to_one else alphas_cumprod[0]
    weights = compute_loss_weights(alphas_cumprod, mode=weight,
                                   max_snr=max_snr)

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=device)

    return DDIMSchedule(
        betas=t(betas), alphas_cumprod=t(alphas_cumprod),
        final_alpha_cumprod=t(final), weights=t(weights),
        num_train_timesteps=num_train_timesteps,
        prediction_type=prediction_type, clip_sample=clip_sample,
        clip_sample_range=clip_sample_range)


def inference_timesteps(num_train_timesteps: int, num_inference_steps: int,
                        tmin: int = 0) -> np.ndarray:
    """Descending inference timesteps with the fork's offset
    ``step_ratio - 1``, so that t = T-1 is always sampled (999, 979, ...,
    19 for 1000/50); those below ``tmin`` dropped."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1]
    ts = ts.astype(np.int64) + step_ratio - 1
    return ts[ts >= tmin]


def _extract(table: torch.Tensor, t: torch.Tensor, ndim: int
             ) -> torch.Tensor:
    return table[t].reshape((-1,) + (1,) * (ndim - 1))


def add_noise(sched: DDIMSchedule, original_samples: torch.Tensor,
              noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0)."""
    ac = _extract(sched.alphas_cumprod.to(original_samples.dtype), timesteps,
                  original_samples.ndim)
    return ac**0.5 * original_samples + (1.0 - ac) ** 0.5 * noise


def remove_noise(sched: DDIMSchedule, noisy_samples: torch.Tensor,
                 noise: torch.Tensor, timesteps: torch.Tensor
                 ) -> torch.Tensor:
    """Invert :func:`add_noise` given the (predicted) noise."""
    ac = _extract(sched.alphas_cumprod.to(noisy_samples.dtype), timesteps,
                  noisy_samples.ndim)
    return (noisy_samples - (1.0 - ac) ** 0.5 * noise) / ac**0.5


def ddim_step(sched: DDIMSchedule, model_output: torch.Tensor,
              timestep: int, sample: torch.Tensor, num_inference_steps: int):
    """One deterministic (eta=0) DDIM update at the integer ``timestep``.
    Returns ``(prev_sample, pred_original_sample)``."""
    prev_t = timestep - sched.num_train_timesteps // num_inference_steps
    alpha_prod_t = sched.alphas_cumprod[timestep]
    alpha_prod_t_prev = (sched.alphas_cumprod[prev_t] if prev_t >= 0
                         else sched.final_alpha_cumprod)
    beta_prod_t = 1.0 - alpha_prod_t

    if sched.prediction_type == "epsilon":
        pred_x0 = (sample - beta_prod_t**0.5 * model_output) \
            / alpha_prod_t**0.5
        pred_eps = model_output
    elif sched.prediction_type == "sample":
        pred_x0 = model_output
        pred_eps = (sample - alpha_prod_t**0.5 * pred_x0) / beta_prod_t**0.5
    elif sched.prediction_type == "v_prediction":
        pred_x0 = alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
        pred_eps = alpha_prod_t**0.5 * model_output \
            + beta_prod_t**0.5 * sample
    else:
        raise NotImplementedError(sched.prediction_type)

    if sched.clip_sample:
        pred_x0 = pred_x0.clamp(-sched.clip_sample_range,
                                sched.clip_sample_range)

    direction = (1.0 - alpha_prod_t_prev) ** 0.5 * pred_eps
    prev_sample = alpha_prod_t_prev**0.5 * pred_x0 + direction
    return prev_sample, pred_x0


# the columns of a StepTable's ``coef`` row
SQRT_A, SQRT_1MA, INV_SQRT_A, INV_SQRT_1MA, SQRT_A_PREV, SQRT_1MA_PREV = \
    range(6)


@dataclasses.dataclass(frozen=True)
class StepTable:
    """The DDIM sampler's per-step table on the schedule's device.

    ``timesteps`` ``[S]`` int64 and ``coef`` ``[S, 6]`` fp32, row i for
    step i: √ᾱ_t, √(1-ᾱ_t), 1/√ᾱ_t, 1/√(1-ᾱ_t), √ᾱ_prev and √(1-ᾱ_prev),
    each worked out in float64 from the fp32 ᾱ and rounded once to fp32.
    :func:`table_step` only multiplies by them: the step's two divisions
    are multiplications by the stored reciprocals (on the card a division
    by a host scalar would multiply by its fp32 reciprocal and a division
    by a device tensor would not, so a stored divisor would make the two
    paths differ). ``host_timesteps`` is the numpy copy of ``timesteps``.
    """
    timesteps: torch.Tensor
    coef: torch.Tensor
    host_timesteps: np.ndarray

    def __len__(self) -> int:
        return len(self.host_timesteps)


def step_table(sched: DDIMSchedule, num_inference_steps: int,
               tmin: int = 0) -> StepTable:
    """The :class:`StepTable` of ``(num_inference_steps, tmin)``, built once
    and cached on ``sched``."""
    key = (int(num_inference_steps), int(tmin))
    if key not in sched.tables:
        ts = inference_timesteps(sched.num_train_timesteps,
                                 num_inference_steps, tmin=tmin)
        ac = sched.alphas_cumprod.cpu().numpy().astype(np.float64)
        final = float(sched.final_alpha_cumprod.cpu())
        prev_t = ts - sched.num_train_timesteps // num_inference_steps
        a = ac[ts]
        a_prev = np.where(prev_t >= 0, ac[np.clip(prev_t, 0, None)], final)
        coef = np.stack([np.sqrt(a), np.sqrt(1.0 - a), 1.0 / np.sqrt(a),
                         1.0 / np.sqrt(1.0 - a), np.sqrt(a_prev),
                         np.sqrt(1.0 - a_prev)], axis=1)
        dev = sched.alphas_cumprod.device
        sched.tables[key] = StepTable(
            timesteps=torch.as_tensor(ts.astype(np.int64), device=dev),
            coef=torch.as_tensor(coef.reshape(-1, 6).astype(np.float32),
                                 device=dev),
            host_timesteps=ts)
    return sched.tables[key]


def table_step(sched: DDIMSchedule, row: torch.Tensor,
               model_output: torch.Tensor, sample: torch.Tensor):
    """One deterministic (eta=0) DDIM update with the coefficients ``row``
    (a ``[6]`` row of :attr:`StepTable.coef` on the sample's device): the
    arithmetic of :func:`ddim_step` with its divisions by √ᾱ_t and
    √(1-ᾱ_t) as multiplications by their reciprocals. Reads no host value,
    so a CUDA graph can capture it. Returns ``(prev_sample,
    pred_original_sample)``."""
    c = row.unbind(0)
    if sched.prediction_type == "epsilon":
        pred_x0 = (sample - c[SQRT_1MA] * model_output) * c[INV_SQRT_A]
        pred_eps = model_output
    elif sched.prediction_type == "sample":
        pred_x0 = model_output
        pred_eps = (sample - c[SQRT_A] * pred_x0) * c[INV_SQRT_1MA]
    elif sched.prediction_type == "v_prediction":
        pred_x0 = c[SQRT_A] * sample - c[SQRT_1MA] * model_output
        pred_eps = c[SQRT_A] * model_output + c[SQRT_1MA] * sample
    else:
        raise NotImplementedError(sched.prediction_type)
    if sched.clip_sample:
        pred_x0 = pred_x0.clamp(-sched.clip_sample_range,
                                sched.clip_sample_range)
    prev_sample = c[SQRT_A_PREV] * pred_x0 + c[SQRT_1MA_PREV] * pred_eps
    return prev_sample, pred_x0
