"""The DDIM sampling loop (counterpart of
``ldmseg_tpu/diffusion/sampler.py:ddim_sample``, one ``lax.scan`` there).

Per step the model predicts, DDIM steps on the step's row of
:func:`~.ddim.step_table`, and with self-conditioning the predicted x0
becomes the next step's condition. Like the reference it returns the last
step's predicted x0, not the last ``prev_sample``.

On a CUDA tensor the steps replay a CUDA graph, the counterpart of the
scan's compile-once loop: the first step runs eagerly (the kernels build,
their caches fill), the next is captured on a side stream (the model, the
DDIM update and the self-condition copy, on static buffers for the
latents, the condition, x0 and the step index, which the graph advances),
and the graph is replayed for the rest. It is captured afresh on every
call, so it never reads a weight or a pack that a later ``prepare``,
calibration or training step replaced. The kernels' launch counters count
the replays (:class:`~..ops.counters.CountReplay`). A capture that fails
raises; it never falls back to the eager loop. ``graph=False`` asks for the
eager loop, which the CPU always runs. :func:`run_steps` is that loop for
any step on static buffers; ``diffusion/dpm.py`` runs DPM-Solver++(2M) on
it, and :func:`ddim_refine` the low-noise tail of the DDIM table.
:func:`cfg_model_fn` wraps a model in classifier-free guidance for any of
them.
"""

from __future__ import annotations

import functools
import traceback
from typing import Callable, List, Optional

import torch

from .ddim import DDIMSchedule, StepTable, add_noise, step_table, table_step

ModelFn = Callable[[torch.Tensor, Optional[torch.Tensor], torch.Tensor],
                   torch.Tensor]


def ddim_sample(sched: DDIMSchedule, model_fn: ModelFn,
                init_latents: torch.Tensor, num_inference_steps: int = 50,
                self_condition: bool = False, tmin: int = 0,
                return_all: bool = False, graph: Optional[bool] = None):
    """Run the deterministic DDIM sampler.

    ``model_fn(latents, condition_or_None, t)`` predicts the noise (or
    sample), ``t`` a 0-d int64 tensor on the latents' device; the caller
    closes over the RGB latents. ``init_latents`` is standard-normal noise.
    Timesteps below ``tmin`` are dropped. ``graph`` (default: whether the
    latents are on a CUDA device) replays the step as a CUDA graph. Returns
    the predicted x0 of the last step and, with ``return_all``, the stacked
    trajectory of each step's latents ``[S, ...]``.
    """
    cuda = init_latents.device.type == "cuda"
    if graph is None:
        graph = cuda
    if graph and not cuda:
        raise ValueError("ddim_sample(graph=True) needs CUDA latents; "
                         f"got {init_latents.device}")
    table = step_table(sched, num_inference_steps, tmin)
    latents = init_latents * sched.init_noise_sigma
    condition = torch.zeros_like(init_latents) if self_condition else None
    x0 = torch.zeros_like(init_latents)
    if len(table) == 0:
        return (x0, init_latents.new_zeros((0,) + init_latents.shape)) \
            if return_all else x0
    idx = torch.zeros(1, dtype=torch.long, device=latents.device)
    step = functools.partial(_step, sched, table, model_fn, latents,
                             condition, x0, idx)
    traj = run_steps(step, len(table), latents, graph, return_all,
                     "ddim_sample", "the DDIM step")
    if return_all:
        return x0, torch.stack(traj)
    return x0


def ddim_refine(sched: DDIMSchedule, model_fn: ModelFn, x0: torch.Tensor,
                noise: torch.Tensor, num_inference_steps: int = 50,
                strength: float = 0.3, self_condition: bool = False,
                tmin: int = 0, graph: Optional[bool] = None) -> torch.Tensor:
    """Partial (SDEdit-style) DDIM (JAX ``sampler.py:ddim_refine``):
    re-noise the x0 estimate ``x0`` with ``noise`` to the timestep
    ``strength`` of the way up the inference schedule, then run only the
    last k = max(1, min(S, round(strength * S))) steps of the S-step table
    that :func:`ddim_sample` runs (the same rows of
    :func:`~.ddim.step_table`), the self-condition starting at zeros.
    ``add_noise`` at the first of those timesteps takes no
    ``init_noise_sigma`` factor. Returns the last step's predicted x0, in
    fresh buffers (``x0`` is not written). ``graph`` as in
    :func:`ddim_sample`: on a CUDA tensor the steps replay a graph
    captured afresh for this call."""
    cuda = x0.device.type == "cuda"
    if graph is None:
        graph = cuda
    if graph and not cuda:
        raise ValueError("ddim_refine(graph=True) needs CUDA latents; "
                         f"got {x0.device}")
    table = step_table(sched, num_inference_steps, tmin)
    n = len(table)
    if n == 0:
        raise ValueError(f"ddim_refine: no timestep left above tmin={tmin}")
    k = max(1, min(n, int(round(strength * n))))
    t_start = torch.full((x0.shape[0],), int(table.host_timesteps[-k]),
                         dtype=torch.long, device=x0.device)
    latents = add_noise(sched, x0, noise, t_start)
    condition = torch.zeros_like(latents) if self_condition else None
    out = torch.zeros_like(latents)
    # the step index starts at the tail's first row of the full table
    idx = torch.full((1,), n - k, dtype=torch.long, device=latents.device)
    step = functools.partial(_step, sched, table, model_fn, latents,
                             condition, out, idx)
    run_steps(step, k, latents, graph, False, "ddim_refine",
              "the DDIM refine step")
    return out


def cfg_model_fn(raw_model_fn: ModelFn, uncond_model_fn: ModelFn,
                 guidance_scale: float) -> ModelFn:
    """Classifier-free guidance (JAX ``sampler.py:cfg_model_fn``; reference
    :1147-1149): ``uncond + scale * (cond - uncond)``, two calls of the
    model rather than a doubled batch, as in JAX. Scale 1 is the
    conditional model itself: the unconditional branch never runs. A
    sampler captures both calls in its graph; the contexts they close over
    must live as long as the call."""
    if guidance_scale == 1.0:
        return raw_model_fn

    def fn(latents, condition, t):
        cond = raw_model_fn(latents, condition, t)
        uncond = uncond_model_fn(latents, condition, t)
        return uncond + guidance_scale * (cond - uncond)
    return fn


def _step(sched, table: StepTable, model_fn, latents, condition, x0, idx):
    """One step on the static buffers; ``idx`` is the ``[1]`` int64 step
    index on the device, which the step advances. The eager loop and the
    graph run this same step."""
    row = table.coef.index_select(0, idx)[0]
    t = table.timesteps.index_select(0, idx)[0]
    pred = model_fn(latents, condition, t)
    prev, new_x0 = table_step(sched, row, pred, latents)
    latents.copy_(prev)
    x0.copy_(new_x0)
    if condition is not None:
        condition.copy_(new_x0)
    idx.add_(1)


def run_steps(step: Callable[[], None], n: int, latents: torch.Tensor,
              graph: bool, return_all: bool = False, name: str = "sampler",
              what: str = "the step") -> List[torch.Tensor]:
    """Run ``step()`` ``n`` times: eagerly, or (``graph``) the first
    eagerly and the rest as replays of a CUDA graph captured on a side
    stream from the second. ``step`` works on static buffers only and
    advances its own device-side step index. Returns each step's
    ``latents`` (cloned) with ``return_all``, else ``[]``."""
    if not graph:
        traj = []
        for _ in range(n):
            step()
            if return_all:
                traj.append(latents.clone())
        return traj
    from ..ops.counters import CountReplay

    dev = latents.device
    counts = CountReplay()
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        step()
        if n > 1:
            # capture_begin/end rather than torch.cuda.graph, whose entry
            # also synchronises, collects garbage and empties the cache
            g = torch.cuda.CUDAGraph()
            counts.start()
            try:
                g.capture_begin(capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    g.capture_end()
            except Exception as e:
                raise RuntimeError(
                    f"{name}: capturing {what} as a CUDA graph failed at "
                    f"{_where(e)}: {e}") from e
            finally:
                counts.stop()
    main.wait_stream(side)
    # the capture ran nothing: the buffers still hold the first step's
    traj = [latents.clone()] if return_all else []
    for _ in range(1, n):
        g.replay()
        counts.replay()
        if return_all:
            traj.append(latents.clone())
    return traj


def _where(e: BaseException) -> str:
    """The innermost frame in the port's modules of ``e`` or of the error
    that ``e`` followed (ending a failed capture raises again): the op whose
    call broke the capture."""
    while e is not None:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "ldmseg_torch" in f.filename]
        if frames and not frames[-1].filename.endswith(("sampler.py",
                                                         "dpm.py")):
            f = frames[-1]
            return f"{f.filename}:{f.lineno} ({f.name}: {f.line})"
        e = e.__context__
    return "the capture's end"
