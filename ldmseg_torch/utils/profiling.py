"""Profiling and tracing hooks (counterpart of
``ldmseg_tpu/utils/profiling.py``).

:func:`trace` captures a ``torch.profiler`` trace of a code region (the
host's operators, and the card's kernels where there is a card) and writes
it as a Chrome trace; :class:`StepTimer` times steps on the host clock,
each ending in ``torch.cuda.synchronize()`` of the device that holds the
step's result (JAX's ``block_until_ready``). JAX's ``start_server`` (the
on-demand profiler server TensorBoard connects to) has no PyTorch
counterpart and is not ported.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[str]:
    """Profile the ``with`` block (CPU and, where there is a card, CUDA
    activities) and write ``trace.json``, a Chrome trace, into ``logdir``
    (made if missing; default a fresh temporary directory). Yields
    ``logdir``."""
    logdir = logdir or tempfile.mkdtemp(prefix="ldmseg_trace_")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _cuda_devices(result, found: set) -> set:
    """The CUDA devices of the tensors in a (nested) step result."""
    if isinstance(result, torch.Tensor):
        if result.device.type == "cuda":
            found.add(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _cuda_devices(v, found)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Wall-clock per-step timing with an explicit device sync."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        """The step's seconds since :meth:`start`, after every card that
        holds a tensor of ``result`` has finished its work."""
        for device in _cuda_devices(result, set()):
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> dict:
        """Mean, median and 90th percentile over the steps after the first
        (the warm-up: kernel builds, allocator growth), and the count."""
        import numpy as np
        arr = np.asarray(self.times[1:] or self.times)
        return {"mean_s": float(arr.mean()), "p50_s": float(
            np.percentile(arr, 50)), "p90_s": float(np.percentile(arr, 90)),
            "steps": len(self.times)}
