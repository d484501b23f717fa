"""Training state: the step count, gradient accumulation and the EMA around
an :class:`~.optim.Optimizer` (counterpart of ``ldmseg_tpu/train/state.py``).

The parameters are fp32 masters whose ``.grad`` autograd fills. With
``accumulate > 1`` the gradients of consecutive micro-batches are summed in
``.grad`` (autograd adds to it) and the optimizer steps every
``accumulate`` micro-batches on their mean, as ``TrainState.apply_gradients``
does. ``step`` counts optimizer steps. ``ema_params`` (fp32 tensors on the
masters' device, one per master) follow ``e <- decay * e + (1 - decay) * p``
after every optimizer step and hold on the micro-steps between, in one
``torch._foreach_lerp_`` pass (``e + (1 - decay) * (p - e)``).

Under data parallelism (``group``, the mesh's data group) the gradients
are averaged over the group's ranks once per optimizer step, after the last
micro-batch and before the optimizer, so that clipping reads the global
gradients as JAX's does (``parallel/mesh.py:reduce_gradients``); every rank
then steps to the same masters and applies the EMA to them. Under tensor
parallelism (``model_group``) the gradients of the ``replicated``
parameters, the same on every model rank, are averaged over the model group
too, so that those masters stay equal whatever the rounding.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..parallel.mesh import reduce_gradients
from .optim import Optimizer


class TrainState:
    def __init__(self, optimizer: Optimizer, accumulate: int = 1,
                 ema_params: Optional[List[torch.Tensor]] = None,
                 ema_decay: float = 0.9999, group=None, model_group=None,
                 replicated: Optional[List[torch.Tensor]] = None):
        if accumulate < 1:
            raise ValueError(f"accumulate must be >= 1, got {accumulate}")
        if ema_params is not None and len(ema_params) != len(
                optimizer.params):
            raise ValueError(f"{len(ema_params)} EMA tensors for "
                             f"{len(optimizer.params)} parameters")
        self.optimizer = optimizer
        self.accumulate = accumulate
        self.ema_params = ema_params
        self.ema_decay = ema_decay
        self.group = group
        self.model_group = model_group
        self.replicated = replicated or []
        self.step = 0
        self.micro_step = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    @torch.no_grad()
    def apply_gradients(self) -> bool:
        """Count one micro-batch whose gradients are in ``.grad``; every
        ``accumulate``-th call averages them over the data group, steps
        the optimizer on the mean, updates the EMA and clears ``.grad``.
        Returns whether it stepped."""
        self.micro_step += 1
        if self.micro_step % self.accumulate:
            return False
        reduce_gradients(self.optimizer.params, self.group)
        reduce_gradients(self.replicated, self.model_group)
        if self.accumulate > 1:
            grads = [p.grad for p in self.optimizer.params
                     if p.grad is not None]
            torch._foreach_div_(grads, float(self.accumulate))
        self.optimizer.step()
        self.optimizer.zero_grad()
        if self.ema_params is not None:
            torch._foreach_lerp_(self.ema_params, self.optimizer.params,
                                 1.0 - self.ema_decay)
        self.step += 1
        return True
