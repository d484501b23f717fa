"""Training state: the step count and gradient accumulation around an
:class:`~.optim.Optimizer` (counterpart of ``ldmseg_tpu/train/state.py``).

The parameters are fp32 masters whose ``.grad`` autograd fills. With
``accumulate > 1`` the gradients of consecutive micro-batches are summed in
``.grad`` (autograd adds to it) and the optimizer steps every
``accumulate`` micro-batches on their mean, as ``TrainState.apply_gradients``
does. ``step`` counts optimizer steps. EMA weights are a later slice.
"""

from __future__ import annotations

import torch

from .optim import Optimizer


class TrainState:
    def __init__(self, optimizer: Optimizer, accumulate: int = 1):
        if accumulate < 1:
            raise ValueError(f"accumulate must be >= 1, got {accumulate}")
        self.optimizer = optimizer
        self.accumulate = accumulate
        self.step = 0
        self.micro_step = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()

    @torch.no_grad()
    def apply_gradients(self) -> bool:
        """Count one micro-batch whose gradients are in ``.grad``; every
        ``accumulate``-th call steps the optimizer on the mean and clears
        ``.grad``. Returns whether it stepped."""
        self.micro_step += 1
        if self.micro_step % self.accumulate:
            return False
        if self.accumulate > 1:
            grads = [p.grad for p in self.optimizer.params
                     if p.grad is not None]
            torch._foreach_div_(grads, float(self.accumulate))
        self.optimizer.step()
        self.optimizer.zero_grad()
        self.step += 1
        return True
