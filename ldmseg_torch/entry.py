"""The port's flagship forward, the counterpart of ``__graft_entry__.entry()``
(``__graft_entry__.py:27-49``): the SD-1.4-width UNet (8 input channels, no
cross-attention, self-attention on K1) with random weights from seed 0 in
bf16, on a zero ``[1, 8, 32, 64]`` sample (one 256x512 frame's latent,
NCHW) at timestep 0.

    from ldmseg_torch.entry import entry
    fn, args = entry()          # on the card; entry("cpu") for the CPU
    out = fn(*args)             # [1, 4, 32, 64] bf16
"""

from __future__ import annotations

import torch

from .models.layers import init_random_
from .models.unet import UNet2DCondition, UNetConfig

SEED = 0


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` runs the flagship UNet forward under
    ``torch.inference_mode``; ``args`` are the zero sample and timesteps.
    ``fn.unet`` is the UNet (``use_fused_attention``, eval mode, no
    gradients)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: device 'cuda' asked for but "
                           "torch.cuda.is_available() is False")
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(in_channels=8,
                                          use_fused_attention=True))
    unet.to_empty(device=device)
    init_random_(unet, torch.Generator(device=device).manual_seed(SEED))
    unet = unet.to(torch.bfloat16).eval().requires_grad_(False)
    sample = torch.zeros((1, 8, 32, 64), dtype=torch.bfloat16, device=device)
    timesteps = torch.zeros((1,), dtype=torch.long, device=device)

    def fn(sample, timesteps):
        with torch.inference_mode():
            return unet(sample, timesteps)

    fn.unet = unet
    return fn, (sample, timesteps)
