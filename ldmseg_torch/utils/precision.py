"""The port's fp32 arithmetic: no TF32.

PyTorch lets cuDNN's convolutions (``torch.backends.cudnn.allow_tf32``, on
by default) and, where asked, cuBLAS's fp32 products
(``torch.backends.cuda.matmul.allow_tf32``) round their inputs to TF32's
10-bit mantissa. The JAX reference computes fp32 in fp32: its fp32
convolutions, calibration amaxes and fp32 master arithmetic are what the
port is held to. Every trainer turns both off when it is built
(:func:`strict_fp32`), so that the command-line tools, a spawned rank and
any caller that builds one compute as the reference does; bf16 and int8
work is untouched by either flag.
"""

from __future__ import annotations

import torch


def strict_fp32() -> None:
    """Turn TF32 off for cuBLAS's fp32 products and cuDNN's fp32
    convolutions in this process (a process-wide setting)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
