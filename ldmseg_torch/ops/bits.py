"""The analog-bits codec: ids -> ``num_bits`` channels of 0/1
(``fill_value`` at the ignore label) and back (a channel is 1 where it is >
0; all ones, the ignore pattern, decodes to 0). Counterpart of
``ldmseg_tpu/ops/bits.py``: :func:`encode_bits` and :func:`decode_bits` on
tensors (:28-93; channels last, on the tensor's device), and the numpy
twins (:95-129) that the host pipeline's tests hold the native codec
(``data/native``) against."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def encode_bits(x: torch.Tensor, num_bits: int,
                ignore_label: Optional[int] = 0,
                fill_value: float = 0.5):
    """``[...]`` int ids -> (bits ``[..., num_bits]`` float32, ignore mask
    ``[...]`` bool), on ``x``'s device."""
    shifts = torch.arange(num_bits, dtype=x.dtype, device=x.device)
    bits = ((x[..., None] >> shifts) & 1).to(torch.float32)
    if ignore_label is None:
        ignore = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    else:
        ignore = x == ignore_label
        bits = torch.where(ignore[..., None],
                           torch.tensor(fill_value, dtype=torch.float32,
                                        device=x.device), bits)
    return bits, ignore


def decode_bits(x: torch.Tensor, axis: int = -1,
                invalid_to_zero: bool = True) -> torch.Tensor:
    """Bits (analog, thresholded at 0) on ``axis`` -> int32 ids."""
    axis = axis % x.dim()
    n = x.shape[axis]
    shape = [1] * x.dim()
    shape[axis] = n
    weights = (2 ** torch.arange(n, dtype=torch.int32,
                                 device=x.device)).reshape(shape)
    out = ((x > 0).to(torch.int32) * weights).sum(dim=axis,
                                                  dtype=torch.int32)
    if invalid_to_zero:
        out = torch.where(out == 2 ** n - 1, torch.zeros_like(out), out)
    return out


def encode_bits_np(x: np.ndarray, num_bits: int,
                   ignore_label: Optional[int] = 0,
                   fill_value: float = 0.5):
    """``[...]`` int ids -> (bits ``[..., num_bits]`` float32, ignore
    mask)."""
    x = np.asarray(x)
    shifts = np.arange(num_bits, dtype=x.dtype)
    bits = ((x[..., None] >> shifts) & 1).astype(np.float32)
    if ignore_label is None:
        ignore = np.zeros(x.shape, dtype=bool)
    else:
        ignore = x == ignore_label
        bits[ignore] = np.float32(fill_value)
    return bits, ignore


def decode_bits_np(x: np.ndarray, axis: int = -1,
                   invalid_to_zero: bool = True) -> np.ndarray:
    """Bits (analog, thresholded at 0) on ``axis`` -> int64 ids."""
    x = np.asarray(x)
    axis = axis % x.ndim
    n = x.shape[axis]
    bits = (x > 0).astype(np.int64)
    shape = [1] * x.ndim
    shape[axis] = n
    weights = (2 ** np.arange(n, dtype=np.int64)).reshape(shape)
    out = np.sum(bits * weights, axis=axis)
    if invalid_to_zero:
        out[out == (2 ** n - 1)] = 0
    return out
