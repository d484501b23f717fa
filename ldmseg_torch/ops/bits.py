"""The analog-bits codec on the host, numpy (the port's copy of the numpy
twins in ``ldmseg_tpu/ops/bits.py``, :95-129): ids -> ``num_bits``
channels of 0/1 (``fill_value`` at the ignore label) and back (a channel is
1 where it is > 0; all ones, the ignore pattern, decodes to 0). The native
``bitcodec.cpp`` loader is not ported (ROADMAP.md queue 6)."""

from __future__ import annotations

from typing import Optional

import numpy as np


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
