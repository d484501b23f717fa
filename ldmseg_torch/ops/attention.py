"""K1: the UNet's multi-head self-attention forward.

Counterpart of ``ldmseg_tpu/ops/pallas/attention.py``: ``fused_self_attention``
(:1530), the Pallas kernel ``_attn_kernel``/``_attn_body`` (:28, :35) behind
``_fused_impl`` (:1269) and its XLA twin ``_xla_reference`` (:1292).

``fused_self_attention`` takes ``[B, T, H, D]`` tensors. A CUDA tensor goes to
the hand-written Hopper kernel ``csrc/attention_fwd.cu`` and nowhere else: if
the kernel cannot take the input, the wrapper raises. A CPU tensor goes to
:func:`attention_reference`, the same arithmetic in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_HEAD_DIM = 160
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(Q Kᵀ·scale)·V on ``[B, T, H, D]`` with K1's rounding: scores
    accumulated and soft-maxed in fp32, P rounded to the input dtype, P·V
    accumulated in fp32 and returned in the input dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype)


@functools.cache
def _kernel():
    fn = _build.load("attention_fwd").ldmseg_attention_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"attention kernel: q, k, v must share one [B, T, H, D] shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"attention kernel: dtype must be float32 or bfloat16 on all "
            f"three inputs, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("attention kernel: q, k, v on different devices")
    b, t, h, d = q.shape
    if d % 8 != 0 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(
            f"attention kernel: head dim {d} not supported (a multiple of 8 "
            f"up to {MAX_HEAD_DIM})")
    if t < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f"attention kernel: shape {tuple(q.shape)} out of "
                         f"range (T >= 1, 1 <= B*H <= 65535)")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"attention kernel: {name} needs unit stride on D, strides "
                f"that are multiples of 8 and a 16-byte aligned base; got "
                f"strides {x.stride()}")


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Multi-head self-attention on ``[B, T, H, D]``; returns ``[B, T, H, D]``
    contiguous, in the input dtype. CUDA tensors run the Hopper kernel (bf16
    or fp32, D a multiple of 8 up to 160, any T); CPU tensors run
    :func:`attention_reference`. ``fused_self_attention.launches`` counts the
    kernel launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    _check_kernel_inputs(q, k, v)
    b, t, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    kernel = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, t, h, d, strides, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    fused_self_attention.launches += 1
    return out


fused_self_attention.launches = 0
