"""K7: one ResnetBlock half, GroupNorm + SiLU + 3x3 conv + bias, NCHW.

Counterpart of ``ldmseg_tpu/ops/pallas/gn_silu_conv.py``: the Pallas kernel
``_kernel`` (:30) behind ``fused_gn_silu_conv`` (:105) with its recompute
VJP (:116-128), the XLA twin ``_reference`` (:95) and the dispatch
``gn_silu_conv`` (:131). No module routes to it, in JAX or here: it is an op
(``chip_smoke.py`` drives it on the UNet's resnet halves). It takes the
port's layouts, x ``[B, Cin, H, W]`` and w ``[Cout, Cin, 3, 3]`` (the JAX
function NHWC and HWIO).

Dispatch, as in JAX: when ``max(H·W·Cin, H·W·Cout)·4 <= 6 MiB`` a CUDA
tensor goes to ``csrc/gn_silu_conv.cu`` (bf16 only, the path's type; any
other input it cannot take raises; counted in ``gn_silu_conv.launches``)
and a CPU tensor to the kernel's plain version
:func:`gn_silu_conv_reference`; larger images go to
:func:`gn_silu_conv_fallback`, counted in ``gn_silu_conv.fallbacks``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .groupnorm_silu import (check_kernel_input, gn_silu_reference,
                             gn_silu_rows, stats_scratch, vectorizes)

MAX_TILE_BYTES = 6 * 1024 * 1024


def takes_kernel(x: torch.Tensor, cout: int, max_tile_bytes: int) -> bool:
    """The JAX wrapper's tile rule (:139) without its CPU clause."""
    _, cin, h, w = x.shape
    return max(h * w * cin, h * w * cout) * 4 <= max_tile_bytes


def gn_silu_conv_reference(x, scale, bias, w, b, groups: int = 32,
                           eps: float = 1e-5) -> torch.Tensor:
    """K7's plain version (:30-58): :func:`gn_silu_rows` rounded to x's
    dtype (the kernel's padded scratch), zero padding of that activation,
    the 3x3 conv of its values with w in x's dtype summed in fp32, the bias
    added in fp32, the result in x's dtype."""
    y = gn_silu_rows(x, scale, bias, groups, eps).to(x.dtype).float()
    out = F.conv2d(y, w.to(x.dtype).float(), padding=1)
    return (out + b.float()[:, None, None]).to(x.dtype)


def gn_silu_conv_fallback(x, scale, bias, w, b, groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """``_reference`` (:95-102): :func:`gn_silu_reference` in x's dtype,
    the conv in x's dtype, the bias in the conv's dtype; differentiable (the
    recompute of the backward)."""
    y = gn_silu_reference(x, scale, bias, groups, eps)
    out = F.conv2d(y, w.to(x.dtype), padding=1)
    return (out + b.to(out.dtype)[:, None, None]).to(x.dtype)


@functools.cache
def _kernel():
    fn = _build.load("gn_silu_conv").ldmseg_gn_silu_conv
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, scale, bias, w, b, groups, eps):
    check_kernel_input("K7", x, groups, dtypes=(torch.bfloat16,))
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    if tuple(w.shape) != (cout, cin, 3, 3):
        raise ValueError(f"K7: w must be [Cout, {cin}, 3, 3], got "
                         f"{tuple(w.shape)}")
    wk = w.detach().to(torch.bfloat16).contiguous()
    if wk.data_ptr() % 16:
        wk = wk.clone()
    sc, bi, bk = (t.detach().float().contiguous() for t in (scale, bias, b))
    if any(t.device != x.device for t in (wk, sc, bi, bk)) or \
            sc.numel() != cin or bi.numel() != cin or bk.numel() != cout:
        raise ValueError(f"K7: scale, bias [{cin}] and b [{cout}] must lie "
                         f"on x's device")
    out = torch.empty((bsz, cout, h, wd), dtype=x.dtype, device=x.device)
    part = stats_scratch(x, groups)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                        wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                        part.data_ptr(), bsz, cin, cout, h, wd, groups, eps,
                        int(vectorizes(x, groups)), stream)
    if err != 0:
        raise RuntimeError(f"K7 launch failed: CUDA error {err}")
    return out


def _forward(x, scale, bias, w, b, groups, eps):
    """K7 on a CUDA tensor, its plain version on a CPU one."""
    if x.device.type == "cpu":
        return gn_silu_conv_reference(x, scale, bias, w, b, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"K7: unsupported device {x.device}")
    out = _launch(x, scale, bias, w, b, groups, eps)
    gn_silu_conv.launches += 1
    return out


class _FusedGnSiluConv(torch.autograd.Function):
    """K7 forward; the backward recomputes through
    :func:`gn_silu_conv_fallback` (``_bwd`` :120-125)."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, b, groups, eps):
        ctx.save_for_backward(x, scale, bias, w, b)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, scale, bias, w, b, groups, eps)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = gn_silu_conv_fallback(*leaves, ctx.groups, ctx.eps)
        return (*torch.autograd.grad(y, leaves, g), None, None)


def fused_gn_silu_conv(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """``conv3x3(silu(group_norm(x)·scale + bias), w) + b`` on K7,
    ``[B, Cout, H, W]`` in x's dtype; differentiable."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias, w, b)):
        return _FusedGnSiluConv.apply(x, scale, bias, w, b, groups, eps)
    return _forward(x, scale, bias, w, b, groups, eps)


def gn_silu_conv(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 w: torch.Tensor, b: torch.Tensor, groups: int = 32,
                 eps: float = 1e-5,
                 max_tile_bytes: int = MAX_TILE_BYTES) -> torch.Tensor:
    """The dispatch of ``gn_silu_conv`` (:131-142): K7 (or its plain
    version on the CPU) when the image fits ``max_tile_bytes``, else
    :func:`gn_silu_conv_fallback`, counted in ``gn_silu_conv.fallbacks``."""
    if takes_kernel(x, w.shape[0], max_tile_bytes):
        return fused_gn_silu_conv(x, scale, bias, w, b, groups, eps)
    gn_silu_conv.fallbacks += 1
    return gn_silu_conv_fallback(x, scale, bias, w, b, groups, eps)


gn_silu_conv.launches = 0
gn_silu_conv.fallbacks = 0
