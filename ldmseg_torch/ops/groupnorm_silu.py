"""K5 and K6: fused GroupNorm + SiLU of the UNet's resnets, NCHW.

Counterpart of ``ldmseg_tpu/ops/pallas/groupnorm_silu.py``: the shared GN
numerics ``gn_silu_rows`` (:25), K5 ``_gn_silu_kernel`` (:52) behind
``fused_group_norm_silu`` and the dispatch ``group_norm_silu`` (:130), its
XLA twin ``_reference`` (:101) with the recompute VJP (:113-127), and K6
``_gn_silu_quant_kernel`` (:151) behind ``group_norm_silu_quant`` (:175).
The JAX functions take NHWC; these take the port's NCHW (the tests
transpose at the boundary).

Dispatch, as in JAX: when one image fits the TPU kernel's tile,
``H·W·C·4 <= 8 MiB``, a CUDA tensor goes to the hand-written kernel in
``csrc/groupnorm_silu.cu`` (counted in ``.launches``; an input it cannot
take raises) and a CPU tensor to the kernel's plain PyTorch version
(:func:`gn_silu_rows`: the variance as E[x²] − mean²); a larger image goes
to :func:`gn_silu_reference` (the centred variance), counted in
``.fallbacks``. K5 is differentiable: its backward recomputes through
:func:`gn_silu_reference`, as the JAX ``_bwd``; K6 is inference only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

MAX_TILE_BYTES = 8 * 1024 * 1024
CHUNK = 4096  # elements of one (image, group) span per block (gn_common.cuh)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _image_numel(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:])


def takes_kernel(x: torch.Tensor, max_tile_bytes: int) -> bool:
    """The JAX wrappers' tile rule without their CPU clause: one image's
    ``[H, W, C]`` in fp32 fits ``max_tile_bytes``."""
    return _image_numel(x) * 4 <= max_tile_bytes


def _affine(t: torch.Tensor) -> torch.Tensor:
    return t.float()[:, None, None]


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as a true division: on the card PyTorch applies a Python
    scalar divisor as its reciprocal, so the divisor is a 0-d tensor."""
    return a / torch.full((), d, device=a.device)


def gn_silu_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 groups: int, eps: float) -> torch.Tensor:
    """``gn_silu_rows`` (:25-49) on NCHW, fp32 out: per (image, group)
    ``mean = Σx / n``, ``var = Σx² / n − mean²``, ``inv = 1 / sqrt(var +
    eps)``; ``y = ((x − mean)·inv)·scale + bias``; ``y·sigmoid(y)``. The
    kernels' arithmetic, one rounding per operation."""
    b, c = x.shape[:2]
    xg = x.float().reshape(b, groups, -1)
    n = xg.shape[-1]
    mean = _div(xg.sum(-1, keepdim=True), n)
    var = _div((xg * xg).sum(-1, keepdim=True), n) - mean * mean
    inv = 1.0 / torch.sqrt(var + eps)
    y = ((xg - mean) * inv).reshape(x.shape)
    y = y * _affine(scale) + _affine(bias)
    return y * torch.sigmoid(y)


def gn_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, groups: int,
                      eps: float) -> torch.Tensor:
    """``_reference`` (:101-110), the fallback and the recompute of the
    backward: GroupNorm in fp32 with the centred variance (PyTorch's
    ``group_norm``, whose backward is one fused kernel), SiLU, x's dtype."""
    y = F.group_norm(x.float(), groups, scale.float(), bias.float(), eps)
    return F.silu(y).to(x.dtype)


def group_norm_silu_reference(x, scale, bias, groups: int = 32,
                              eps: float = 1e-5) -> torch.Tensor:
    """K5's plain version: :func:`gn_silu_rows` in x's dtype."""
    return gn_silu_rows(x, scale, bias, groups, eps).to(x.dtype)


def _quantize(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image symmetric int8 of fp32 ``y``: ``s = max(amax, 1e-6) / 127``
    and ``q = round(y / s)``, true divisions."""
    s = _div(y.abs().amax(dim=(1, 2, 3)).clamp_min(1e-6), 127.0)
    return torch.round(y / s[:, None, None, None]).to(torch.int8), s


def group_norm_silu_quant_reference(x, scale, bias, groups: int = 32,
                                    eps: float = 1e-5):
    """K6's plain version (:151-166): :func:`gn_silu_rows` quantized per
    image. Returns ``(q int8 [B, C, H, W], s float32 [B])``."""
    return _quantize(gn_silu_rows(x, scale, bias, groups, eps))


def group_norm_silu_quant_fallback(x, scale, bias, groups: int = 32,
                                   eps: float = 1e-5):
    """The JAX wrapper's fallback (:214-218): :func:`gn_silu_reference`
    (rounded to x's dtype), then the per-image quantize in fp32."""
    return _quantize(gn_silu_reference(x, scale, bias, groups, eps).float())


@functools.cache
def _kernel(entry: str):
    fn = getattr(_build.load("groupnorm_silu"), entry)
    pointers = 5 if entry == "ldmseg_group_norm_silu" else 7  # K5, K6
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * pointers
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_kernel_input(name: str, x: torch.Tensor, groups: int,
                       dtypes=tuple(_DTYPE_CODE)) -> None:
    """Raise ``ValueError`` on what the CUDA kernels do not take."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, C, H, W], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: x must be {' or '.join(map(str, dtypes))}"
                         f", got {x.dtype}")
    if x.shape[1] % groups:
        raise ValueError(f"{name}: C={x.shape[1]} does not divide into "
                         f"{groups} groups")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NCHW")
    if x.shape[0] * groups > 65535:
        raise ValueError(f"{name}: B x groups = {x.shape[0] * groups} > "
                         f"65535")


def stats_scratch(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The statistics pass's partial sums: 2 fp32 words per chunk of each
    (image, group) span."""
    chunks = -(-_image_numel(x) // groups // CHUNK)
    return torch.empty(2 * x.shape[0] * groups * chunks, dtype=torch.float32,
                       device=x.device)


def vectorizes(x: torch.Tensor, groups: int) -> bool:
    """16-byte accesses: every span a whole number of 16-byte words on an
    aligned base."""
    return (_image_numel(x) // groups * x.element_size()) % 16 == 0 \
        and x.data_ptr() % 16 == 0


def _launch(x, scale, bias, groups, eps, quantize: bool):
    name = "K6" if quantize else "K5"
    check_kernel_input(name, x, groups)
    b, c, h, w = x.shape
    # the kernels read scale and shift in bf16 or fp32 as they are
    sc, bi = scale.detach(), bias.detach()
    if sc.dtype != bi.dtype or sc.dtype not in _DTYPE_CODE:
        sc, bi = sc.float(), bi.float()
    sc, bi = sc.contiguous(), bi.contiguous()
    if sc.device != x.device or bi.device != x.device or sc.numel() != c \
            or bi.numel() != c:
        raise ValueError(f"{name}: scale and bias must be [{c}] on x's "
                         f"device")
    part = stats_scratch(x, groups)
    vec = int(vectorizes(x, groups))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if quantize:
            q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
            s = torch.empty(b, dtype=torch.float32, device=x.device)
            amax = torch.empty(b, dtype=torch.int32, device=x.device)
            err = _kernel("ldmseg_group_norm_silu_quant")(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[sc.dtype], x.data_ptr(),
                q.data_ptr(), s.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                part.data_ptr(), amax.data_ptr(), b, c, h * w, groups, eps,
                vec, stream)
            out = (q, s)
        else:
            out = torch.empty_like(x)
            err = _kernel("ldmseg_group_norm_silu")(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[sc.dtype], x.data_ptr(),
                out.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                part.data_ptr(), b, c, h * w, groups, eps, vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def _forward(x, scale, bias, groups, eps):
    """K5 on a CUDA tensor, its plain version on a CPU one."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"K5: unsupported device {x.device}")
    out = _launch(x, scale, bias, groups, eps, quantize=False)
    group_norm_silu.launches += 1
    return out


class _FusedGroupNormSiLU(torch.autograd.Function):
    """K5 forward; the backward recomputes through
    :func:`gn_silu_reference` (``_bwd`` :120-127)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps):
        ctx.save_for_backward(x, scale, bias)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, scale, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = gn_silu_reference(*leaves, ctx.groups, ctx.eps)
        grads = torch.autograd.grad(y, leaves, g)
        return (*grads, None, None)


def fused_group_norm_silu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, groups: int = 32,
                          eps: float = 1e-5) -> torch.Tensor:
    """``silu(group_norm(x)·scale + bias)`` for ``x [B, C, H, W]`` on K5,
    in x's dtype; differentiable."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _FusedGroupNormSiLU.apply(x, scale, bias, groups, eps)
    return _forward(x, scale, bias, groups, eps)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, groups: int = 32, eps: float = 1e-5,
                    max_tile_bytes: int = MAX_TILE_BYTES) -> torch.Tensor:
    """The dispatch of ``group_norm_silu`` (:130-139): K5 (or its plain
    version on the CPU) when one image fits ``max_tile_bytes``, else
    :func:`gn_silu_reference`, counted in ``group_norm_silu.fallbacks``."""
    if takes_kernel(x, max_tile_bytes):
        return fused_group_norm_silu(x, scale, bias, groups, eps)
    group_norm_silu.fallbacks += 1
    return gn_silu_reference(x, scale, bias, groups, eps)


group_norm_silu.launches = 0
group_norm_silu.fallbacks = 0


@torch.no_grad()
def group_norm_silu_quant(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, groups: int = 32,
                          eps: float = 1e-5,
                          max_tile_bytes: int = MAX_TILE_BYTES):
    """``silu(gn(x))`` quantized to int8 with one scale per image (:175):
    ``(q int8 [B, C, H, W], s float32 [B])``, ``q·s ≈ silu(gn(x))``. K6 (or
    its plain version on the CPU) when one image fits ``max_tile_bytes``,
    else :func:`group_norm_silu_quant_fallback`, counted in
    ``group_norm_silu_quant.fallbacks``. Inference only: no gradient."""
    if not takes_kernel(x, max_tile_bytes):
        group_norm_silu_quant.fallbacks += 1
        return group_norm_silu_quant_fallback(x, scale, bias, groups, eps)
    if x.device.type == "cpu":
        return group_norm_silu_quant_reference(x, scale, bias, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"K6: unsupported device {x.device}")
    out = _launch(x, scale, bias, groups, eps, quantize=True)
    group_norm_silu_quant.launches += 1
    return out


group_norm_silu_quant.launches = 0
group_norm_silu_quant.fallbacks = 0
