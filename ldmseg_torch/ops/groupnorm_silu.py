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

On the card each (image, group) span gets a thread-block cluster of up to
eight CTAs that holds it in registers (:func:`sm90_gn_plan`): K5 is one
launch, K6 two (the second takes the image's scale from the first's
per-CTA maxima and writes the codes).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

MAX_TILE_BYTES = 8 * 1024 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K5's and K6's clusters (csrc/groupnorm_silu.cu)
THREADS = 256            # threads of a CTA
VALUES = 32              # x values a thread holds in registers
MAX_CLUSTER = 8          # CTAs of one span: the portable cluster size


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


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """How K5 and K6 cover ``spans`` (image, group) spans of ``span``
    elements: a cluster of ``cluster`` CTAs per span, ``per_cta`` elements
    a CTA (whole ``vec``-element 16-byte accesses, or ``vec`` 1: scalar),
    held in registers over ``rounds`` rounds of ``THREADS · VALUES``."""

    span: int
    spans: int
    vec: int
    cluster: int
    per_cta: int
    rounds: int

    def fields(self) -> tuple:
        """The four ints the C entry points read (``groupnorm_silu.cu``'s
        ``Plan``)."""
        return (int(self.vec > 1), self.cluster, self.per_cta, self.rounds)

    @property
    def ctas(self) -> int:
        return self.spans * self.cluster

    def k6_scratch_words(self, batch: int) -> int:
        """K6's fp32 scratch: ``(mean, inv)`` per span, the max |y| per
        CTA, and ``s`` per image, in that order."""
        return 2 * self.spans + self.ctas + batch


def sm90_gn_plan(b: int, c: int, hw: int, groups: int,
                 dtype: torch.dtype = torch.bfloat16,
                 aligned: bool = True) -> GNPlan:
    """K5's and K6's launch for ``x [b, c, hw]``: the fewest CTAs per span
    whose registers hold it (``VALUES`` a thread), at most ``MAX_CLUSTER``
    (a larger span takes rounds), the span cut into slices of whole
    16-byte accesses, every one non-empty. ``aligned``: x's base allows
    16-byte accesses (the spans' length decides the rest)."""
    if c % groups:
        raise ValueError(f"C={c} does not divide into {groups} groups")
    esize = dtype.itemsize
    span = c // groups * hw
    spans = b * groups
    vec = 16 // esize if aligned and span * esize % 16 == 0 else 1
    held = THREADS * VALUES
    k = max(1, min(-(-span // held), MAX_CLUSTER))
    while True:
        per_cta = -(-span // k)
        per_cta = -(-per_cta // vec) * vec
        if k == 1 or (k - 1) * per_cta < span:
            break
        k -= 1
    return GNPlan(span=span, spans=spans, vec=vec, cluster=k,
                  per_cta=per_cta, rounds=-(-per_cta // held))


@functools.lru_cache(maxsize=None)
def _plan_c(b, c, hw, groups, dtype, aligned):
    plan = sm90_gn_plan(b, c, hw, groups, dtype, aligned)
    return plan, (ctypes.c_int * 4)(*plan.fields())


@functools.cache
def _kernel(entry: str):
    fn = getattr(_build.load("groupnorm_silu"), entry)
    pointers = 4 if entry == "ldmseg_group_norm_silu" else 5  # K5, K6
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * pointers
                   + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
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


def _affine_operands(name, x, scale, bias):
    """Scale and shift as the kernels read them: bf16 or fp32, one dtype,
    contiguous, on x's device; taken as they are when they already are."""
    c = x.shape[1]
    if scale.dtype != bias.dtype or scale.dtype not in _DTYPE_CODE:
        scale, bias = scale.float(), bias.float()
    if not (scale.is_contiguous() and bias.is_contiguous()):
        scale, bias = scale.contiguous(), bias.contiguous()
    if scale.device != x.device or bias.device != x.device \
            or scale.numel() != c or bias.numel() != c:
        raise ValueError(f"{name}: scale and bias must be [{c}] on x's "
                         f"device")
    return scale, bias


def _launch(x, scale, bias, groups, eps, quantize: bool):
    name = "K6" if quantize else "K5"
    check_kernel_input(name, x, groups)
    b, c, h, w = x.shape
    sc, bi = _affine_operands(name, x, scale, bias)
    dev = x.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x, scale, bias, groups, eps, quantize)
    codes = (_DTYPE_CODE[x.dtype], _DTYPE_CODE[sc.dtype])
    plan, plan_c = _plan_c(b, c, h * w, groups, x.dtype,
                           x.data_ptr() % 16 == 0)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if quantize:
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scratch = torch.empty(plan.k6_scratch_words(b), dtype=torch.float32,
                              device=x.device)
        err = _kernel("ldmseg_group_norm_silu_quant")(
            *codes, x.data_ptr(), q.data_ptr(), scratch.data_ptr(),
            sc.data_ptr(), bi.data_ptr(), b, c, h * w, groups, eps, plan_c,
            stream)
        out = (q, scratch[-b:])
    else:
        out = torch.empty_like(x)
        err = _kernel("ldmseg_group_norm_silu")(
            *codes, x.data_ptr(), out.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), b, c, h * w, groups, eps, plan_c, stream)
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
        with torch.no_grad():
            return group_norm_silu_quant_fallback(x, scale, bias, groups, eps)
    if x.device.type == "cpu":
        with torch.no_grad():
            return group_norm_silu_quant_reference(x, scale, bias, groups,
                                                   eps)
    if x.device.type != "cuda":
        raise ValueError(f"K6: unsupported device {x.device}")
    out = _launch(x, scale, bias, groups, eps, quantize=True)
    group_norm_silu_quant.launches += 1
    return out


group_norm_silu_quant.launches = 0
group_norm_silu_quant.fallbacks = 0
