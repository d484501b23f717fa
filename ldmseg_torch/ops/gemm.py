"""The Hopper product of the int8 blocks and the bf16 projections, ``C =
A·Wᵀ``, and its launch plan.

``csrc/gemm_sm90.cuh`` computes ``A [rows, k] · W [n, k]ᵀ`` with int8
operands and int32 sums or bf16 operands and fp32 sums (TMA ring, ``wgmma``,
the caller's epilogue on the accumulator registers). K3, K4, K8, K9, K10
and K12 run their products on it (``csrc/attention_ln_s8.cu``,
``csrc/geglu_ln_s8.cu``), K9's ``proj_out`` too (operands swapped), K8's
``proj_in`` prologue (A row-major or channel-major), K16 its projections
(``csrc/attention_fwd.cu``: W over three maps), K11, K17 and K18 theirs
(``csrc/attention_s8.cu``) and K7 its 3x3 conv (``csrc/gn_silu_conv.cu``:
nine shifted taps, split-K);
:func:`sm90_gemm_plan` chooses each launch's tiles and ring, the wrappers
pass it, and the C entry points check it.

:func:`gemm_s8` and :func:`gemm_bf16` are the product with nothing around
it (``csrc/gemm_sm90.cu``; ``gemm_s8(..., operands=2)`` the two-operand form
K4's up product runs), :func:`gemm_s8_heads` the per-head product of K17's
and K18's ``to_out`` with the caller's factors: no model path calls them;
``chip_smoke.py`` and the card tests hold them against ``torch._int_mm``
and ``torch.matmul``. A CPU tensor takes :func:`gemm_reference` or
:func:`gemm_heads_reference`; a CUDA tensor the kernel, or the wrapper
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from . import _build
from .attention import SM90_SMEM_LIMIT, SM90_SMS
from .quant import exact_int8_matmul

ROW_BYTES = 128          # one swizzle row: the depth of a stage
# shared memory of an SM, and what the card keeps of it for each block
# (NVIDIA's Hopper tuning guide): how many blocks of a plan are resident
SM90_SMEM_PER_SM, SM90_SMEM_RESERVED = 233472, 1024
MAX_STAGES = 4           # the deepest ring the plan takes by default
DEEP_STAGES = 8          # ... where the weights' bytes bound (the C side's)
# (rows, columns) of an output tile, in the order the plan tries them; a
# two-operand product (K4's up, whose gating epilogue is most of its time)
# tries 256 x 64 first: four consumer warpgroups share the epilogue
TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
TILES_TWO_OPERANDS = ((256, 64),)
DTYPES = {"int8": 0, "bfloat16": 1}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How the product covers ``[rows, n]``: tiles of ``block_m`` rows (64
    per consumer warpgroup) and ``block_n`` columns, ``operands`` W tiles
    per stage, a ring of ``stages``, ``k_tiles`` stages along k,
    ``smem_bytes`` of dynamic shared memory and the ``grid`` (row tiles,
    column tiles)."""

    dtype: int
    block_m: int
    block_n: int
    operands: int
    stages: int
    k_tiles: int
    smem_bytes: int
    grid: tuple

    def fields(self) -> tuple:
        """The nine ints the C entry points read (``gemm90::Plan``)."""
        return (self.dtype, self.block_m, self.block_n, self.operands,
                self.stages, self.k_tiles, self.smem_bytes, *self.grid)


COL_BYTES = 4 * 128 * 4  # the epilogue's per-column vectors: 4 x 128 fp32


def gemm_smem_bytes(block_m: int, block_n: int, operands: int,
                    stages: int) -> int:
    """1 KiB to align the swizzled tiles, per stage an A tile and
    ``operands`` W tiles one swizzle row deep, a full and an empty mbarrier
    per stage, and the epilogue's per-column vectors."""
    return (1024 + stages * (block_m + operands * block_n) * ROW_BYTES
            + 16 * stages + COL_BYTES)


def gemm_takes(n: int, k: int, dtype: str) -> bool:
    """What the product takes: ``n`` a multiple of 8 (the epilogue's column
    pairs) and rows of A and W a multiple of 16 bytes (a tensor map's
    stride): k % 16 for int8, k % 8 for bf16."""
    esize = 1 if dtype == "int8" else 2
    return n >= 8 and n % 8 == 0 and k >= 1 and (k * esize) % 16 == 0


def gemm_grid(rows: int, n: int, block_m: int, block_n: int,
              maps: int = 1, images: int = 1) -> tuple:
    """(row tiles, column tiles) of ``[rows, n]``: the row tiles per image
    of ``rows / images`` rows, the column tiles per map of ``n / maps``
    columns (``gemm_kernel``: no tile straddles two images or two maps)."""
    return (images * -(-(rows // images) // block_m),
            maps * -(-(n // maps) // block_n))


@functools.lru_cache(maxsize=None)
def sm90_gemm_plan(rows: int, n: int, k: int, dtype: str,
                   operands: int = 1, maps: int = 1, images: int = 1,
                   max_stages: int = MAX_STAGES,
                   tile: Optional[tuple] = None) -> GemmPlan:
    """The launch plan of ``[rows, k] · [n, k]ᵀ`` (``dtype`` "int8" or
    "bfloat16"; ``operands`` 2: two W tiles per stage into two accumulator
    sets, K4's h and gate; ``maps``: W in that many maps of ``n / maps``
    rows, K16's wq, wk and wv, the tiles narrowed to the widths that divide
    ``n / maps`` where one does, so that no column tile is cut short;
    ``images``: A channel-major, K8's ``[images, k, rows / images]``, its
    row tiles per image). The first tile of :data:`TILES` (after
    :data:`TILES_TWO_OPERANDS` for two operands) whose grid gives every SM
    a block, else the one with the most blocks (the small row counts of T
    = 128 and 32, bound by the weights' bytes), or ``tile`` where the
    caller names one; the deepest ring of two to ``max_stages`` stages
    (four by default; K9's ``proj_out`` and K7, bound by their weights,
    take up to :data:`DEEP_STAGES`) that fits, no deeper than k."""
    if dtype not in DTYPES:
        raise ValueError(f"sm90_gemm_plan: dtype {dtype!r}")
    if (maps < 1 or images < 1 or n % maps or rows % images
            or not 2 <= max_stages <= DEEP_STAGES
            or (tile is not None and tuple(tile) not in TILES)
            or (maps > 1 and operands != 1)
            or (images > 1 and dtype != "bfloat16")):
        raise ValueError(f"sm90_gemm_plan: {maps} maps, {images} images of "
                         f"[{rows}, {k}] x [{n}, {k}]^T in {dtype} with "
                         f"{operands} operands")
    if not gemm_takes(n // maps, k, dtype) or rows < 1:
        raise ValueError(f"sm90_gemm_plan: [{rows}, {k}] x [{n}, {k}]^T in "
                         f"{dtype}: n (per map) must be a multiple of 8 and "
                         f"a row of k elements a multiple of 16 bytes")
    depth = ROW_BYTES if dtype == "int8" else ROW_BYTES // 2
    k_tiles = -(-k // depth)

    def blocks(tile):
        gx, gy = gemm_grid(rows, n, *tile, maps, images)
        return gx * gy
    tiles = (TILES_TWO_OPERANDS if operands == 2 else ()) + tuple(TILES)
    if maps > 1:
        tiles = tuple(t for t in tiles if (n // maps) % t[1] == 0) or tiles
    if tile is None:
        tile = next((t for t in tiles if blocks(t) >= SM90_SMS),
                    max(reversed(tiles), key=blocks))  # ties: the smaller
    block_m, block_n = tile
    deepest = max(2, min(max_stages, k_tiles))
    stages = next(s for s in range(deepest, 1, -1)
                  if gemm_smem_bytes(block_m, block_n, operands, s)
                  <= SM90_SMEM_LIMIT)
    return GemmPlan(DTYPES[dtype], block_m, block_n, operands, stages,
                    k_tiles, gemm_smem_bytes(block_m, block_n, operands,
                                             stages),
                    gemm_grid(rows, n, block_m, block_n, maps, images))


def plans_c(*plans) -> ctypes.Array:
    """Plans (``GemmPlan`` or any with ``fields()``) as one C int array,
    in order."""
    ints = [i for p in plans for i in p.fields()]
    return (ctypes.c_int * len(ints))(*ints)


def gemm_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a·wᵀ``: int8 operands -> exact int32 sums, bf16 -> fp32 sums of
    the bf16 values."""
    if a.dtype == torch.int8:
        return exact_int8_matmul(a, w)
    return a.float() @ w.float().t()


@functools.cache
def _kernel(entry: str):
    fn = getattr(_build.load("gemm_sm90"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _gemm(a: torch.Tensor, w: torch.Tensor, dtype: str,
          operands: int = 1) -> torch.Tensor:
    torch_dtype = torch.int8 if dtype == "int8" else torch.bfloat16
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"gemm: a [rows, k] and w [n, k], got {a.shape} "
                         f"and {w.shape}")
    if a.dtype != torch_dtype or w.dtype != torch_dtype:
        raise ValueError(f"gemm: {dtype} operands, got {a.dtype}, {w.dtype}")
    if a.device.type == "cpu" and w.device.type == "cpu":
        return gemm_reference(a, w)
    if a.device.type != "cuda" or w.device != a.device:
        raise ValueError(f"gemm: a and w on one CUDA device, got {a.device} "
                         f"and {w.device}")
    rows, k = a.shape
    if operands not in (1, 2) or w.shape[0] % operands:
        raise ValueError(f"gemm: {operands} operands of {w.shape[0]} rows")
    n = w.shape[0] // operands
    plan = sm90_gemm_plan(rows, n, k, dtype, operands)
    a, w = a.contiguous(), w.contiguous()
    out = torch.empty((rows, operands * n), device=a.device,
                      dtype=torch.int32 if dtype == "int8" else torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel(f"ldmseg_gemm_{'s8' if dtype == 'int8' else 'bf16'}")(
            a.data_ptr(), w.data_ptr(), out.data_ptr(), rows, n, k, operands,
            plans_c(plan), stream)
    if err != 0:
        raise RuntimeError(f"gemm ({dtype}) launch failed: CUDA error {err}")
    return out


def gemm_s8(a: torch.Tensor, w: torch.Tensor,
            operands: int = 1) -> torch.Tensor:
    """int32 ``a·wᵀ`` of int8 ``a [rows, k]`` and ``w [n, k]``; with
    ``operands=2`` the kernel takes w's two halves as two operands of one
    tile (K4's up product: h and gate rows of W1), the result the same."""
    out = _gemm(a, w, "int8", operands)
    if a.device.type == "cuda":
        gemm_s8.launches += 1
    return out


gemm_s8.launches = 0


def gemm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 ``a·wᵀ`` of bf16 ``a [rows, k]`` and ``w [n, k]``."""
    out = _gemm(a, w, "bfloat16")
    if a.device.type == "cuda":
        gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


def gemm_heads_reference(a: torch.Tensor, w: torch.Tensor,
                         factors: torch.Tensor, heads: int) -> torch.Tensor:
    """The per-head product in plain PyTorch: ``a [rows, H·dp]`` and ``w
    [n, H·dp]`` int8, ``factors [rows / t, H]`` fp32; ``Σ_h float(int32
    a_h·w_hᵀ)·f[row / t, h]`` in fp32, h = 0 first, each product and sum
    rounded (two elementwise operations, no fused multiply-add)."""
    rows = a.shape[0]
    dp = a.shape[1] // heads
    f = factors.repeat_interleave(rows // factors.shape[0], dim=0)
    out = torch.zeros((rows, w.shape[0]), dtype=torch.float32,
                      device=a.device)
    for h in range(heads):
        c32 = exact_int8_matmul(a[:, h * dp:(h + 1) * dp],
                                w[:, h * dp:(h + 1) * dp])
        out = out + c32.float() * f[:, h:h + 1]
    return out


def gemm_s8_heads(a: torch.Tensor, w: torch.Tensor, factors: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """fp32 ``Σ_h float(a_h·w_hᵀ)·factors[row / t, h]`` of int8 ``a [rows,
    H·dp]`` and ``w [n, H·dp]`` (dp a multiple of 32), images of ``t =
    rows / factors.shape[0]`` rows: ``csrc/gemm_sm90.cuh:gemm_heads_kernel``
    behind the test entry ``ldmseg_gemm_s8_heads``."""
    if (a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]
            or a.dtype != torch.int8 or w.dtype != torch.int8
            or a.shape[1] % (32 * heads) or factors.shape[-1] != heads
            or a.shape[0] % factors.shape[0]):
        raise ValueError(f"gemm_s8_heads: a [rows, H*dp], w [n, H*dp] int8 "
                         f"(dp % 32), factors [images, H], got "
                         f"{tuple(a.shape)}, {tuple(w.shape)}, "
                         f"{tuple(factors.shape)}")
    if a.device.type == "cpu":
        return gemm_heads_reference(a, w, factors.float(), heads)
    if a.device.type != "cuda" or w.device != a.device:
        raise ValueError("gemm_s8_heads: a and w on one CUDA device")
    rows, k = a.shape
    n = w.shape[0]
    t = rows // factors.shape[0]
    plan = sm90_gemm_plan(rows, n, k, "int8")
    f = factors.float().contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=a.device)
    fn = _build.load("gemm_sm90").ldmseg_gemm_s8_heads
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.contiguous().data_ptr(), w.contiguous().data_ptr(),
                 f.data_ptr(), out.data_ptr(), rows, n, heads,
                 k // heads // 32, t, plans_c(plan), stream)
    if err != 0:
        raise RuntimeError(f"gemm_s8_heads launch failed: CUDA error {err}")
    gemm_s8_heads.launches += 1
    return out


gemm_s8_heads.launches = 0
