"""K1, K2, K14 and K16: the UNet's multi-head self-attention, forward and
backward, on the head layout, on the packed token layout, and with its
projections absorbed.

Counterpart of ``ldmseg_tpu/ops/pallas/attention.py``: ``fused_self_attention``
(:1530), the Pallas forward ``_attn_kernel``/``_attn_body`` (:28, :35) behind
``_fused_impl`` (:1269), its XLA twin ``_xla_reference`` (:1292), and the
backward ``_attn_bwd_kernel`` (:1298) behind ``_flash_bwd`` (:1357), which the
``custom_vjp`` of ``_fused_self_attention_flat`` (:1399-1417) calls.

``fused_self_attention`` takes ``[B, T, H, D]`` tensors and is differentiable.
A CUDA tensor goes to the hand-written Hopper kernels and nowhere else: the
forward to ``csrc/attention_fwd.cu`` (K1; in bf16 a TMA + ``wgmma`` kernel
whose launch plan :func:`sm90_launch_plan` chooses), the backward to
``csrc/attention_bwd.cu`` (K2; in bf16 two TMA + ``wgmma`` kernels whose
launch plan :func:`sm90_bwd_launch_plan` chooses); if a kernel cannot take
the input, the wrapper raises. A CPU tensor goes to
:func:`attention_reference` and :func:`attention_backward_reference`, the
same arithmetic in plain PyTorch.

It runs K1 at every T. JAX's ``fused_self_attention`` (:1545) sends ``T >
4096``, ``T % min(1024, T)`` and ``T % 8`` (at KITTI's 24x80 latent the
T = 1920 and T = 30 sites) to ``_xla_bthd``, whose scores are rounded to
the input dtype before the softmax; K1 keeps the Pallas kernel's fp32
scores there too, and on the card avoids materialising ``[B·H, T, T]``.

K14 is ``fused_self_attention_packed`` (:1514), ``use_packed_attention``'s
attention on ``[B, T, C]`` with ``C = heads·d``; its Pallas kernel
``_attn_kernel_btc`` (:1427) selects each head with one-hot matmuls, an
exact permutation, and then has K1's rounding points. The port keeps the
JAX wrapper's own shape rule (``T > 2048``, ``T % 8`` or ``C % heads`` go to
:func:`packed_attention_fallback`, the float ``_xla_btc`` :1487, counted in
``fused_self_attention_packed.fallbacks``; under autograd it differentiates
through plain PyTorch, as JAX through XLA). Every other shape runs K1's
device code on the head view ``[B, T, H, D]`` of the packed tensors
(``csrc/attention_fwd.cu:ldmseg_attention_fwd_packed``, counted in
``fused_self_attention_packed.launches``), or on a CPU tensor
:func:`packed_attention_reference`. JAX's backward is the XLA VJP of
``_xla_btc`` (:1495-1511); the port's is K2 on the same views, which keeps
the training step from materialising the scores.

K16 is ``absorbed_self_attention`` (:341), ``use_absorbed_attention``'s
attention with ``to_q``, ``to_k``, ``to_v`` and ``to_out`` (without its bias)
inside, on ``x [B, T, C]`` and the four ``[C, C]`` weights in the port's
``Linear`` layout (out, in); JAX splits them into heads, ``[H, C, D]`` and
``[H, D, C]``, a reshape. Its Pallas kernel ``_attn_kernel_absorbed`` (:239)
projects per (image, head), rounds q, k, v to the input dtype, runs K1's
rounding points and sums ``oh·Wo[h]`` over the heads in fp32. The port keeps
the JAX wrapper's shape rule (``T > 2048``, ``T % 8``, ``C % heads`` or ``d
% 8`` go to :func:`absorbed_attention_fallback`, the float ``_xla_absorbed``
:312, counted in ``absorbed_self_attention.fallbacks``); every other shape
runs ``csrc/attention_fwd.cu:ldmseg_attention_absorbed`` (in bf16 the Q,
K and V projections as one launch of the Hopper product
``csrc/gemm_sm90.cuh`` over the three weights, K1's device code on the head
views, ``to_out`` on the same product; plans from :func:`absorbed_plans`;
counted in ``absorbed_self_attention.launches``) or, on a CPU tensor,
:func:`absorbed_attention_reference`. JAX's backward is the XLA VJP of
``_xla_absorbed`` (:321-338); the port's runs K2 on the head views of the q,
k, v the forward kept, with the products for x and the four weights in
``torch.matmul``, as XLA computes them outside any kernel.

On a model axis (``parallel/tp.py:apply_tp``, where the axis divides the
heads) K14 runs unchanged on a rank's ``[B, T, C/n]`` with ``heads / n``
heads (its backward K2 on the same head views), and K16 in its partial
mode (``partial=True``, the same entry with ``partial`` 1):
rectangular weights of a rank's
heads (``wq``/``wk``/``wv`` ``[ci, C]``, ``wo`` ``[C, ci]``, ``ci =
heads·d``), q, k, v and oh ``[B, T, ci]``, and ``to_out``'s fp32 product
in place of its bf16 rounding, which the caller sums over the model group
and rounds once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

MAX_HEAD_DIM = 160  # K2's, K16's and the fp32 kernels' largest head dim
# K1's in bf16: the image VAE's mid attention is one head of 512
MAX_FWD_HEAD_DIM = 512
PACKED_MAX_SEQ = 2048  # fused_self_attention_packed's max_seq
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 forward kernel on Hopper (csrc/attention_fwd.cu,
# attention_fwd_kernel_sm90): the card's SMs and the shared memory a block
# may take, the head-dim classes it is compiled for (the N of its P·V
# product; V's zero columns past D give zero outputs) and the columns of a
# TMA box (one 128-byte swizzle row of bf16).
SM90_SMS = 132
SM90_SMEM_LIMIT = 232448
SM90_HEAD_CLASSES = (16, 32, 40, 64, 80, 128, 160)
SM90_BOX_D = 64
SM90_MAX_STAGES = 4
# the wide class above 160 (csrc/attention_sm90.cuh: kWideClass, kWideN):
# Q·Kᵀ over all 512 columns, P·V on a 128-column slice of V per block, the
# slices side by side along the grid's x
SM90_WIDE_CLASS = 512
SM90_WIDE_SLICE = 128


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the bf16 kernel covers one ``(B·H, T, D)``: ``block_q`` query
    rows per block (64 per consumer warpgroup), ``block_k`` keys per tile,
    a ring of ``stages`` K/V tiles, ``chunks`` TMA boxes of ``box_d``
    columns across D, ``smem_bytes`` of dynamic shared memory and the
    ``grid`` (query tiles, B·H)."""

    head_class: int
    block_q: int
    block_k: int
    stages: int
    box_d: int
    chunks: int
    smem_bytes: int
    grid: tuple

    @property
    def slices(self) -> int:
        """Blocks per query tile: V and O column slices (the wide class)."""
        return (SM90_WIDE_CLASS // SM90_WIDE_SLICE
                if self.head_class == SM90_WIDE_CLASS else 1)

    @property
    def v_chunks(self) -> int:
        """TMA boxes across one block's columns of V."""
        return self.chunks // self.slices

    def fields(self) -> tuple:
        """The nine ints the C entry points read (``struct Plan``)."""
        return (self.head_class, self.block_q, self.block_k, self.stages,
                self.box_d, self.chunks, self.smem_bytes, *self.grid)

    def as_c(self):
        """:meth:`fields` as a C int array."""
        fields = self.fields()
        return (ctypes.c_int * len(fields))(*fields)


def sm90_smem_bytes(block_q: int, block_k: int, chunks: int, stages: int,
                    v_chunks: int = 0) -> int:
    """1 KiB to align the swizzled tiles, Q (``chunks`` 128-byte boxes a
    row), a K tile (``chunks``) and a V tile (``v_chunks``, default
    ``chunks``) per stage, and the mbarriers (one for Q, a full and an
    empty one per stage). ``csrc/attention_sm90.cuh:smem_bytes``."""
    row = 2 * SM90_BOX_D  # bytes of a box row
    v_chunks = v_chunks or chunks
    return (1024 + block_q * chunks * row
            + stages * block_k * (chunks + v_chunks) * row
            + 8 * (1 + 2 * stages))


def sm90_forward_tiles(bh: int, t: int, head_class: int, chunks: int,
                       v_chunks: int) -> tuple:
    """``(block_q, block_k, stages)`` of the forward skeleton that K1 and
    K3's attention stage share (``csrc/attention_sm90.cuh``): 128-row query
    tiles (two consumer warpgroups) where they still give every SM a block,
    else 64 (one warpgroup): at T = 512 and B·H = 16, 64 blocks of 128 rows
    would leave half the card idle. Key tiles of 128, 64 above class 80
    (two score tiles and O in a consumer's 240 registers). The deepest ring
    of two to four stages that fits, and no deeper than the key tiles of
    the two passes."""
    block_k = 128 if head_class <= 80 else 64
    block_q = 128 if bh * -(-t // 128) >= SM90_SMS else 64
    deepest = max(2, min(SM90_MAX_STAGES, 2 * -(-t // block_k)))
    stages = next(s for s in range(deepest, 1, -1)
                  if sm90_smem_bytes(block_q, block_k, chunks, s, v_chunks)
                  <= SM90_SMEM_LIMIT)
    return block_q, block_k, stages


@functools.lru_cache(maxsize=None)
def sm90_launch_plan(bh: int, t: int, d: int) -> LaunchPlan:
    """The bf16 kernel's launch plan for ``B·H`` heads of ``T`` tokens and
    head dim ``d`` (:func:`sm90_forward_tiles`); the C entry points check
    it. Above class 160 the wide class: one consumer warpgroup of 64 query
    rows, 64-key tiles, the ring as deep as fits (two stages: 230,440
    bytes of Q, K and a V slice), ``SM90_WIDE_CLASS / SM90_WIDE_SLICE``
    blocks per query tile along x."""
    if d > SM90_HEAD_CLASSES[-1]:
        chunks = SM90_WIDE_CLASS // SM90_BOX_D
        v_chunks = SM90_WIDE_SLICE // SM90_BOX_D
        stages = next(s for s in range(SM90_MAX_STAGES, 1, -1)
                      if sm90_smem_bytes(64, 64, chunks, s, v_chunks)
                      <= SM90_SMEM_LIMIT)
        slices = SM90_WIDE_CLASS // SM90_WIDE_SLICE
        return LaunchPlan(SM90_WIDE_CLASS, 64, 64, stages, SM90_BOX_D,
                          chunks, sm90_smem_bytes(64, 64, chunks, stages,
                                                  v_chunks),
                          (slices * -(-t // 64), bh))
    head_class = next(c for c in SM90_HEAD_CLASSES if c >= d)
    chunks = -(-head_class // SM90_BOX_D)
    block_q, block_k, stages = sm90_forward_tiles(bh, t, head_class, chunks,
                                                  chunks)
    return LaunchPlan(head_class, block_q, block_k, stages, SM90_BOX_D, chunks,
                      sm90_smem_bytes(block_q, block_k, chunks, stages),
                      (-(-t // block_q), bh))


@functools.lru_cache(maxsize=None)
def _plan_c(bh: int, t: int, d: int):
    return sm90_launch_plan(bh, t, d).as_c()


# K2's bf16 kernels (csrc/attention_bwd.cu): the stats of a 64-query tile
# (m, 1 / l, delta) and the consumers' register count under setmaxnreg
SM90_BWD_STATS_FLOATS = 3 * 64
SM90_CONSUMER_REGS = 232


@dataclasses.dataclass(frozen=True)
class BwdLaunchPlan:
    """How K2's two bf16 kernels cover one ``(B·H, T, D)``. The stats
    kernel takes ``stats_block_q`` query rows per block (64 per consumer
    warpgroup) against ``stats_block_k``-key K/V tiles through a ring of
    ``stats_stages``; the main kernel ``main_block_k`` keys per block (64
    per consumer warpgroup) against ``q_tiles`` 64-query tiles through a
    ring of ``main_stages``. ``*_regs`` is the consumers' register count
    under ``setmaxnreg`` (0: none, one consumer warpgroup), ``*_smem`` the
    dynamic shared memory, ``*_grid_x`` the blocks along T; the grids'
    second axis is ``grid_y`` = B·H."""

    head_class: int
    chunks: int
    q_tiles: int
    stats_block_q: int
    stats_block_k: int
    stats_stages: int
    stats_regs: int
    stats_smem: int
    stats_grid_x: int
    main_block_k: int
    main_stages: int
    main_regs: int
    main_smem: int
    main_grid_x: int
    grid_y: int

    def as_c(self):
        """The 15 ints the C entry point reads (``struct BwdPlan``)."""
        fields = [getattr(self, f.name) for f in dataclasses.fields(self)]
        return (ctypes.c_int * len(fields))(*fields)


def sm90_bwd_stats_smem(block_q: int, block_k: int, chunks: int,
                        stages: int) -> int:
    """1 KiB to align the swizzled tiles, Q and dO (``block_q`` rows each),
    a K and a V tile per stage, and the mbarriers (one for Q and dO, a full
    and an empty one per stage)."""
    row = 2 * SM90_BOX_D
    return (1024 + 2 * block_q * chunks * row
            + stages * 2 * block_k * chunks * row + 8 * (1 + 2 * stages))


def sm90_bwd_main_smem(block_k: int, head_class: int, chunks: int,
                       stages: int) -> int:
    """1 KiB of slack, K and V (``block_k`` rows each), one 64 x 64 bf16
    dSᵀ tile per consumer warpgroup, per stage a 64-row Q and dO tile and
    the stats of 64 queries, the dQ tiles (one per dQ reducer: three up to
    D = 64, two up to 80, else one; each an fp32 64 x ``head_class`` per
    consumer warpgroup), and the mbarriers."""
    row = 2 * SM90_BOX_D
    box = 64 * row
    wgs = block_k // 64
    tiles = 3 if head_class <= 64 else 2 if head_class <= 80 else 1
    return (1024 + 2 * block_k * chunks * row + wgs * box
            + stages * (2 * chunks * box + 4 * SM90_BWD_STATS_FLOATS)
            + tiles * wgs * 64 * head_class * 4
            + 8 * (1 + 2 * stages + 2 * tiles))


@functools.lru_cache(maxsize=None)
def sm90_bwd_launch_plan(bh: int, t: int, d: int) -> BwdLaunchPlan:
    """K2's bf16 launch plan for ``B·H`` heads of ``T`` tokens and head dim
    ``d``; the C entry point checks it. Both kernels take two consumer
    warpgroups (and ``setmaxnreg``) where 128-row blocks still give every
    SM a block, else one; the main kernel only up to D = 80, where dK,
    dV, Sᵀ and dPᵀ of 64 keys fit a consumer's 232 registers. The stats
    kernel's key tiles are the forward's (128, 64 above D = 80). Each ring
    is the deepest of two to four stages that fits, and no deeper than the
    tiles it streams."""
    head_class = next(c for c in SM90_HEAD_CLASSES if c >= d)
    chunks = -(-head_class // SM90_BOX_D)
    q_tiles = -(-t // 64)
    wide = bh * -(-t // 128) >= SM90_SMS
    stats_q = 128 if wide else 64
    stats_k = 128 if head_class <= 80 else 64
    deepest = max(2, min(SM90_MAX_STAGES, -(-t // stats_k)))
    stats_stages = next(
        s for s in range(deepest, 1, -1)
        if sm90_bwd_stats_smem(stats_q, stats_k, chunks, s)
        <= SM90_SMEM_LIMIT)
    main_k = 128 if wide and head_class <= 80 else 64
    deepest = max(2, min(SM90_MAX_STAGES, q_tiles))
    main_stages = next(
        s for s in range(deepest, 1, -1)
        if sm90_bwd_main_smem(main_k, head_class, chunks, s)
        <= SM90_SMEM_LIMIT)
    return BwdLaunchPlan(
        head_class, chunks, q_tiles,
        stats_q, stats_k, stats_stages,
        SM90_CONSUMER_REGS if stats_q == 128 else 0,
        sm90_bwd_stats_smem(stats_q, stats_k, chunks, stats_stages),
        -(-t // stats_q),
        main_k, main_stages, SM90_CONSUMER_REGS if main_k == 128 else 0,
        sm90_bwd_main_smem(main_k, head_class, chunks, main_stages),
        -(-t // main_k),
        bh)


@functools.lru_cache(maxsize=None)
def _bwd_plan_c(bh: int, t: int, d: int):
    return sm90_bwd_launch_plan(bh, t, d).as_c()


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    # fp32 accumulation, as the kernels; float64 (gradcheck) stays float64
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(Q Kᵀ·scale)·V on ``[B, T, H, D]`` with K1's rounding: scores
    accumulated and soft-maxed in fp32, P rounded to the input dtype, P·V
    accumulated in fp32 and returned in the input dtype."""
    acc = _acc_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(acc), v.to(acc))
    return o.to(q.dtype)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 scale: float):
    """(dQ, dK, dV) of :func:`attention_reference` on ``[B, T, H, D]``, with
    K2's arithmetic: S and the softmax in fp32 with the row max subtracted;
    dV = Pᵀ·dO with P rounded to the input dtype; dP = dO·Vᵀ;
    dS = P∘(dP − rowsum(dP∘P)) in fp32, rounded to the input dtype as a
    product operand; dQ = dS·K·scale and dK = dSᵀ·Q·scale. Every product
    accumulates in fp32; the three results return in the input dtype."""
    acc = _acc_dtype(q)
    qa, ka, va, doa = (x.to(acc) for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qa, ka) * scale
    p = torch.softmax(s, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(acc), doa)
    dp = torch.einsum("bqhd,bkhd->bhqk", doa, va)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = ds.to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ka) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qa) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


@functools.cache
def _forward_kernel():
    fn = _build.load("attention_fwd").ldmseg_attention_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _backward_kernel():
    fn = _build.load("attention_bwd").ldmseg_attention_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(max_d: int = MAX_HEAD_DIM, **tensors):
    names = list(tensors)
    xs = list(tensors.values())
    x0 = xs[0]
    if x0.dim() != 4 or any(x.shape != x0.shape for x in xs):
        raise ValueError(
            f"attention kernel: {', '.join(names)} must share one "
            f"[B, T, H, D] shape, got {[tuple(x.shape) for x in xs]}")
    if any(x.dtype != x0.dtype for x in xs) or x0.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"attention kernel: dtype must be float32 or bfloat16 on all "
            f"inputs, got {[x.dtype for x in xs]}")
    if any(x.device != x0.device for x in xs):
        raise ValueError("attention kernel: inputs on different devices")
    b, t, h, d = x0.shape
    if d % 8 != 0 or not 8 <= d <= max_d:
        raise ValueError(
            f"attention kernel: head dim {d} not supported (a multiple of 8 "
            f"up to {max_d} for {x0.dtype})")
    if t < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f"attention kernel: shape {tuple(x0.shape)} out of "
                         f"range (T >= 1, 1 <= B*H <= 65535)")
    for name, x in tensors.items():
        if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(
                f"attention kernel: {name} needs unit stride on D, strides "
                f"that are multiples of 8 and a 16-byte aligned base; got "
                f"strides {x.stride()}")


def _strides(*xs):
    flat = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _attention_forward(q, k, v, scale):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    _check_kernel_inputs(
        MAX_FWD_HEAD_DIM if q.dtype == torch.bfloat16 else MAX_HEAD_DIM,
        q=q, k=k, v=v)
    b, t, h, d = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    kernel = _forward_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, t, h, d, _strides(q, k, v, out), float(scale),
            _plan_c(b * h, t, d), stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    if d > MAX_HEAD_DIM:  # the wide class's kernel
        fused_self_attention.wide_launches += 1
    else:
        fused_self_attention.launches += 1
    return out


def fused_self_attention_backward(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  scale: float):
    """(dQ, dK, dV) of :func:`fused_self_attention`, each ``[B, T, H, D]``
    contiguous in the input dtype. CUDA tensors run K2 (bf16 or fp32, D a
    multiple of 8 up to 160, any T; in bf16 a stats kernel and a main
    kernel on TMA + ``wgmma`` whose launch plan
    :func:`sm90_bwd_launch_plan` chooses, dQ summed over key tiles in a
    fixed order, so two calls give the same bits); CPU tensors run
    :func:`attention_backward_reference`.
    ``fused_self_attention_backward.launches`` counts the kernel launches."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attention: unsupported device {q.device}")
    _check_kernel_inputs(q=q, k=k, v=v, do=do)
    b, t, h, d = q.shape
    dq, dk, dv = (torch.empty_like(q, memory_format=torch.contiguous_format)
                  for _ in range(3))
    # the row statistics of every 64-query tile; bf16 also takes the fp32
    # dQ workspace and a counter per (b*h, 64-query tile) for dQ's ordered
    # sum over key tiles
    q_tiles = -(-t // 64)
    stats = torch.empty(b * h * q_tiles * SM90_BWD_STATS_FLOATS,
                        dtype=torch.float32, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    ws = torch.empty(b * h * q_tiles * 64 * d if bf16 else 0,
                     dtype=torch.float32, device=q.device)
    counters = torch.empty(b * h * q_tiles if bf16 else 0,
                           dtype=torch.int32, device=q.device)
    kernel = _backward_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = kernel(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), ws.data_ptr(), counters.data_ptr(), b, t, h, d,
            _strides(q, k, v, do, dq, dk, dv), float(scale),
            _bwd_plan_c(b * h, t, d), stream)
    if err != 0:
        raise RuntimeError(
            f"attention backward kernel launch failed: CUDA error {err}")
    fused_self_attention_backward.launches += 1
    return dq, dk, dv


fused_self_attention_backward.launches = 0


class _FusedSelfAttention(torch.autograd.Function):
    """K1 forward, K2 backward; saves q, k, v as ``_fwd`` does (:1404).
    K2 takes head dims up to 160: a CUDA input above that (the image VAE's
    D = 512, through which no path trains) raises here."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cuda" and q.shape[-1] > MAX_HEAD_DIM:
            raise NotImplementedError(
                f"fused_self_attention: no backward at head dim "
                f"{q.shape[-1]} (K2 takes up to {MAX_HEAD_DIM}); run it "
                f"under torch.no_grad()")
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _attention_forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fused_self_attention_backward(
            q, k, v, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def fused_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Multi-head self-attention on ``[B, T, H, D]``; returns ``[B, T, H, D]``
    contiguous, in the input dtype. CUDA tensors run K1 (D a multiple of 8
    up to 512 in bf16, 160 in fp32, any T); CPU tensors run
    :func:`attention_reference`. Under autograd the backward is K2 (CUDA,
    D up to 160) or
    :func:`attention_backward_reference` (CPU); without it (``no_grad``,
    ``inference_mode`` or no input that requires grad) nothing is saved.
    ``fused_self_attention.launches`` counts K1's launches at head dims up
    to 160, ``fused_self_attention.wide_launches`` those of its wide class
    (``attention_fwd_kernel_sm90_wide``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FusedSelfAttention.apply(q, k, v, scale)
    return _attention_forward(q, k, v, scale)


fused_self_attention.launches = 0
fused_self_attention.wide_launches = 0


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------
def packed_takes_kernel(t: int, c: int, heads: int) -> bool:
    """``fused_self_attention_packed``'s shape rule (:1524-1526) without its
    CPU clause; ``fused_self_attention_packed_s8`` (:218-220) shares it."""
    return not (t > PACKED_MAX_SEQ or t % 8 != 0 or c % heads != 0)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """The head view ``[B, T, H, D]`` of ``[B, T, C]`` (no copy when C has
    unit stride)."""
    return x.unflatten(-1, (heads, x.shape[-1] // heads))


def packed_attention_fallback(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, heads: int,
                              scale: float) -> torch.Tensor:
    """``_xla_btc`` (:1487) on ``[B, T, C]``: the scores of the input dtype
    (an einsum in that dtype, then the scale), the softmax in fp32 rounded
    back, P·V in the input dtype. Differentiable by autograd."""
    b, t, c = q.shape
    qh, kh, vh = (_heads(x, heads) for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, t, c)


def packed_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int,
                               scale: float) -> torch.Tensor:
    """K14's arithmetic in plain PyTorch: :func:`attention_reference` on the
    head views of ``[B, T, C]``, returned ``[B, T, C]``."""
    b, t, c = q.shape
    return attention_reference(_heads(q, heads), _heads(k, heads),
                               _heads(v, heads), scale).reshape(b, t, c)


@functools.cache
def _packed_kernel():
    fn = _build.load("attention_fwd").ldmseg_attention_fwd_packed
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _packed_forward(q, k, v, heads, scale):
    if q.device.type == "cpu":
        return packed_attention_reference(q, k, v, heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"K14: unsupported device {q.device}")
    if any(x.dim() != 3 or x.stride(2) != 1 for x in (q, k, v)):
        raise ValueError("K14: q, k, v must be [B, T, C] with unit stride "
                         "on C")
    # the head views, checked as K1 checks its inputs
    _check_kernel_inputs(**{n: _heads(x, heads) for n, x in
                            (("q", q), ("k", k), ("v", v))})
    b, t, c = q.shape
    out = torch.empty((b, t, c), dtype=q.dtype, device=q.device)
    st = [s_ for x in (q, k, v, out) for s_ in x.stride()[:2]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _packed_kernel()(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, t, c, heads, (ctypes.c_longlong * 8)(*st),
            float(scale), _plan_c(b * heads, t, c // heads), stream)
    if err != 0:
        raise RuntimeError(f"K14 launch failed: CUDA error {err}")
    fused_self_attention_packed.launches += 1
    return out


class _PackedSelfAttention(torch.autograd.Function):
    """K14 forward; K2 backward on the head views (JAX: the XLA VJP of
    ``_xla_btc``, :1504-1509)."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return _packed_forward(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        h = ctx.heads
        grads = fused_self_attention_backward(
            _heads(q, h), _heads(k, h), _heads(v, h),
            _heads(do.contiguous(), h), ctx.scale)
        return (*(g.reshape(q.shape) for g in grads), None, None)


def fused_self_attention_packed(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                scale: float) -> torch.Tensor:
    """Multi-head self-attention on the packed ``[B, T, C]`` layout (``C =
    heads·d``), returned ``[B, T, C]`` in the input dtype. Shapes the JAX
    rule sends away take :func:`packed_attention_fallback`; the others K14
    (CUDA: bf16 or fp32, d a multiple of 8 up to 160) or
    :func:`packed_attention_reference` (CPU), with K2 (CUDA) or
    :func:`attention_backward_reference` (CPU) as the backward under
    autograd."""
    b, t, c = q.shape
    if not packed_takes_kernel(t, c, heads):
        fused_self_attention_packed.fallbacks += 1
        return packed_attention_fallback(q, k, v, heads, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _PackedSelfAttention.apply(q, k, v, heads, scale)
    return _packed_forward(q, k, v, heads, scale)


fused_self_attention_packed.launches = 0
fused_self_attention_packed.fallbacks = 0


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------
def absorbed_takes_kernel(t: int, c: int, heads: int) -> bool:
    """``absorbed_self_attention``'s shape rule (:354-355) without its CPU
    clause; the other absorbed-projection wrappers share it:
    ``absorbed_self_attention_s8`` (:486-487),
    ``absorbed_fullc_self_attention_s8`` (:629-630),
    ``absorbed_padded_self_attention_s8`` and its LN form (:1105, K3, K8,
    K10, K11)."""
    return not (t > PACKED_MAX_SEQ or t % 8 != 0 or c % heads != 0
                or (c // heads) % 8 != 0)


def absorbed_attention_fallback(x: torch.Tensor, wq: torch.Tensor,
                                wk: torch.Tensor, wv: torch.Tensor,
                                wo: torch.Tensor, heads: int,
                                scale: float,
                                partial: bool = False) -> torch.Tensor:
    """``_xla_absorbed`` (:312-318): the projections in the input dtype,
    ``_xla_bthd``'s attention (the scores of the input dtype, the softmax in
    fp32 rounded back) and ``to_out`` in the input dtype (``partial``: in
    fp32, not rounded). Differentiable by autograd."""
    q, k, v = (F.linear(x, w) for w in (wq, wk, wv))
    oh = packed_attention_fallback(q, k, v, heads, scale)
    if partial:
        return F.linear(oh.to(_acc_dtype(x)), wo.to(_acc_dtype(x)))
    return F.linear(oh, wo)


def _absorbed_reference_parts(x, wq, wk, wv, wo, heads, scale,
                              partial=False):
    acc = _acc_dtype(x)
    q, k, v = (F.linear(x.to(acc), w.to(acc)).to(x.dtype)
               for w in (wq, wk, wv))
    oh = packed_attention_reference(q, k, v, heads, scale)
    out = F.linear(oh.to(acc), wo.to(acc))
    return (out if partial else out.to(x.dtype)), q, k, v, oh


def absorbed_attention_reference(x: torch.Tensor, wq: torch.Tensor,
                                 wk: torch.Tensor, wv: torch.Tensor,
                                 wo: torch.Tensor, heads: int,
                                 scale: float,
                                 partial: bool = False) -> torch.Tensor:
    """K16's arithmetic in plain PyTorch on ``[B, T, C]``: q, k, v = the
    projections summed in fp32 and rounded to the input dtype, K1's
    attention on their head views (:func:`packed_attention_reference`), and
    ``to_out`` over the whole depth summed in fp32, rounded once (the TPU
    kernel's per-head fp32 accumulation up to the summation order);
    ``partial``: not rounded (a rank's heads, :func:`absorbed_self_attention`
    with ``partial``)."""
    return _absorbed_reference_parts(x, wq, wk, wv, wo, heads, scale,
                                     partial)[0]


@functools.lru_cache(maxsize=None)
def absorbed_plans(b: int, t: int, c: int, heads: int,
                   ci: Optional[int] = None) -> tuple:
    """K16's three launch plans, in the order its C entry point reads them:
    K1's for the attention stage, then the Hopper product's
    (``ops/gemm.py:sm90_gemm_plan``, bf16) for the Q/K/V projection, one
    launch over the three weights as three maps of ``ci`` rows, and for
    ``to_out``. ``ci = heads·d`` is the inner width: ``c``, or a model
    axis's ``heads`` of a rank (the partial mode)."""
    from .gemm import sm90_gemm_plan
    ci = c if ci is None else ci
    return (sm90_launch_plan(b * heads, t, ci // heads),
            sm90_gemm_plan(b * t, 3 * ci, c, "bfloat16", maps=3),
            sm90_gemm_plan(b * t, c, ci, "bfloat16"))


@functools.lru_cache(maxsize=None)
def _absorbed_plans_c(b: int, t: int, c: int, heads: int,
                      ci: Optional[int] = None):
    from .gemm import plans_c
    return plans_c(*absorbed_plans(b, t, c, heads, ci))


@functools.cache
def _absorbed_kernel():
    fn = _build.load("attention_fwd").ldmseg_attention_absorbed
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_int),
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _absorbed_forward(x, wq, wk, wv, wo, heads, scale, partial=False):
    """(out, q, k, v, oh): q, k, v and oh ``[B, T, ci]`` in x's dtype, out
    ``[B, T, C]`` in x's dtype (``partial``: fp32, not rounded): K16 on a
    CUDA tensor, its plain version on a CPU one."""
    if x.device.type == "cpu":
        return _absorbed_reference_parts(x, wq, wk, wv, wo, heads, scale,
                                         partial)
    if x.device.type != "cuda":
        raise ValueError(f"K16: unsupported device {x.device}")
    b, t, c = x.shape
    ci = wq.shape[0]
    ws = (wq, wk, wv, wo)
    if x.dtype not in _DTYPE_CODE or any(w.dtype != x.dtype for w in ws):
        raise ValueError(f"K16: x and the four weights must share float32 "
                         f"or bfloat16, got {x.dtype} and "
                         f"{[w.dtype for w in ws]}")
    shapes = ((ci, c),) * 3 + ((c, ci),)
    if (any(w.shape != s_ or w.device != x.device
            for w, s_ in zip(ws, shapes))
            or (ci != c and not partial) or ci > c):
        raise ValueError(f"K16: the weights must be [{ci}, {c}] x 3 and "
                         f"[{c}, {ci}] on x's device (rectangular only in "
                         f"the partial mode), got "
                         f"{[tuple(w.shape) for w in ws]}")
    d = ci // heads
    if (ci % heads or d % 8 or not 8 <= d <= MAX_HEAD_DIM or c % 8
            or not 1 <= b * heads <= 65535 or x.numel() >= 2 ** 31):
        raise ValueError(f"K16: head dim {d} (a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}), C {c}, B*heads {b * heads} or "
                         f"{x.numel()} elements not taken")
    dev = x.device.index
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _absorbed_forward(x, wq, wk, wv, wo, heads, scale,
                                     partial)
    x = x.contiguous()
    ws = [w.contiguous() for w in ws]
    # q, k, v and oh in one allocation: its four views are what autograd
    # saves
    q, k, v, oh = torch.empty((4, b, t, ci), dtype=x.dtype,
                              device=x.device).unbind(0)
    out = torch.empty((b, t, c), device=x.device,
                      dtype=torch.float32 if partial else x.dtype)
    err = _absorbed_kernel()(
        _DTYPE_CODE[x.dtype], dev, x.data_ptr(),
        *(w.data_ptr() for w in ws), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), oh.data_ptr(), out.data_ptr(), b, t, c, ci, heads,
        float(scale), _absorbed_plans_c(b, t, c, heads, ci), int(partial),
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"K16 launch failed: CUDA error {err}")
    absorbed_self_attention.launches += 1
    return out, q, k, v, oh


def _rows(z: torch.Tensor) -> torch.Tensor:
    return z.reshape(-1, z.shape[-1])


class _AbsorbedSelfAttention(torch.autograd.Function):
    """K16 forward; the backward is K2 on the head views of the saved q, k,
    v, with the gradient products of x and the four weights in
    ``torch.matmul`` (JAX: the XLA VJP of ``_xla_absorbed``, :330-338). In
    the partial mode the fp32 output's gradient is cast to x's dtype first,
    and ``dx`` is this rank's share, summed over the ranks by the caller's
    ``copy_to``."""

    @staticmethod
    def forward(ctx, x, wq, wk, wv, wo, heads, scale, partial):
        out, q, k, v, oh = _absorbed_forward(x, wq, wk, wv, wo, heads, scale,
                                             partial)
        ctx.save_for_backward(x, wq, wk, wv, wo, q, k, v, oh)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        x, wq, wk, wv, wo, q, k, v, oh = ctx.saved_tensors
        h = ctx.heads
        g = g.to(x.dtype).contiguous()
        d_oh = torch.matmul(g, wo).contiguous()
        grads = fused_self_attention_backward(
            _heads(q, h), _heads(k, h), _heads(v, h), _heads(d_oh, h),
            ctx.scale)
        dq, dk, dv = (z.reshape(q.shape) for z in grads)
        dx = (torch.matmul(dq, wq) + torch.matmul(dk, wk)
              + torch.matmul(dv, wv))
        dws = [torch.matmul(_rows(dz).t(), _rows(src))
               for dz, src in ((dq, x), (dk, x), (dv, x), (g, oh))]
        return (dx, *dws, None, None, None)


def absorbed_self_attention(x: torch.Tensor, wq: torch.Tensor,
                            wk: torch.Tensor, wv: torch.Tensor,
                            wo: torch.Tensor, heads: int,
                            scale: float, partial: bool = False
                            ) -> torch.Tensor:
    """``to_out(attention(x Wqᵀ, x Wkᵀ, x Wvᵀ))`` without the ``to_out``
    bias, for ``x [B, T, C]`` and ``[C, C]`` weights in the ``Linear``
    layout (out, in), returned ``[B, T, C]`` in x's dtype. Shapes the JAX
    rule sends away take :func:`absorbed_attention_fallback`; the others K16
    (CUDA: bf16 or fp32, d a multiple of 8 up to 160) or
    :func:`absorbed_attention_reference` (CPU), with K2 (CUDA) or
    :func:`attention_backward_reference` (CPU) in the backward under
    autograd. ``absorbed_self_attention.launches`` counts K16's launches.

    ``partial`` (a model axis: ``heads`` of this rank, ``wq``/``wk``/``wv``
    its ``[ci, C]`` rows and ``wo`` its ``[C, ci]`` columns, ``ci =
    heads·d``): ``to_out``'s fp32 product over these heads alone, not
    rounded (``csrc/attention_fwd.cu:ldmseg_attention_absorbed`` with
    ``partial`` 1);
    the caller passes x through the model group's ``copy_to``, sums the
    ranks' partials in fp32 with its ``reduce_from`` and rounds once
    (``models/unet.py:CrossAttention``)."""
    b, t, c = x.shape
    ci = wq.shape[0]
    if not absorbed_takes_kernel(t, ci, heads):
        absorbed_self_attention.fallbacks += 1
        return absorbed_attention_fallback(x, wq, wk, wv, wo, heads, scale,
                                           partial)
    if torch.is_grad_enabled() and any(z.requires_grad
                                       for z in (x, wq, wk, wv, wo)):
        return _AbsorbedSelfAttention.apply(x, wq, wk, wv, wo, heads, scale,
                                            partial)
    return _absorbed_forward(x, wq, wk, wv, wo, heads, scale, partial)[0]


absorbed_self_attention.launches = 0
absorbed_self_attention.fallbacks = 0
