"""K9's ``proj_out`` and K7 on Hopper's product (``csrc/gemm_sm90.cuh``),
on the CPU.

- K7 (``csrc/gn_silu_conv.cu``): :func:`conv_taps_model`, the kernels'
  decomposition in plain PyTorch (y padded channel-last, nine shifted row
  slices of the flattened scratch, stages of 64 channels, split-K partials
  summed in the kernel's order, the halo positions dropped), against
  ``fused_gn_silu_conv``'s Pallas kernel in interpret mode and its XLA
  twin ``_reference`` at 4x8, 8x16 and widths that are not multiples of
  16, and against the port's plain version in bf16;
  :func:`sm90_conv_plan` at the UNet's 43 halves against a transcription of
  the C entry's checks; the weight pack against ``w.permute(0, 2, 3, 1)``
  and its cache.
- K9: :func:`pout_swapped_model`, the ``proj_out`` product with its
  operands swapped as the kernel runs it, on K4's plain output against the
  Pallas kernel ``_geglu_ln_pout_kernel`` in interpret mode and its
  epilogue's own product; :func:`pout_plan` at the int8 path's shapes.
- The wmma product is gone: no source names it.

The JAX functions take NHWC and HWIO, the port NCHW and OIHW: the tests
transpose at the boundary; inputs are made with numpy from a seed.
"""

import dataclasses
import functools
import gc
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ldmseg_tpu.ops.pallas import geglu as jgeglu  # noqa: E402
from ldmseg_tpu.ops.pallas import gn_silu_conv as jgc  # noqa: E402
from ldmseg_torch.ops import geglu as G  # noqa: E402
from ldmseg_torch.ops import gemm as GM  # noqa: E402
from ldmseg_torch.ops import gn_silu_conv as K7  # noqa: E402
from ldmseg_torch.ops.attention import SM90_SMEM_LIMIT, SM90_SMS  # noqa
from ldmseg_torch.tools.profile_gn import site_shapes  # noqa: E402

from test_torch_port_int8 import (  # noqa: E402
    _geglu_case, _jax_operands, _kernel_close, _t)
from test_torch_port_k9k7_sm90_card import (  # noqa: E402
    K7_RAGGED, K7_SITES, K9_PATH, K9_RAGGED, conv_taps_model,
    pout_swapped_model)
from test_torch_port_padded_kernels import _conv, _jax_proj  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "ldmseg_torch" / "csrc"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _max_close(out, ref, tol):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


def _conv_case(seed, b, h, w, c, co):
    """NHWC x with a non-zero mean, GN scale and shift, HWIO w and b."""
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.randn(b, h, w, c) + 0.5).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    wk = (rng.randn(3, 3, c, co) / np.sqrt(9 * c)).astype(np.float32)
    bk = (0.1 * rng.randn(co)).astype(np.float32)
    return x, scale, bias, wk, bk


def _port_args(x, scale, bias, wk, bk):
    return (_nchw(x), _t(scale), _t(bias),
            torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1))),
            _t(bk))


def _pallas_k7(x, scale, bias, wk, bk, groups):
    b, h, w, c = x.shape
    co = wk.shape[-1]
    return pl.pallas_call(
        functools.partial(jgc._kernel, groups=groups, eps=1e-5),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((c,), lambda i: (0,)),
                  pl.BlockSpec((c,), lambda i: (0,)),
                  pl.BlockSpec((3, 3, c, co), lambda i: (0, 0, 0, 0)),
                  pl.BlockSpec((co,), lambda i: (0,))],
        out_specs=pl.BlockSpec((1, h, w, co), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, w, co), jnp.float32),
        scratch_shapes=[pltpu.VMEM((h + 2, w + 2, c), jnp.float32),
                        pltpu.VMEM((h, w + 2, co), jnp.float32)],
        interpret=True,
    )(*(jnp.asarray(a) for a in (x, scale, bias, wk, bk)))


# (B, H, W, Cin, Cout, groups): 4x8, 8x16, widths 12 and 7 (not multiples
# of 16; 7 odd), Cin 40 and 72 (not multiples of 64), Cout not of 128, Cin
# 36 (not a multiple of 8: rows of 40 channels, 9 a group)
K7_CASES = [(2, 4, 8, 64, 24, 8), (1, 8, 16, 32, 16, 4),
            (2, 5, 12, 40, 24, 8), (1, 6, 7, 72, 8, 8), (1, 6, 8, 36, 16, 4)]


# ---------------------------------------------------------------------------
# K7: the decomposition
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", K7_CASES)
def test_k7_model_matches_pallas_kernel_in_interpret_mode(case):
    b, h, w, c, co, g = case
    x, scale, bias, wk, bk = _conv_case(sum(case), b, h, w, c, co)
    ref = np.asarray(_pallas_k7(x, scale, bias, wk, bk, g))
    xla = np.asarray(jgc._reference(*(jnp.asarray(a) for a in
                                      (x, scale, bias, wk, bk)), g, 1e-5))
    args = _port_args(x, scale, bias, wk, bk)
    plan = K7.sm90_conv_plan(b, c, co, h, w, g)
    assert plan.splits > 1   # small grids: the split path
    out = conv_taps_model(*args, g, 1e-5, plan)
    assert out.shape == (b, co, h, w) and out.dtype == torch.float32
    got = out.permute(0, 2, 3, 1).numpy()
    # fp32: the same zero padding of y (not of x) and the same nine taps,
    # summed in another order than the TPU kernel's nine shifted products
    # (and the GN sums in another order than _reference's)
    _max_close(got, ref, 1e-4)
    _max_close(got, xla, 1e-4)
    # one split: the same sums up to their order
    one = conv_taps_model(*args, g, 1e-5, dataclasses.replace(plan,
                                                              splits=1))
    _max_close(one.permute(0, 2, 3, 1).numpy(), got, 1e-5)


@pytest.mark.parametrize("case", K7_CASES)
def test_k7_model_in_bf16_matches_plain_version(case):
    b, h, w, c, co, g = case
    x, scale, bias, wk, bk = _conv_case(sum(case) + 1, b, h, w, c, co)
    xb, sc, bi, wb, bb = _port_args(x, scale, bias, wk, bk)
    xb, wb = xb.to(torch.bfloat16), wb.to(torch.bfloat16)
    plan = K7.sm90_conv_plan(b, c, co, h, w, g)
    out = conv_taps_model(xb, sc, bi, wb, bb, g, 1e-5, plan)
    ref = K7.gn_silu_conv_reference(xb, sc, bi, wb, bb, g, 1e-5)
    assert out.dtype == ref.dtype == torch.bfloat16
    # the same bf16 y and products, fp32 sums in another order, each
    # rounded once to bf16: within two bf16 ulps of max|ref| (the card's
    # gate, GN_CONV_TOL, is 2e-2)
    _max_close(out.float().numpy(), ref.float().numpy(), 1.6e-2)


def test_k7_split_ranges_cover_the_stages_in_order():
    for (b, c, h, w), co, _ in K7_SITES:
        plan = K7.sm90_conv_plan(b, c, co, h, w, 32)
        ranges = plan.split_ranges()
        assert len(ranges) == plan.splits
        assert [kt for lo, hi in ranges for kt in range(lo, hi)] == list(
            range(plan.gemm.k_tiles))
        assert all(hi > lo for lo, hi in ranges)


# ---------------------------------------------------------------------------
# K7: the plan against the C entry's checks
# ---------------------------------------------------------------------------
def _gemm_plan_ok(p, rows, n, k):
    """``gemm_sm90.cuh:plan_ok`` for one bf16 operand on one map."""
    return (p.dtype == 1 and p.block_m in (64, 128)
            and p.block_n in (64, 128) and p.operands == 1
            and 2 <= p.stages <= 8 and p.k_tiles == -(-k // 64)
            and p.smem_bytes == GM.gemm_smem_bytes(p.block_m, p.block_n, 1,
                                                   p.stages)
            and p.smem_bytes <= SM90_SMEM_LIMIT
            and p.grid == (-(-rows // p.block_m), -(-n // p.block_n))
            and n >= 8 and n % 8 == 0 and (k * 2) % 16 == 0)


def _taps_ok(plan, b, cin, cout, h, w, groups, aligned=True):
    """``gn_silu_conv.cu``: ``taps_ok``, the entry's and
    ``launch_gemm_taps``' checks."""
    rows_per_cta = plan.rows_per_cta
    ctas = min(8, -(-(cin // groups * h * w) // K7.PAD_VALUES))
    n = -(-b * (h + 2) * plan.wp // 8) * 8
    c8 = -(-cin // 8) * 8
    return (cin >= 1 and cin % groups == 0 and plan.cin8 == c8
            and (9 * c8 * 2) % 16 == 0 and (c8 * 2) % 16 == 0
            and plan.wp == w + 1 + (w + 1) % 2
            and plan.cblocks == -(-cin // 64)
            and rows_per_cta == -(-h // ctas)
            and 1 <= plan.cluster <= 8
            and plan.cluster == -(-h // rows_per_cta)
            and (plan.vec == 1 or (plan.vec == 8 and w % 8 == 0 and aligned))
            and 1 <= plan.chunk_ch <= cin // groups
            and 1 <= plan.chunk_pix <= rows_per_cta * w
            and plan.pad_smem == plan.chunk_ch * (plan.chunk_pix + 2) * 2
            and plan.pad_smem <= K7.PAD_SMEM_LIMIT
            and plan.gemm.k_tiles == 9 * plan.cblocks
            and 1 <= plan.splits <= plan.gemm.k_tiles
            and plan.positions == b * (h + 2) * plan.wp
            and plan.positions <= n == plan.n
            and _gemm_plan_ok(plan.gemm, cout, n, 64 * plan.gemm.k_tiles))


def test_k7_plan_at_the_unet_halves():
    sites = site_shapes()
    taken = [(s, co) for s, co in sites
             if K7.takes_kernel(torch.empty(s, device="meta"), co,
                                K7.MAX_TILE_BYTES)]
    assert len(sites) == 44 and len(taken) == 43
    counts = {}
    for s, co in taken:
        counts[(s, co)] = counts.get((s, co), 0) + 1
    assert counts == {(s, co): n for s, co, n in K7_SITES}
    for (b, c, h, w), co in taken:
        plan = K7.sm90_conv_plan(b, c, co, h, w, 32)
        assert _taps_ok(plan, b, c, co, h, w, 32), plan
        assert (plan.gemm.block_m, plan.gemm.block_n) == K7.CONV_TILE
        blocks = plan.gemm.grid[0] * plan.gemm.grid[1]
        assert plan.splits == max(1, min(SM90_SMS // blocks,
                                         plan.gemm.k_tiles))
        assert blocks * plan.splits <= SM90_SMS or plan.splits == 1
        assert plan.launches == 2 + (plan.splits > 1) <= 3
        assert plan.vec == 8
        assert len(plan.fields()) == 18
        # x read once: the CTA's slice is one chunk
        assert (plan.chunk_ch, plan.chunk_pix) == (c // 32,
                                                   plan.rows_per_cta * w)
        assert plan.cin8 == c
    # the deep levels split, the first level does not
    deep = K7.sm90_conv_plan(2, 1280, 1280, 4, 8, 32)
    assert deep.splits == 13 and deep.launches == 3
    assert K7.sm90_conv_plan(2, 320, 320, 32, 64, 32).splits == 1


@pytest.mark.parametrize("shape,cout,groups", K7_RAGGED)
def test_k7_plan_at_ragged_shapes(shape, cout, groups):
    b, c, h, w = shape
    for aligned in (True, False):
        plan = K7.sm90_conv_plan(b, c, cout, h, w, groups, aligned)
        assert _taps_ok(plan, b, c, cout, h, w, groups, aligned), plan
        assert plan.vec == (8 if aligned and w % 8 == 0 else 1)


def test_k7_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):          # Cin % groups
        K7.sm90_conv_plan(1, 36, 16, 6, 8, 8)
    for bad in range(6):                     # a non-positive dimension
        args = [1, 64, 16, 6, 8, 4]
        args[bad] = 0
        with pytest.raises(ValueError):
            K7.sm90_conv_plan(*args)


# ((B, Cin, H, W), Cout, groups, cin8, chunk, x_reads): the shapes JAX's
# kernel takes that the plan refused before (Cin 36 in 4 groups; a CTA's
# slice of 320 channels x 8 rows of 64, 329 KB), a row of 2,048 in one
# group, and a group wider than a chunk of 64 pixels holds
K7_REPAIRED = [((2, 36, 32, 64), 64, 4, 40, (9, 704), 1),
               ((2, 320, 64, 64), 320, 1, 320, (320, 312), 2),
               ((1, 64, 1, 2048), 16, 1, 64, (64, 1592), 2),
               ((1, 12000, 1, 16), 8, 1, 12000, (5688, 16), 2)]


@pytest.mark.parametrize("shape,cout,groups,cin8,chunk,x_reads", K7_REPAIRED)
def test_k7_plan_takes_what_jax_takes(shape, cout, groups, cin8, chunk,
                                      x_reads):
    b, c, h, w = shape
    # JAX's dispatch sends it to its Pallas kernel (the 6 MiB rule)
    assert K7.takes_kernel(torch.empty(shape, device="meta"), cout,
                           K7.MAX_TILE_BYTES)
    plan = K7.sm90_conv_plan(b, c, cout, h, w, groups)
    assert _taps_ok(plan, b, c, cout, h, w, groups), plan
    assert plan.cin8 == cin8 and (plan.chunk_ch, plan.chunk_pix) == chunk
    # x read once when the CTA's slice is one chunk, else twice
    one_chunk = plan.chunk_ch * plan.chunk_pix == c // groups * (
        plan.rows_per_cta * w)
    assert x_reads == (1 if one_chunk else 2) and len(plan.fields()) == 18
    # every chunk's pixels start on a 16-byte load and pairs of channels
    # stay pairs
    assert plan.chunk_pix % 8 == 0 or plan.chunk_pix == plan.rows_per_cta * w
    assert plan.chunk_ch == c // groups or plan.chunk_ch % 2 == 0


def test_k7_c_checks_are_the_ones_transcribed():
    src = (CSRC / "gn_silu_conv.cu").read_text()
    for rule in ("t.wp == w + 1 + (w + 1) % 2",
                 "t.cblocks == (cin + 63) / 64",
                 "t.k == (h + t.rows_per_cta - 1) / t.rows_per_cta",
                 "t.rows_per_cta == (h + ctas - 1) / ctas",
                 "(span + kPadValues - 1) / kPadValues",
                 "t.pad_smem == t.chunk_ch * (t.chunk_pix + 2) * 2",
                 "t.chunk_ch == ch && t.chunk_pix == pix",
                 "pix = (static_cast<int>(kVals) / cg - 2) / 8 * 8;",
                 "ch -= ch % 2;",
                 "const int c8 = (cin + 7) / 8 * 8;",
                 "plan[5] != 9 * t.cblocks"):
        assert rule in src, rule
    gemm = (CSRC / "gemm_sm90.cuh").read_text()
    assert "splits > p.k_tiles" in gemm
    assert "w_ld < w_cols" in gemm and "(w_ld * 2) % 16 != 0" in gemm
    assert "plan_ok(p, false, rows, n, 64 * p.k_tiles, 1)" in gemm


# ---------------------------------------------------------------------------
# K7: the weight pack and its cache
# ---------------------------------------------------------------------------
def test_pack_conv_weight_is_the_permuted_weight():
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(24, 40, 3, 3).astype(np.float32))
    pack = K7.pack_conv_weight(w)
    assert pack.dtype == torch.bfloat16 and pack.shape == (24, 9 * 40)
    assert pack.is_contiguous()
    assert torch.equal(pack, w.permute(0, 2, 3, 1).reshape(24, -1).to(
        torch.bfloat16))
    # tap (dy, dx) of output o is the Cin weights at [o, (3 dy + dx) Cin:]
    assert torch.equal(pack[5, (3 * 2 + 1) * 40:(3 * 2 + 2) * 40],
                       w[5, :, 2, 1].to(torch.bfloat16))
    # Cin 36: each tap's 36 weights, then 4 zeros (rows of 40 channels)
    w36 = w[:, :36]
    pack = K7.pack_conv_weight(w36)
    assert pack.shape == (24, 9 * 40)
    taps = pack.reshape(24, 9, 40)
    assert torch.equal(taps[..., :36], w36.permute(0, 2, 3, 1).reshape(
        24, 9, 36).to(torch.bfloat16))
    assert not taps[..., 36:].any()


def test_packed_weight_is_made_once_per_version():
    w = torch.nn.Parameter(torch.randn(8, 16, 3, 3))
    first = K7.packed_weight(w)
    assert K7.packed_weight(w) is first
    with torch.no_grad():
        w.add_(1.0)                          # a new version
    second = K7.packed_weight(w)
    assert second is not first
    assert torch.equal(second, K7.pack_conv_weight(w))
    key = (id(w), K7.pack_conv_weight)
    assert key in K7._PACKS
    del w, first, second
    gc.collect()
    assert key not in K7._PACKS              # dropped with its weight
    with torch.inference_mode():
        wi = torch.randn(8, 16, 3, 3)
        assert K7.packed_weight(wi) is not K7.packed_weight(wi)


def test_padded_width_pairs_positions():
    for w in range(1, 80):
        wp = K7.padded_width(w)
        assert wp % 2 == 0 and w + 1 <= wp <= w + 2
    # the UNet's widths keep two zero columns, one between two rows
    assert [K7.padded_width(w) for w in (64, 32, 16, 8)] == [66, 34, 18, 10]


# ---------------------------------------------------------------------------
# K9: the swapped proj_out
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("static", [False, True])
def test_k9_swapped_model_matches_pallas_kernel_in_interpret_mode(static):
    b, t, c, m = 2, 16, 64, 128
    rng, norm, proj_in, proj_out = _geglu_case(12, c, m)
    conv = _conv(rng, c)
    x = rng.randn(b, t, c).astype(np.float32)
    act_scale, g_scale = 0.08, (0.02 if static else None)
    p = G.with_proj_out(G.pack_geglu(norm, proj_in, proj_out, act_scale,
                                     g_scale), conv)
    w1q, w2q, (s1, b1, s2, b2, lw, lb) = _jax_operands(p)
    wpo, bpo = _jax_proj(conv, jnp.bfloat16)
    tiles = jgeglu.pack_geglu_ln_tiles(s1, b1, s2, b2, lw, lb, act_scale,
                                       g_scale, proj_out_bias=bpo)
    ref = pl.pallas_call(
        functools.partial(jgeglu._geglu_ln_pout_kernel, eps=1e-6,
                          static_g=static),
        grid=(b, 1),
        in_specs=[
            pl.BlockSpec((1, t, c), lambda i, j: (i, j, 0)),
            pl.BlockSpec(w1q.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(w2q.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(wpo.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(tiles["s1t"].shape, lambda i, j: (0, 0)),
            pl.BlockSpec(tiles["s2t"].shape, lambda i, j: (0, 0)),
            pl.BlockSpec(tiles["g"].shape, lambda i, j: (0, 0)),
            pl.BlockSpec((8, 128), lambda i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, t, c), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(x), w1q, w2q, wpo, tiles["s1t"], tiles["s2t"],
      tiles["g"], tiles["sc"])
    ref = np.asarray(ref, np.float32)
    r = G.geglu_ln_s8_reference(_t(x), p)
    plan = G.pout_plan(b, t, c)
    out = pout_swapped_model(r, p.wpo, p.bpo, plan, b, t)
    assert out.shape == (b, c, t) and out.dtype == torch.bfloat16
    # K4's tolerance (tests/test_torch_port_int8.py): the tanh gelu and the
    # sums in another order move a rare interior code
    _kernel_close(out.transpose(1, 2).float().numpy(), ref)
    # the TPU kernel's epilogue on the same r: r·wpo + b in fp32, rounded
    # once; the swapped product's 64-deep stages sum in another order
    epi = (jax.lax.dot_general(jnp.asarray(r.float().numpy(), jnp.bfloat16),
                               wpo, (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
           + bpo).astype(jnp.bfloat16)
    got = out.transpose(1, 2).float().numpy()
    _max_close(got, np.asarray(epi, np.float32), 2 ** -7)
    # and the port's plain version: one bf16 ulp of max|ref| at most
    _max_close(got, G.geglu_ln_s8_pout_reference(_t(x), p).float().numpy(),
               2 ** -7)


@pytest.mark.parametrize("b,t,c", K9_PATH + K9_RAGGED)
def test_k9_pout_plan(b, t, c):
    plan = G.pout_plan(b, t, c)
    # rows: output channels, columns: tokens; a pair of columns is two
    # tokens of one image (T even)
    assert _gemm_plan_ok(plan, c, b * t, c)
    assert t % 2 == 0
    assert all(col // t == (col + 1) // t for col in range(0, b * t, 2))
    # the smallest tile, the most blocks; the deepest ring up to
    # DEEP_STAGES, no deeper than k, with which every block is resident
    assert (plan.block_m, plan.block_n) == G.POUT_TILE == min(GM.TILES)
    blocks = plan.grid[0] * plan.grid[1]

    def resident(s):
        return SM90_SMS * (GM.SM90_SMEM_PER_SM // (
            GM.gemm_smem_bytes(*G.POUT_TILE, 1, s) + GM.SM90_SMEM_RESERVED))
    deepest = max(2, min(GM.DEEP_STAGES, plan.k_tiles))
    fits = [s for s in range(2, deepest + 1) if resident(s) >= blocks]
    assert plan.stages == (max(fits) if fits else deepest)
    assert plan.smem_bytes <= SM90_SMEM_LIMIT
    # the int8 path: three 4-stage blocks an SM at T = 2048 (320 blocks),
    # two 6-stage ones at T = 512 (160), one 8-stage one at T = 128 and 32
    want = {(2048, 320): 4, (512, 640): 6, (128, 1280): 8, (32, 1280): 8}
    if b == 2 and (t, c) in want:
        assert plan.stages == want[(t, c)]


# ---------------------------------------------------------------------------
# the wmma product is gone
# ---------------------------------------------------------------------------
def test_no_source_names_the_wmma_product():
    for path in sorted(CSRC.glob("*.cu*")):
        src = path.read_text()
        assert not re.search(r"wmma::|bf16_gemm_kernel|launch_bf16_gemm|"
                             r"<mma\.h>", src), path.name
    assert "ProjOutEpi" in (CSRC / "geglu_ln_s8.cu").read_text()
    assert "launch_gemm_taps" in (CSRC / "gn_silu_conv.cu").read_text()
