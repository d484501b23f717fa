"""K16's projections and K8's ``proj_in`` prologue on the Hopper product
(``csrc/gemm_sm90.cuh``), without the card.

K16's Q, K and V projections run as one launch over three weight maps, each
column tile taking its map and its destination (q, k or v) from its column
block; its ``to_out`` and K8's prologue are the same product with one map,
the prologue's A read channel-major (the GroupNorm's ``[B, C, T]``) through
a 3-D map in tiles laid out per image. The kernels run only on the card
(``tests/test_torch_port_k16k8_sm90_card.py``); here the launch plans
(``ops/gemm.py:sm90_gemm_plan`` with ``maps`` and ``images``), numpy models
of the column routing and of the per-image row tiles, a blocked fp32 model
of the prologue against the plain version's, and the names the stage split
reads. About 5 s on one core:

    python -m pytest tests/test_torch_port_k16k8_sm90.py -p no:randomly
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ldmseg_torch.ops import attention as A
from ldmseg_torch.ops import attention_s8 as S8
from ldmseg_torch.ops import gemm as G

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "ldmseg_torch/csrc"

# (B, T, C) of K16's calls: the sampling forward (batch 2, 32x64 latent)
# and the training forward (batch 8, 24x80; T = 30 falls back), as
# chip_smoke.py's K14_SHAPES and K14_TRAIN_SHAPES
K16_SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280),
              (8, 1920, 320), (8, 480, 640), (8, 120, 1280)]
# K8's token counts: the sampling path's and the 24x80 KITTI latent's
K8_TOKENS = [(2048, 320), (512, 640), (128, 1280), (32, 1280),
             (1920, 320), (480, 640), (120, 1280)]
# a blocked fp32 sum against torch's: the products of bf16 values are
# exact in fp32, the sums run in another order (k <= 1,280 terms of |x w|
# <= ~4: a few fp32 ulps of max|ref|)
FP32_ORDER_TOL = 1e-5


def _tiles_of(plan):
    return plan.block_m, plan.block_n


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,c", K16_SHAPES)
def test_three_map_plan_tiles_divide_c_and_cover_qkv(b, t, c):
    rows = b * t
    plan = G.sm90_gemm_plan(rows, 3 * c, c, "bfloat16", maps=3)
    bm, bn = _tiles_of(plan)
    assert c % bn == 0                       # no column tile cut short
    assert plan.smem_bytes <= G.SM90_SMEM_LIMIT
    assert plan.smem_bytes == G.gemm_smem_bytes(bm, bn, 1, plan.stages)
    gx, gy = plan.grid
    assert gx * bm >= rows > (gx - 1) * bm   # every row, no empty tile
    assert gy == 3 * (c // bn)               # every column of q, k and v
    assert plan.k_tiles == -(-c // 64)
    # the K16 entry reads K1's plan, this one and to_out's, 27 ints
    k1, qkv, out = A.absorbed_plans(b, t, c, 8)
    assert k1 == A.sm90_launch_plan(b * 8, t, c // 8)
    assert qkv == plan
    assert out == G.sm90_gemm_plan(rows, c, c, "bfloat16")
    assert list(A._absorbed_plans_c(b, t, c, 8)) == [
        *k1.fields(), *qkv.fields(), *out.fields()]


def test_three_map_plan_keeps_the_tiles_where_none_divides():
    # C = 80 (2 heads of 40): no width divides it; the last tile of each
    # map is cut short and masked
    plan = G.sm90_gemm_plan(64, 240, 80, "bfloat16", maps=3)
    assert plan.grid[1] == 3 * -(-80 // plan.block_n)
    with pytest.raises(ValueError):
        G.sm90_gemm_plan(64, 250, 80, "bfloat16", maps=3)   # n % maps
    with pytest.raises(ValueError):
        G.sm90_gemm_plan(64, 240, 80, "int8", images=2)     # bf16 only


def test_one_map_one_image_plans_are_unchanged():
    # the default form is the plan K3, K4, K11 and K17 read
    for rows, n, k, dt, ops in ((4096, 960, 320, "int8", 1),
                                (256, 10240, 1280, "int8", 2),
                                (1024, 640, 640, "bfloat16", 1)):
        p = G.sm90_gemm_plan(rows, n, k, dt, ops)
        assert p.grid == (-(-rows // p.block_m), -(-n // p.block_n))
        assert p == G.sm90_gemm_plan(rows, n, k, dt, ops, maps=1, images=1)


def test_plan_rules_match_the_kernel_source():
    gemm = (CSRC / "gemm_sm90.cuh").read_text()
    assert ("p.grid_x == images * ((image_rows + p.block_m - 1) / "
            "p.block_m)") in gemm
    assert ("p.grid_y == maps * ((map_cols + p.block_n - 1) / p.block_n)"
            in gemm)
    assert "const int per_map = (map_cols + kBN - 1) / kBN;" in gemm
    assert "const int wmap = blockIdx.y / per_map;" in gemm
    assert "const int wn0 = (blockIdx.y - wmap * per_map) * kBN;" in gemm
    assert "const int per_image = (t + 64 * kWG - 1) / (64 * kWG);" in gemm
    # K16's entry reads 27 ints, K8's 37 (its prologue's, then K3's 28)
    assert len(A._absorbed_plans_c(2, 2048, 320, 8)) == 27
    assert len(S8._pin_plans_c(2, 32, 1280, 8, True)) == 37
    assert list(S8._pin_plans_c(2, 32, 1280, 8, False))[9:] == list(
        S8._ln_plans_c(2, 32, 1280, 8))


# ---------------------------------------------------------------------------
# K16: the column tiles' routing
# ---------------------------------------------------------------------------
def column_code(col, c):
    """``StoreBf16Epi::col_int``: the column's output (q, k, v) and its
    offset in that output's row."""
    which = col // c
    return which, col - which * c


def test_column_code_matches_the_epilogue_source():
    src = (CSRC / "attention_fwd.cu").read_text()
    assert ("    const int which = col / c;\n"
            "    return which << 28 | (col - which * c);") in src
    assert "which == 0 ? out0 : which == 1 ? out1 : out2;" in src
    assert "(ci[0].x & ((1 << 28) - 1))" in src


def routing(grid_y, bn, n, maps):
    """The kernel's column tiles as (map, first column in the map, first
    output column, the map's end) per blockIdx.y."""
    map_cols = n // maps
    per_map = -(-map_cols // bn)
    for y in range(grid_y):
        wmap = y // per_map
        wn0 = (y - wmap * per_map) * bn
        yield wmap, wn0, wmap * map_cols + wn0, wmap * map_cols + map_cols


@pytest.mark.parametrize("b,t,c", K16_SHAPES + [(1, 64, 80), (1, 64, 64)])
def test_each_column_of_q_k_v_is_written_once_from_its_own_weight(b, t, c):
    plan = G.sm90_gemm_plan(b * t, 3 * c, c, "bfloat16", maps=3)
    bn = plan.block_n
    written = np.zeros((3, c), np.int64)
    for wmap, wn0, n0, col_end in routing(plan.grid[1], bn, 3 * c, 3):
        assert 0 <= wmap < 3
        for cc in range(bn):
            col = n0 + cc
            if col >= col_end:        # past the map's columns: masked
                continue
            which, off = column_code(col, c)
            # the tile reads W_wmap's row wn0 + cc: the destination's
            # column is that weight's output column
            assert (which, off) == (wmap, wn0 + cc)
            written[which, off] += 1
    assert (written == 1).all()


# ---------------------------------------------------------------------------
# K8: the prologue's per-image row tiles over channel-major x
# ---------------------------------------------------------------------------
def row_tiles(b, t, bm):
    """The kernel's row tiles over channel-major x (kAMN): (image, first
    token, first output row, the image's end) per blockIdx.x."""
    per_image = -(-t // bm)
    for x in range(b * per_image):
        img = x // per_image
        tm0 = (x - img * per_image) * bm
        yield img, tm0, img * t + tm0, img * t + t


@pytest.mark.parametrize("t,c", K8_TOKENS)
def test_per_image_row_tiles_cover_each_token_once(t, c):
    for b in (1, 2, 8):
        plan = S8.proj_in_plan(b, t, c, True)
        bm = plan.block_m
        assert plan.grid == G.gemm_grid(b * t, c, bm, plan.block_n, 1, b)
        covered = np.zeros(b * t, np.int64)
        for img, tm0, m0, row_end in row_tiles(b, t, bm):
            assert 0 <= tm0 < t and row_end - m0 <= t
            rows = np.arange(m0, m0 + bm)
            rows = rows[rows < row_end]          # past t: masked
            assert (rows // t == img).all()      # no tile crosses an image
            covered[rows] += 1
        assert (covered == 1).all()
        assert plan.grid[0] == sum(1 for _ in row_tiles(b, t, bm))


def _bf16(rng, shape, scale=1.0):
    x = torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))
    return x.to(torch.bfloat16)


def blocked_prologue(x_bct, wpi, bpi, bm):
    """The prologue as the kernel computes it on channel-major x [B, C, T]:
    per row tile of its image, per 64-channel stage, a box of 64 tokens x
    64 channels per 64 rows (zeros past T and C: TMA's fill), fp32 sums of
    the stages in order, then + bpi, stored for the rows inside the
    image."""
    b, c, t = x_bct.shape
    x = x_bct.float().numpy()
    w = wpi.float().numpy()
    kt = -(-c // 64)
    xp = np.zeros((b, kt * 64, -(-t // bm) * bm), np.float32)
    xp[:, :c, :t] = x
    wp = np.zeros((c, kt * 64), np.float32)
    wp[:, :c] = w
    out = np.full((b * t, c), np.nan, np.float32)
    for img, tm0, m0, row_end in row_tiles(b, t, bm):
        acc = np.zeros((bm, c), np.float32)
        for k in range(kt):
            box = xp[img, 64 * k:64 * k + 64, tm0:tm0 + bm]   # [64 ch, bm]
            acc += box.T @ wp[:, 64 * k:64 * k + 64].T
        valid = min(bm, row_end - m0)
        out[m0:m0 + valid] = acc[:valid] + bpi.numpy()
    return out


@pytest.mark.parametrize("t,c", K8_TOKENS)
def test_blocked_prologue_equals_the_plain_xf(t, c):
    b = 2
    rng = np.random.RandomState(t + c)
    # a narrower C with a tail past the last 64 channels keeps the model
    # fast; the row tiles are the path plan's
    cn = 136
    x_bct = _bf16(rng, (b, cn, t))
    wpi = _bf16(rng, (cn, cn), cn ** -0.5)
    bpi = torch.from_numpy(rng.randn(cn).astype(np.float32) * 0.1)
    bm = S8.proj_in_plan(b, t, c, True).block_m
    got = blocked_prologue(x_bct, wpi, bpi, bm)
    # ln_attention_s8_pin_reference's prologue on the tokens view
    x = x_bct.transpose(1, 2)
    ref = (x.float() @ wpi.float().t() + bpi).reshape(b * t, cn)
    assert not np.isnan(got).any()
    err = np.abs(got - ref.numpy()).max()
    assert err <= FP32_ORDER_TOL * ref.abs().max().item()


def test_proj_in_f32_on_the_cpu_is_the_plain_prologue():
    rng = np.random.RandomState(3)
    b, t, c = 2, 24, 48
    pack = S8.LNAttentionPack(
        heads=8, eps=1e-5, xs=0.1, score_scale=0.1, ln_w=None, ln_b=None,
        out_b=None, w_qkv=None, m_qkv=None, wo=None, wo_q=None,
        w_scale=None, wpi=_bf16(rng, (c, c)), wpi_f=None,
        bpi=torch.from_numpy(rng.randn(c).astype(np.float32)))
    x = _bf16(rng, (b, c, t)).transpose(1, 2)
    ref = (x.float() @ pack.wpi.float().t() + pack.bpi).reshape(b * t, c)
    assert torch.equal(S8.proj_in_f32(x, pack), ref)
    with pytest.raises(ValueError):
        S8.proj_in_f32(x.float(), pack)


# ---------------------------------------------------------------------------
# the stage split and the wmma product's last caller
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kid,name,stage", [
    ("K16", "gemm_kernel<false, 64, 1, StoreBf16Epi, 3, false>", "qkv"),
    ("K16", "gemm_kernel<false, 128, 2, StoreBf16Epi, 3, false>", "qkv"),
    ("K16", "attention_fwd_kernel_sm90<40, 2>", "attention"),
    ("K16", "gemm_kernel<false, 64, 1, StoreBf16Epi, 1, false>", "to_out"),
    ("K16", "bf16_gemm_kernel<false, StoreBf16Epi>", "other"),
    ("K8", "gemm_kernel<false, 64, 1, BiasF32Epi, 1, true>", "proj_in"),
    ("K8", "gemm_kernel<false, 128, 2, BiasF32Epi, 1, false>", "proj_in"),
    ("K8", "bf16_gemm_kernel<true, BiasF32Epi>", "other"),
    ("K8", "ln_quant_kernel<float, true>", "ln_quant"),
    ("K8", "gemm_kernel<true, 128, 2, QkvPadEpi, 1, false>", "qkv"),
    ("K8", "attn_s8_kernel_sm90<48, 2>", "attention"),
    ("K8", "gemm_kernel<false, 64, 1, ResidualEpi<float>, 1, false>",
     "to_out"),
])
def test_stages_name_the_new_kernels_and_not_the_wmma_product(kid, name,
                                                              stage):
    from ldmseg_torch.tools.profile_int8_blocks import by_stage, short_name
    full = (f"void gemm90::{name}(CUtensorMap_st, gemm90::WMaps<3>, int)"
            if name.startswith("gemm_kernel") else f"void {name}(int)")
    assert by_stage(kid, {short_name(full): 1.0}) == {stage: 1.0}


def test_profile_families_split_the_bf16_products():
    from ldmseg_torch.tools.profile_sampling import FAMILIES

    def family(name):
        return next(f for f, pat in FAMILIES if re.search(pat, name))
    assert family("void gemm90::gemm_kernel<false, 64, 1, (anonymous "
                  "namespace)::StoreBf16Epi, 3, false>(...)").startswith(
                      "K8/K16 bf16 products")
    assert family("void gemm90::gemm_kernel<false, 64, 1, (anonymous "
                  "namespace)::BiasF32Epi, 1, true>(...)").startswith(
                      "K8/K16 bf16 products")
    assert family("void s8::bf16_gemm_kernel<(anonymous namespace)::"
                  "ChannelMajorBiasEpi>(...)").startswith("K9 proj_out")


def test_k16_ablation_edit_still_matches_the_source():
    from ldmseg_torch.tools import ablate_attention_fwd as ablate
    src = (CSRC / "attention_fwd.cu").read_text()
    out = ablate.k16_variants(src)
    assert out["one launch"] == src != out["three launches"]


def test_the_wmma_product_has_one_caller_left():
    callers = [p.name for p in sorted(CSRC.glob("*.cu"))
               if "launch_bf16_gemm" in p.read_text()]
    assert callers == ["geglu_ln_s8.cu"]
    assert "s8_common.cuh" not in (CSRC / "attention_fwd.cu").read_text()
