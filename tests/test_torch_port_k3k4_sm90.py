"""K3 and K4 on Hopper: the launch plans, the layouts and the rounding
points, on the CPU.

The TMA + ``wgmma`` kernels (``csrc/gemm_sm90.cuh``, K3's
``attn_s8_kernel_sm90`` in ``csrc/attention_ln_s8.cu``, K4's epilogues in
``csrc/geglu_ln_s8.cu``) run only on the card
(``tests/test_torch_port_k3k4_sm90_card.py`` holds them against their plain
versions there). What the CPU can pin:

* the launch plans, which ``ops/gemm.py:sm90_gemm_plan`` and
  ``ops/attention_s8.py:sm90_s8_attention_plan`` choose and the C entry
  points check: shared memory within a block's 232,448 bytes, TMA boxes of
  one 128-byte swizzle row (whole 16-byte units) and at most 256 rows,
  grids within the card's limits, and the plans' constants equal to the
  kernel sources';
* K3's head-padded q8/k8 scratch ``[B·T, H, dp]``: where the projection's
  epilogue puts each column (its per-column code), zero padding, equal
  scores;
* K3's attention stage: a blocked model of its arithmetic at the plan's
  key tile (pass 1 the int32 row max; pass 2 p = bf16(2^(float(s)·c −
  m·c)), l the fp32 sum of the rounded p, P·V in fp32, o = bf16(acc / l))
  against the plain version's steps (P equal to ``exp(s − rowmax)``
  rounded on all but ``P_FLIPS`` of the entries, each one bf16 ulp off at
  most: exp2 against exp moves p by a few fp32 ulps, which flips a
  rounding only next to a bf16 tie), and the block built on it against
  ``_attn_kernel_abs_padded_ln_s8_vt`` run with ``interpret=True``;
* K4's interior-scale slots under the products' tiling: the tiles run over
  the flat ``B·T`` rows, so one tile can hold rows of several images; each
  warp takes the amax of each 8-row group and folds it into that group's
  (image, 512-token block) slot. At T = 32, 128, 512 and 2048 each row's
  scale equals the amax per (image, ``block_t``) block that
  ``_geglu_ln_kernel`` takes (``geglu.py:_ff_interior``), and the block
  built on it is within the kernels' tolerance of that kernel run with
  ``interpret=True``.
"""

import functools
import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_tpu.ops.pallas import geglu as jgeglu  # noqa: E402
from ldmseg_torch.models.layers import LayerNorm  # noqa: E402
from ldmseg_torch.models.unet import CrossAttention  # noqa: E402
from ldmseg_torch.ops import attention as A  # noqa: E402
from ldmseg_torch.ops import attention_s8 as K3  # noqa: E402
from ldmseg_torch.ops import geglu as K4  # noqa: E402
from ldmseg_torch.ops import gemm as G  # noqa: E402
from ldmseg_torch.ops.quant import exact_int8_matmul  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "ldmseg_torch/csrc"
P_FLIPS = 2e-4
LOG2E = 1.4426950408889634
# (B, T, C) of K3's and K4's launches in one int8 UNet forward, the card
# tests' ragged ones, and a batch of one
SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280),
          (3, 120, 320), (1, 1920, 320), (1, 1024, 320), (3, 32, 640),
          (1, 8, 16), (8, 1920, 320)]
MAX_GRID = 65535


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _kernel_close(out, ref, mean_tol):
    """max |err| <= 1.6e-2 * max|ref| (two bf16 ulps: both sides round to
    bf16 and sum in another order), mean |err| <= ``mean_tol`` *
    mean|ref|."""
    err = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    assert err.max() <= 1.6e-2 * np.abs(ref).max(), err.max()
    assert err.mean() <= mean_tol * np.abs(ref).mean(), err.mean()


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------
def _products(b, t, c):
    """(rows, n, k, dtype, operands) of K3's and K4's products."""
    rows, m = b * t, 4 * c
    return [(rows, 3 * c, c, "int8", 1), (rows, c, c, "bfloat16", 1),
            (rows, m, c, "int8", 2), (rows, c, m, "int8", 1)]


@pytest.mark.parametrize("b,t,c", SHAPES)
def test_gemm_plans_fit_the_card(b, t, c):
    for rows, n, k, dtype, ops in _products(b, t, c):
        plan = G.sm90_gemm_plan(rows, n, k, dtype, ops)
        what = f"[{rows}, {k}] x [{n}, {k}]^T {dtype} x{ops}: {plan}"
        assert plan.smem_bytes <= G.SM90_SMEM_LIMIT, what
        assert plan.smem_bytes == G.gemm_smem_bytes(
            plan.block_m, plan.block_n, ops, plan.stages), what
        # a box row: one 128-byte swizzle row of whole 16-byte units; box
        # rows (block_m, block_n) within TMA's 256
        esize = 1 if dtype == "int8" else 2
        depth = G.ROW_BYTES // esize
        assert G.ROW_BYTES % 16 == 0 and (k * esize) % 16 == 0, what
        tiles = G.TILES + (G.TILES_TWO_OPERANDS if ops == 2 else ())
        assert (plan.block_m, plan.block_n) in tiles, what
        assert max(plan.block_m, plan.block_n) <= 256, what
        # 256 rows: four consumer warpgroups, 64 accumulators a thread
        assert plan.block_m < 256 or plan.block_n * ops <= 128, what
        assert plan.k_tiles == math.ceil(k / depth), what
        gx, gy = plan.grid
        assert (gx - 1) * plan.block_m < rows <= gx * plan.block_m, what
        assert (gy - 1) * plan.block_n < n <= gy * plan.block_n, what
        assert gy <= MAX_GRID, what
        assert 2 <= plan.stages <= G.MAX_STAGES, what
        assert plan.dtype == G.DTYPES[dtype] and plan.operands == ops


def test_gemm_plan_fills_the_card_and_refuses_what_tma_cannot_take():
    # the first level's up product: 256 x 64 tiles already give 320 blocks
    plan = G.sm90_gemm_plan(4096, 1280, 320, "int8", 2)
    assert (plan.block_m, plan.block_n, plan.grid) == (256, 64, (16, 20))
    # one operand: 128 x 128 at the first level's projection
    plan = G.sm90_gemm_plan(4096, 960, 320, "int8")
    assert (plan.block_m, plan.block_n, plan.grid) == (128, 128, (32, 8))
    # T = 32 (64 rows): the smallest tile, the most blocks
    plan = G.sm90_gemm_plan(64, 1280, 5120, "int8")
    assert (plan.block_m, plan.block_n, plan.grid) == (64, 64, (1, 20))
    for n, k, dtype in ((320, 40, "int8"), (12, 64, "bfloat16"),
                        (320, 4, "bfloat16")):
        assert not G.gemm_takes(n, k, dtype)
        with pytest.raises(ValueError):
            G.sm90_gemm_plan(64, n, k, dtype)
    with pytest.raises(ValueError):  # C % 16: x8's rows are a map's stride
        K3.ln_attention_plans(1, 64, 24, 3)
    with pytest.raises(ValueError):
        K4.geglu_plans(1, 64, 24, 96)


@pytest.mark.parametrize("d", list(range(8, 161, 8)))
def test_s8_attention_plans_fit_the_card(d):
    for bh in (1, 16, 24, 64):
        for t in (8, 32, 120, 128, 129, 512, 1024, 1920, 2048):
            plan = K3.sm90_s8_attention_plan(bh, t, d)
            what = f"(B*H, T, d) = ({bh}, {t}, {d}): {plan}"
            assert plan.smem_bytes <= G.SM90_SMEM_LIMIT, what
            assert plan.smem_bytes == K3.sm90_smem_bytes(
                plan.block_q, plan.block_k, plan.qk_chunks, plan.stages,
                plan.v_chunks), what
            assert d <= plan.head_class and plan.head_class % 8 == 0, what
            # the k32 steps of Q K^T cover the padded head, inside the
            # 128-column int8 boxes; V's 64-column bf16 boxes cover D
            steps = math.ceil(plan.head_class / 32)
            assert plan.dp <= 32 * steps <= 128 * plan.qk_chunks, what
            assert plan.dp % 32 == 0 and plan.dp - d < 32, what
            assert plan.head_class <= 64 * plan.v_chunks, what
            assert plan.block_k in (64, 128) and plan.block_q in (64, 128)
            tiles, heads = plan.grid
            assert heads == bh <= MAX_GRID, what
            assert (tiles - 1) * plan.block_q < t <= tiles * plan.block_q
            assert 2 <= plan.stages <= A.SM90_MAX_STAGES, what
            # K1's tiles at the same (B*H, T, class): one set of rules
            bf16 = A.sm90_launch_plan(bh, t, d)
            assert (plan.block_q, plan.block_k) == (bf16.block_q,
                                                    bf16.block_k), what


def test_plans_match_the_kernel_sources():
    """The C side reads the plans as ``gemm90::Plan`` and ``AttnPlan`` and
    checks them with its own copies of the limits and rules (the attention
    stage's in the skeleton it shares with K1, ``attention_sm90.cuh``)."""
    sm90 = (CSRC / "sm90.cuh").read_text()
    gemm = (CSRC / "gemm_sm90.cuh").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", gemm, re.S).group(1)
    assert re.findall(r"int (\w+);", body) == [
        "dtype", "block_m", "block_n", "operands", "stages", "k_tiles",
        "smem_bytes", "grid_x", "grid_y"]
    plan = G.sm90_gemm_plan(4096, 1280, 320, "int8", 2)
    assert list(G.plans_c(plan)) == list(plan.fields())
    assert f"kSmemLimit = {G.SM90_SMEM_LIMIT};" in sm90
    assert f"kRowBytes = {G.ROW_BYTES};" in sm90
    assert "using sm90::kSmemLimit;" in gemm
    assert G.COL_BYTES == 4 * 128 * 4
    assert "kColBytes = kMaxCols * 128 * 4;" in gemm
    assert "constexpr int kMaxCols = 4;" in gemm
    assert ("return 1024 + stages * (block_m + operands * block_n) * "
            "kRowBytes +\n         16 * stages + kColBytes;") in gemm
    attn = (CSRC / "attention_ln_s8.cu").read_text()
    skeleton = (CSRC / "attention_sm90.cuh").read_text()
    body = re.search(r"struct AttnPlan \{(.*?)\};", attn, re.S).group(1)
    assert re.findall(r"int (\w+);", body) == [
        "head_class", "block_q", "block_k", "stages", "qk_chunks",
        "v_chunks", "dp", "smem_bytes", "grid_x", "grid_y"]
    aplan = K3.sm90_s8_attention_plan(16, 2048, 40)
    assert list(aplan.fields()) == [
        40, 128, 128, aplan.stages, 1, 1, 64, aplan.smem_bytes, 16, 16]
    classes = re.search(r"kClasses\[\] = \{([\d, ]+)\}",
                        skeleton).group(1)
    assert tuple(int(c) for c in classes.split(",")) == \
        K3.SM90_HEAD_CLASSES
    assert "block_k == (cls <= 80 ? 128 : 64)" in skeleton
    assert "p.dp == (d + 31) / 32 * 32" in attn
    assert "return attn90::launch<K3Kernel>(a, stream);" in attn
    for c in K3.SM90_HEAD_CLASSES:
        assert f"case {c}: return launch_as<K, {c}, kWG>(a, stream);" in \
            skeleton
    # K3 passes 9 + 10 + 9 ints, K4 9 + 9, in the order the C side reads
    assert len(K3._ln_plans_c(2, 2048, 320, 8)) == 28
    assert len(K4._plans_c(2, 2048, 320, 1280)) == 18


def test_ablation_edits_still_match_the_kernel_sources():
    from ldmseg_torch.tools import ablate_int8_blocks as ablate
    for files in ablate.VARIANTS.values():
        for name, edits in files.items():
            src = (CSRC / name).read_text()
            assert ablate._edit(src, edits) != src


# ---------------------------------------------------------------------------
# K3: the head-padded q8/k8 and the attention stage
# ---------------------------------------------------------------------------
def qkv_column_code(col, c, d, dp):
    """Where QkvPadEpi puts projection column ``col`` (``col_int``'s
    code): its section (q, k, v) and its offset in a row of q8/k8 ``[H,
    dp]`` or of v ``[C]``."""
    which, cc = divmod(col, c)
    h = cc // d
    return which, (cc if which == 2 else h * dp + (cc - h * d))


def test_qkv_column_code_matches_the_epilogue_source():
    src = (CSRC / "attention_ln_s8.cu").read_text()
    assert ("return which << 28 | (which == 2 ? cc : h * dp + "
            "(cc - h * d));") in src
    assert "const int code = ci[0].x;" in src
    assert "static_cast<long long>(row) * heads * dp +" in src


@pytest.mark.parametrize("c,heads", [(320, 8), (640, 8), (1280, 8),
                                     (48, 6)])
def test_head_padded_q8_k8_are_zero_padded_and_score_the_same(c, heads):
    d = c // heads
    dp = K3.head_padded_width(d)
    assert dp == K3.sm90_s8_attention_plan(heads, 64, d).dp
    rows = 24
    rng = np.random.RandomState(c)
    q8 = rng.randint(-127, 128, (rows, c)).astype(np.int8)
    k8 = rng.randint(-127, 128, (rows, c)).astype(np.int8)
    # the epilogue's scatter into scratch whose padding starts as zeros
    # (on the card it is never read: TMA fills zeros past d)
    pad = {0: np.zeros((rows, heads * dp), np.int8),
           1: np.zeros((rows, heads * dp), np.int8)}
    for col in range(2 * c):
        which, off = qkv_column_code(col, c, d, dp)
        pad[which][:, off] = (q8 if which == 0 else k8)[:, col % c]
    qp, kp = (pad[i].reshape(rows, heads, dp) for i in (0, 1))
    assert not qp[..., d:].any() and not kp[..., d:].any()
    np.testing.assert_array_equal(qp[..., :d], q8.reshape(rows, heads, d))
    s_pad = np.einsum("qhd,khd->hqk", qp.astype(np.int64),
                      kp.astype(np.int64))
    s = np.einsum("qhd,khd->hqk", q8.reshape(rows, heads, d).astype(np.int64),
                  k8.reshape(rows, heads, d).astype(np.int64))
    np.testing.assert_array_equal(s_pad, s)
    # v keeps the [B·T, C] layout
    for col in range(2 * c, 3 * c):
        assert qkv_column_code(col, c, d, dp) == (2, col - 2 * c)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _attention_model(q8, k8, v, score_scale, block_k):
    """K3's attention stage on one head: q8, k8 int8 [T, d], v [T, d]
    holding bf16 values; returns (o rounded to bf16, the rounded P)."""
    t = q8.shape[0]
    c = np.float32(np.float32(score_scale) * np.float32(LOG2E))
    s32 = q8.astype(np.int64) @ k8.astype(np.int64).T
    m = np.full(t, np.iinfo(np.int32).min, np.int64)
    for k0 in range(0, t, block_k):          # pass 1: the int32 row max
        m = np.maximum(m, s32[:, k0:k0 + block_k].max(1))
    mc = np.float32(m.astype(np.float32) * c)
    acc = np.zeros((t, v.shape[1]), np.float32)
    l = np.zeros(t, np.float32)
    p_all = np.zeros((t, t), np.float32)
    for k0 in range(0, t, block_k):          # pass 2
        s = s32[:, k0:k0 + block_k].astype(np.float32)
        # fmaf(float(s), c, -mc): one rounding of the exact s c - mc
        arg = (s.astype(np.float64) * np.float64(c)
               - mc[:, None].astype(np.float64)).astype(np.float32)
        p = _bf16(np.exp2(arg))
        p_all[:, k0:k0 + block_k] = p
        l += p.sum(1, dtype=np.float32)
        acc += p @ v[k0:k0 + block_k]
    return _bf16(acc / l[:, None]), p_all


def _attention_case(seed, c, heads, w_std=0.2):
    rng = np.random.RandomState(seed)
    w = [rng.randn(c, c).astype(np.float32) * w_std for _ in range(4)]
    g1 = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    be1 = (0.1 * rng.randn(c)).astype(np.float32)
    bo = (0.05 * rng.randn(c)).astype(np.float32)
    norm = LayerNorm(c)
    attn = CrossAttention(c, heads)
    with torch.no_grad():
        norm.weight.copy_(_t(g1))
        norm.bias.copy_(_t(be1))
        for lin, wj in zip((attn.to_q, attn.to_k, attn.to_v, attn.to_out[0]),
                           w):
            lin.weight.copy_(_t(wj.T))  # JAX kernels are [in, out]
        attn.to_out[0].bias.copy_(_t(bo))
    *jw8, scales = jattn.quantize_head_weights(
        *(jnp.asarray(x) for x in w), heads)
    w8 = tuple(jnp.transpose(x, (1, 0, 2)).reshape(c, c)
               for x in jw8[:3]) + (jw8[3].reshape(c, c),)
    return rng, norm, attn, (g1, be1, bo), w8, scales


def _k3_model(x, p):
    """K3 built on the attention model: the plain version's LN, quantize,
    projections and to_out steps around ``_attention_model`` per (image,
    head) at the plan's key tile. Returns (out bf16, model P, plain P)."""
    b, t, c = x.shape
    h = p.heads
    d = c // h
    xf = torch.from_numpy(x)
    hn = K3._layer_norm(xf, p.ln_w, p.ln_b, p.eps)
    x8 = torch.round(hn / p.xs).clamp_(-127, 127).to(torch.int8)
    y = exact_int8_matmul(x8, p.w_qkv).float() * p.m_qkv
    q8, k8 = (torch.round(y[..., i * c:(i + 1) * c]).clamp_(-127, 127)
              .to(torch.int8).numpy() for i in range(2))
    v = y[..., 2 * c:].to(torch.bfloat16).float().numpy()
    block_k = K3.sm90_s8_attention_plan(b * h, t, d).block_k
    o = np.zeros((b, t, c), np.float32)
    p_model, p_plain = [], []
    for i in range(b):
        for j in range(h):
            cols = slice(j * d, (j + 1) * d)
            oh, ph = _attention_model(q8[i][:, cols], k8[i][:, cols],
                                      v[i][:, cols], p.score_scale, block_k)
            o[i][:, cols] = oh
            p_model.append(ph)
            s = (q8[i][:, cols].astype(np.int64)
                 @ k8[i][:, cols].astype(np.int64).T).astype(np.float32)
            s = s * np.float32(p.score_scale)
            p_plain.append(_bf16(np.exp(s - s.max(1, keepdims=True))))
    out = (xf + torch.from_numpy(o) @ p.wo.float().t()) + p.out_b
    return (out.to(torch.bfloat16).float().numpy(), np.stack(p_model),
            np.stack(p_plain))


def test_k3_attention_model_keeps_the_plain_rounding_point():
    b, t, heads, d = 2, 256, 2, 40
    c = heads * d
    rng, norm, attn, (g1, be1, bo), w8, scales = _attention_case(31, c,
                                                                 heads)
    x = rng.randn(b, t, c).astype(np.float32)
    act_scale = 0.04
    p = K3.pack_ln_attention(norm, attn, heads, act_scale)
    out, p_model, p_plain = _k3_model(x, p)
    assert K3.sm90_s8_attention_plan(b * heads, t, d).block_k == 128
    # P: the plain version's exp(s - rowmax) rounded, up to one ulp where
    # exp2 lands next to a bf16 tie
    diff = p_model != p_plain
    assert diff.mean() <= P_FLIPS, diff.mean()
    ulp = np.abs(p_plain).astype(np.float32) * 2.0 ** -7
    assert np.all(np.abs(p_model - p_plain)[diff] <= ulp[diff] + 1e-30)
    # the block on it against the TPU kernel in interpret mode (whose
    # softmax has a static offset instead of the row max, hence the plain
    # version's own mean tolerance, tests/test_torch_port_int8.py)
    pack = jattn.pack_padded_ln_vt_tiles(
        *w8, scales, heads, d ** -0.5, act_scale, jnp.asarray(g1),
        jnp.asarray(be1), jnp.asarray(bo))
    ref = jattn._abs_padded_ln_s8_vt_impl(
        jnp.asarray(x), pack["wqp"], pack["wkp"], pack["wvt"], pack["wo"],
        pack["m"], pack["g"], pack["sc"], heads, 1e-6, interpret=True)
    _kernel_close(out, np.asarray(ref, np.float32), mean_tol=2.5e-3)
    # and against the plain version it replaces
    _kernel_close(out, K3.ln_attention_s8_reference(_t(x), p).float()
                  .numpy(), mean_tol=2.5e-3)


def test_k3_attention_model_masks_a_ragged_last_key_tile():
    rng = np.random.RandomState(5)
    t, d = 200, 40                       # 128 + 72 keys
    # codes of the spread K3's requantize gives (as = 0.1): scores of a
    # few units after the scale as^2 d^-0.5
    q8, k8 = (rng.randint(-40, 41, (t, d)).astype(np.int8) for _ in "qk")
    v = _bf16(rng.randn(t, d))
    scale = 0.01 * d ** -0.5
    o, p_model = _attention_model(q8, k8, v, scale, 128)
    s = (q8.astype(np.int64) @ k8.astype(np.int64).T).astype(np.float32)
    s = s * np.float32(scale)
    e = _bf16(np.exp(s - s.max(1, keepdims=True)))
    assert (p_model != e).mean() <= P_FLIPS
    ref = _bf16((e @ v) / e.sum(1, keepdims=True))
    assert np.abs(o - ref).max() <= 1.6e-2 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# K4: the interior-scale slots under the products' tiling
# ---------------------------------------------------------------------------
def slot_of(row, t, block_t):
    """K4's (image, block_t-token block) slot of flat token row ``row``."""
    img = row // t
    return img * (t // block_t) + (row - img * t) // block_t


def test_slot_lookup_matches_the_kernel_source():
    src = (CSRC / "geglu_ln_s8.cu").read_text()
    assert ("  const int img = row / t;\n"
            "  return img * (t / block_t) + (row - img * t) / block_t;"
            ) in src
    # the up product's epilogue folds each 8-row group into its slot
    gemm = (CSRC / "gemm_sm90.cuh").read_text()
    assert "epi.row_max(group0 + 8 * r, v);" in gemm
    assert "atomicMax(amax + slot_of(row, t, block_t)" in src


def _geglu_case(seed, c, m):
    rng = np.random.RandomState(seed)
    norm = LayerNorm(c)
    proj_in = torch.nn.Linear(c, 2 * m)
    proj_out = torch.nn.Linear(m, c)
    with torch.no_grad():
        norm.weight.copy_(_t(1.0 + 0.1 * rng.randn(c)))
        norm.bias.copy_(_t(0.1 * rng.randn(c)))
        proj_in.weight.copy_(_t(rng.randn(2 * m, c) * 0.1))
        proj_in.bias.copy_(_t(rng.randn(2 * m) * 0.05))
        proj_out.weight.copy_(_t(rng.randn(c, m) * 0.1))
        proj_out.bias.copy_(_t(rng.randn(c) * 0.05))
    return rng, norm, proj_in, proj_out


def _k4_model(x, p):
    """K4 on the products' tiling: the up product's tiles over the flat
    B·T rows (the plan's block_m), each warp's 8-row groups folded into
    their slots by a max, the row's scale looked up from its slot, then
    the quantize, the down product and the residual. Returns (out bf16,
    the rows' scales, g)."""
    b, t, c = x.shape
    m = p.w2.shape[1]
    rows = b * t
    block_t = min(K4.BLOCK_T, t)
    xf = torch.from_numpy(x).reshape(rows, c)
    hn = K3._layer_norm(xf, p.ln_w, p.ln_b, p.eps)
    x8 = torch.round(hn / p.xs).clamp_(-127, 127).to(torch.int8)
    u = exact_int8_matmul(x8, p.w1).float()
    xss = p.xs * p.s1                               # staged per column
    uh = u[:, :m] * xss[:m] + p.b1[:m]
    ug = u[:, m:] * xss[m:] + p.b1[m:]
    g = uh * K4.gelu_tanh(ug)
    plan = G.sm90_gemm_plan(rows, m, c, "int8", operands=2)
    slots = np.zeros(b * (t // block_t), np.float32)
    ga = g.abs().numpy()
    for m0 in range(0, rows, plan.block_m):         # a tile's row range
        for n0 in range(0, m, plan.block_n):
            for g0 in range(m0, min(m0 + plan.block_m, rows), 8):
                group = ga[g0:g0 + 8, n0:n0 + plan.block_n]
                assert len({slot_of(r, t, block_t)
                            for r in range(g0, g0 + 8)}) == 1
                s = slot_of(g0, t, block_t)
                slots[s] = max(slots[s], group.max())
    gs = np.maximum(slots, 1e-6) / np.float32(127.0)
    row_gs = torch.from_numpy(np.array(
        [gs[slot_of(r, t, block_t)] for r in range(rows)], np.float32))
    g8 = torch.round(g / row_gs[:, None]).clamp_(-127, 127).to(torch.int8)
    y = exact_int8_matmul(g8, p.w2).float() * row_gs[:, None]
    out = ((xf + y * p.s2) + p.b2).to(torch.bfloat16)
    return out.float().numpy().reshape(b, t, c), row_gs.numpy(), g


@functools.lru_cache(maxsize=None)
def _interpreted_geglu_ln(b, t, c, m, seed):
    rng, norm, proj_in, proj_out = _geglu_case(seed, c, m)
    x = rng.randn(b, t, c).astype(np.float32)
    x[:, ::97, 0] += 9.0                  # some rows far from the others
    act_scale = 0.08
    p = K4.pack_geglu(norm, proj_in, proj_out, act_scale)
    w1q = jnp.asarray(p.w1.numpy().T)
    w2q = jnp.asarray(p.w2.numpy().T)
    s1, b1, s2, b2, lw, lb = (jnp.asarray(v.numpy()) for v in
                              (p.s1, p.b1, p.s2, p.b2, p.ln_w, p.ln_b))
    tiles = jgeglu.pack_geglu_ln_tiles(s1, b1, s2, b2, lw, lb, act_scale,
                                       None)
    bt = min(512, t)
    ref = pl.pallas_call(
        functools.partial(jgeglu._geglu_ln_kernel, eps=1e-6,
                          static_g=False),
        grid=(b, t // bt),
        in_specs=[
            pl.BlockSpec((1, bt, c), lambda i, j: (i, j, 0)),
            pl.BlockSpec(w1q.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(w2q.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(tiles["s1t"].shape, lambda i, j: (0, 0)),
            pl.BlockSpec(tiles["s2t"].shape, lambda i, j: (0, 0)),
            pl.BlockSpec(tiles["g"].shape, lambda i, j: (0, 0)),
            pl.BlockSpec((8, 128), lambda i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, bt, c), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(x), w1q, w2q, tiles["s1t"], tiles["s2t"], tiles["g"],
      tiles["sc"])
    return x, p, np.asarray(ref, np.float32)


@pytest.mark.parametrize("t", [32, 128, 512, 2048])
def test_k4_slots_under_the_tiling_match_the_kernels_blocks(t):
    b, c, m = 2, 16, 64
    x, p, ref = _interpreted_geglu_ln(b, t, c, m, seed=13)
    out, row_gs, g = _k4_model(x, p)
    # each row's scale: max(amax over its (image, block_t) block, 1e-6) /
    # 127, the block _geglu_ln_kernel's grid step quantizes with
    bt = min(512, t)
    blocks = g.abs().reshape(b, t // bt, bt * m).amax(-1)
    want = (blocks.clamp_min(1e-6) / 127.0).repeat_interleave(bt, dim=1)
    np.testing.assert_array_equal(row_gs, want.reshape(-1).numpy())
    if t > bt:   # the case tells one amax per block from one per image
        assert len(set(row_gs[:t].tolist())) > 1
    # the block built on it: the plain version's arithmetic, and within
    # the kernels' tolerance of the TPU kernel in interpret mode (the mean
    # tolerance of tests/test_torch_port_int8.py's K4 case)
    np.testing.assert_array_equal(
        out, K4.geglu_ln_s8_reference(_t(x), p).float().numpy())
    _kernel_close(out, ref, mean_tol=1e-3)
