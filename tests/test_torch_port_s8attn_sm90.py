"""K13's attention stage on Hopper and the products of K11 and K17 on
``gemm_sm90.cuh``: the launch plans, the layouts and the rounding points, on
the CPU.

The kernels (``csrc/attention_s8.cu``: ``attn_s8pv_kernel_sm90`` on the
skeleton of ``csrc/attention_sm90.cuh`` with an s8 e8·V product, the
quantize passes, the products' epilogues; ``gemm_heads_kernel`` of
``csrc/gemm_sm90.cuh``) run only on the card
(``tests/test_torch_port_s8attn_sm90_card.py``). What the CPU can pin:

* the plans (``sm90_s8pv_attention_plan`` and the products'
  ``sm90_gemm_plan``) within the card's limits at every (B·H, T, d) of the
  four int8 paths (K13, K15, K11, K17) and ragged T;
* the e8·V product's N classes: widths that ``.s8`` ``wgmma`` takes, equal
  to the kernel source's;
* the transposed ``v8t [B, H, d, tp]`` that each producer writes (the
  quantize pass of K13 and K15, K11's swapped V projection, K17's group
  quantize), with the keys of every 16 permuted so that a thread's score
  registers are the 8-bit A fragment: numpy models of their index math give
  v8ᵀ per head, zeros past T and d, and the int32 e8·V equal to the plain
  ``e8 @ v8`` bit for bit;
* a blocked model of the stage at the plan's key tile (pass 1 the int32
  row max; pass 2 e = 2^(((s·sc0 − m) + ln 127)·log2 e), l the fp32 sum of
  the unrounded e, e8 = rint(e)) against the plain version's steps: e8 equal
  to ``round(exp((s − rowmax) + ln 127))`` on all but ``E8_FLIPS`` of the
  entries, each one code off at most (exp2 of the rounded argument against
  exp moves e by a few fp32 ulps, which flips a code only next to a half);
  the denominators within 1e-6; a ragged last key tile masked;
* K17's amax slots under its projection's tiling (8-row groups folded per
  column group into each (image, head) slot) equal to the per-(image, head)
  ``[T, d]`` amax at T = 32, 120, 128 and 2048;
* ``head_out``'s per-head promotion (the head-padded product, each head's
  int32 sums promoted in fp32, h = 0 first) bit-equal to the plain
  version's sum;
* K13, K11 and K17 built on these models within the kernels' tolerance of
  ``_attn_kernel_s8``, ``_attn_kernel_abs_padded_s8`` and
  ``_attn_kernel_absorbed_s8`` run with ``interpret=True``.
"""

import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_torch.ops import attention as A  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops import gemm as G  # noqa: E402
from ldmseg_torch.ops.quant import exact_int8_matmul  # noqa: E402

from test_torch_port_absorbed_kernels import (  # noqa: E402
    _case, _k17_pallas, _port_head_codes)
from test_torch_port_int8 import (  # noqa: E402
    _attention_case, _kernel_close, _t)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "ldmseg_torch/csrc"
E8_FLIPS = 2e-4
LOG2E = np.float32(1.4426950408889634)
LN127 = np.float32(S8.LN127)
HEADS = 8
# (B, T, C) of the four int8 paths' launches in one UNet forward (batch 2,
# 32x64 latent, 8 heads), ragged T (120, 30, 24) and a batch of one
SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280),
          (3, 120, 320), (2, 30, 640), (3, 24, 1280), (1, 120, 1280),
          (1, 8, 64)]
# the widths .s8 wgmma takes: 8, 16, 24, then multiples of 16 to 256
S8_N = {8, 16, 24} | set(range(32, 257, 16))


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,c", SHAPES)
def test_s8pv_plans_fit_the_card(b, t, c):
    d = c // HEADS
    plan = S8.sm90_s8pv_attention_plan(b * HEADS, t, d)
    what = f"(B*H, T, d) = ({b * HEADS}, {t}, {d}): {plan}"
    assert plan.smem_bytes <= G.SM90_SMEM_LIMIT, what
    assert plan.smem_bytes == S8.s8pv_smem_bytes(
        plan.block_q, plan.block_k, plan.qk_chunks, plan.head_class,
        plan.stages), what
    assert d <= plan.head_class in S8_N, what
    # Q K^T's k32 steps cover the padded head inside the 128-column boxes;
    # a V^T box is one swizzle row of keys by head_class <= 256 rows
    steps = math.ceil(plan.head_class / 32)
    assert plan.dp <= 32 * steps <= 128 * plan.qk_chunks, what
    assert plan.dp % 32 == 0 and plan.dp - d < 32, what
    assert plan.tp % 16 == 0 and 0 <= plan.tp - t < 16, what
    assert plan.head_class <= 256 and S8.S8PV_BOX_KEYS == 128
    # the V^T box at a tile's first key covers the tile's keys
    assert plan.block_k <= S8.S8PV_BOX_KEYS and plan.block_k % 32 == 0
    tiles, bh = plan.grid
    assert bh == b * HEADS <= 65535, what
    assert (tiles - 1) * plan.block_q < t <= tiles * plan.block_q, what
    assert 2 <= plan.stages <= A.SM90_MAX_STAGES, what
    # K1's tile rules at the same (B*H, T): one skeleton, one set of rules
    bf16 = A.sm90_launch_plan(b * HEADS, t, d)
    assert (plan.block_q, plan.block_k) == (bf16.block_q, bf16.block_k)
    # the products around it, where the rule sends the shape to a kernel
    if t % 8 == 0:
        for p in (*S8.padded_attention_plans(b, t, c, HEADS)[:2],
                  S8.padded_attention_plans(b, t, c, HEADS)[3],
                  *S8.absorbed_s8_plans(b, t, c, HEADS)[::2]):
            assert p.smem_bytes <= G.SM90_SMEM_LIMIT and p.grid[1] <= 65535


def test_s8pv_classes_are_s8_wgmma_widths_and_the_sources():
    skeleton = (CSRC / "attention_sm90.cuh").read_text()
    sm90 = (CSRC / "sm90.cuh").read_text()
    attn = (CSRC / "attention_s8.cu").read_text()
    classes = re.search(r"kS8Classes\[\] = \{([\d, ]+)\}", skeleton).group(1)
    assert tuple(int(c) for c in classes.split(",")) == \
        S8.S8PV_HEAD_CLASSES
    assert set(S8.S8PV_HEAD_CLASSES) <= S8_N
    assert 40 not in S8_N                  # the bf16 class of d = 40
    for c in S8.S8PV_HEAD_CLASSES:
        assert f"struct WgmmaRsS8<{c}> {{" in sm90
        assert f"m64n{c}k32.s32.s8.s8" in sm90
        assert (f"case {c}: return attn_as<{c}, kWG, kOut>(p, maps, o, so, "
                f"heads, t, d, sc, stream);") in attn
    # the plan the C side reads, in its order, and its checks
    body = re.search(r"struct AttnPlan \{(.*?)\};", attn, re.S).group(1)
    assert re.findall(r"int (\w+);", body) == [
        "head_class", "block_q", "block_k", "stages", "qk_chunks", "dp",
        "tp", "smem_bytes", "grid_x", "grid_y"]
    plan = S8.sm90_s8pv_attention_plan(16, 2048, 40)
    assert list(plan.fields()) == [48, 128, 128, plan.stages, 1, 64, 2048,
                                   plan.smem_bytes, 16, 16]
    assert "p.tp == (t + 15) / 16 * 16" in attn
    assert ("return 1024 + block_q * qk_chunks * kRowBytes +\n"
            "         stages * (block_k * qk_chunks + cls) * kRowBytes +\n"
            "         8 * (1 + 2 * stages);") in skeleton
    # K13 passes one plan, K11 four, K17 three
    assert len(S8._s8pv_plan_c(16, 2048, 40)) == 10
    assert len(S8._padded_plans_c(2, 2048, 320, 8)) == 37
    assert len(S8._absorbed_plans_c(2, 2048, 320, 8)) == 28
    with pytest.raises(ValueError):        # C % 16
        S8.padded_attention_plans(1, 64, 24, 3)


def test_ablation_edits_still_match_the_kernel_sources():
    from ldmseg_torch.tools import ablate_int8_blocks as ablate
    for files in ablate.VARIANTS.values():
        for name, edits in files.items():
            src = (CSRC / name).read_text()
            assert ablate._edit(src, edits) != src


# ---------------------------------------------------------------------------
# the permuted key order: the score registers are the 8-bit A fragment
# ---------------------------------------------------------------------------
def byte_perm(x, y, sel):
    """CUDA's ``__byte_perm``: byte n of the result is byte (sel >> 4n) &
    7 of the eight bytes of y:x."""
    src = (y << 32 | x).to_bytes(8, "little")
    return int.from_bytes(bytes(src[(sel >> (4 * n)) & 7] for n in range(4)),
                          "little")


def test_code_and_score_conversions_are_exact():
    # float(S) as (S + 1.5 2^23) - 1.5 2^23 for |S| <= 160 * 127^2 < 2^22,
    # and the code as the low byte of e + 1.5 2^23 (round half to even)
    magic = np.float32(12582912.0)
    s = np.array([0, 1, -1, 160 * 127 * 127, -160 * 127 * 127, 12345,
                  -2 ** 22 + 1], np.int64)
    bits = (s + 0x4B400000).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(bits - magic, s.astype(np.float32))
    e = np.array([0.0, 0.49999997, 0.5, 1.5, 2.5, 126.5, 127.00001, 63.7],
                 np.float32)
    low = (e + magic).view(np.uint32) & 0xFF
    np.testing.assert_array_equal(low, np.rint(e).astype(np.uint32))
    skeleton = (CSRC / "attention_sm90.cuh").read_text()
    assert ("__fsub_rn(__int_as_float(s[i] + 0x4B400000), kMagic);"
            in skeleton)
    assert "s[i] = __float_as_int(__fadd_rn(e, kMagic));" in skeleton


def test_key_order_makes_the_score_registers_the_a_fragment():
    q = np.arange(16)
    keys = S8.key_of_position(q)
    assert sorted(keys) == list(range(16))
    # VtEpi's inverse: key 2a + 8c + e sits at 4a + 2c + e
    np.testing.assert_array_equal(
        4 * ((keys >> 1) & 3) + 2 * ((keys >> 3) & 1) + (keys & 1), q)
    # pack8: register 4kk + r of a 32-key step takes the score registers
    # 16kk + 2 (r % 2) + 8 (r / 2) + {0, 1, 4, 5}; score register i of lane
    # l holds row (i / 2) % 2 (+8), key 8 (i / 4) + 2 (l % 4) + (i % 2)
    # (the accumulator layout); A register r holds row r % 2 (+8), depth
    # 16 (r / 2) + 4 (l % 4) + byte. The depth's key must be that key.
    for lane in range(32):
        for r in range(4):
            for byte, off in enumerate((0, 1, 4, 5)):
                i = 2 * (r % 2) + 8 * (r // 2) + off
                assert (i // 2) % 2 == r % 2          # the same row
                key = 8 * (i // 4) + 2 * (lane % 4) + (i % 2)
                depth = 16 * (r // 2) + 4 * (lane % 4) + byte
                assert (depth // 16) * 16 + S8.key_of_position(
                    depth % 16) == key
    skeleton = (CSRC / "attention_sm90.cuh").read_text()
    assert "const int i = 16 * kk + 2 * (r % 2) + 8 * (r / 2);" in skeleton
    # bytes [s[i], s[i + 1], s[i + 4], s[i + 5]], each score register's
    # byte 0 (its code), in depth order
    assert ("p[4 * kk + r] = __byte_perm(\n"
            "            __byte_perm(s[i], s[i + 1], 0x0040),\n"
            "            __byte_perm(s[i + 4], s[i + 5], 0x0040), 0x5410);"
            ) in skeleton
    assert byte_perm(byte_perm(0x11, 0x22, 0x0040),
                     byte_perm(0x33, 0x44, 0x0040), 0x5410) == 0x44332211
    attn = (CSRC / "attention_s8.cu").read_text()
    assert ("return 2 * ((q >> 2) & 3) + (q & 1) + 8 * ((q >> 1) & 1);"
            in attn)
    assert ("const int pos = (tok & ~15) + 4 * ((q >> 1) & 3) + 2 * (q >> 3)"
            " + (q & 1);") in attn


# ---------------------------------------------------------------------------
# the producers of v8t
# ---------------------------------------------------------------------------
def vt_tile(codes, t0, t, tp):
    """``vt_word`` over a 64-token tile: positions [t0, min(t0 + 64, tp))
    of one head column whose codes by token are ``codes`` [T]."""
    out = {}
    for q4 in range(0, 64, 4):
        if t0 + q4 >= tp:
            continue
        for e in range(4):
            q = q4 + e
            key = (q & ~15) + int(S8.key_of_position(q & 15))
            out[t0 + q] = codes[t0 + key] if t0 + key < t else 0
    return out


def quant_pass_v8t(v8):
    """quant_qkv_kernel's v8t [B, H, d, tp] from v's codes [B, T, H, d]:
    one 64-token tile per block, each column's positions by vt_word."""
    b, t, h, d = v8.shape
    tp = S8.padded_keys(t)
    out = np.full((b, h, d, tp), 99, np.int8)   # what no store writes
    for i in range(b):
        for j in range(h):
            for col in range(d):
                for t0 in range(0, t, 64):
                    for pos, val in vt_tile(v8[i, :, j, col], t0, t,
                                            tp).items():
                        out[i, j, col, pos] = val
    return out


def v_projection_v8t(v8_rows, b, t, heads, tp):
    """VtEpi's stores: v8 [B·T, C] (the swapped product's sums,
    requantized) at v8t + row·tp + col_int(col), row the channel, col the
    token of B·T; returns v8t [B, H, d, tp] (positions past T zero, as the
    wrapper allocates it)."""
    rows, c = v8_rows.shape
    flat = np.zeros(b * c * tp, np.int8)
    for col in range(0, rows, 2):          # a column pair: two tokens
        bi, tok = divmod(col, t)
        q = tok & 15
        pos = (tok & ~15) + 4 * ((q >> 1) & 3) + 2 * (q >> 3) + (q & 1)
        code = bi * c * tp + pos
        for ch in range(c):
            flat[ch * tp + code] = v8_rows[col, ch]
            flat[ch * tp + code + 1] = v8_rows[col + 1, ch]
    return flat.reshape(b, heads, c // heads, tp)


def _check_v8t(v8t, v8):
    """v8t holds v8 [B, T, H, d] per head with keys permuted, zeros past T
    and d; e8·V over its positions equals the plain e8 @ v8."""
    b, t, h, d = v8.shape
    tp = v8t.shape[-1]
    pos = np.arange(tp)
    keys = (pos & ~15) + S8.key_of_position(pos & 15)
    for i in range(b):
        for j in range(h):
            inside = keys < t
            np.testing.assert_array_equal(v8t[i, j][:, inside],
                                          v8[i, keys[inside], j].T)
            assert not v8t[i, j][:, ~inside].any()
            # a TMA box reads zeros past d; the e8 of keys past T are 0
            e8 = np.random.RandomState(i + j).randint(0, 128, (5, t))
            e8_pos = np.zeros((5, tp), np.int64)
            e8_pos[:, inside] = e8[:, keys[inside]]
            np.testing.assert_array_equal(
                e8_pos @ v8t[i, j].T.astype(np.int64),
                e8 @ v8[i, :, j].astype(np.int64))


@pytest.mark.parametrize("b,t,h,d", [(2, 32, 2, 16), (1, 120, 2, 40),
                                     (2, 24, 3, 8), (1, 200, 1, 16)])
def test_quant_pass_writes_v8t_per_head(b, t, h, d):
    v8 = np.random.RandomState(t + d).randint(-127, 128, (b, t, h, d)).astype(
        np.int8)
    _check_v8t(quant_pass_v8t(v8), v8)


@pytest.mark.parametrize("b,t,c,heads", [(2, 32, 64, 4), (3, 24, 32, 2),
                                         (1, 120, 48, 3)])
def test_v_projection_writes_v8t_per_head(b, t, c, heads):
    rng = np.random.RandomState(b + t)
    v8_rows = rng.randint(-127, 128, (b * t, c)).astype(np.int8)
    v8t = v_projection_v8t(v8_rows, b, t, heads, S8.padded_keys(t))
    _check_v8t(v8t, v8_rows.reshape(b, t, heads, c // heads))


@pytest.mark.parametrize("b,t,c,heads", [(2, 32, 64, 4), (1, 120, 128, 2)])
def test_group_quant_writes_v8t_per_head(b, t, c, heads):
    # group_quant_kernel's part 2: 64-token x 64-column tiles of y's v
    # columns, each column's positions by vt_word into v8t [B, C, tp]
    rng = np.random.RandomState(c)
    v8_rows = rng.randint(-127, 128, (b * t, c)).astype(np.int8)
    tp = S8.padded_keys(t)
    flat = np.full((b, c, tp), 99, np.int8)
    for i in range(b):
        for c0 in range(0, c, 64):
            for t0 in range(0, t, 64):
                for col in range(c0, min(c0 + 64, c)):
                    codes = v8_rows[i * t:(i + 1) * t, col]
                    for pos, val in vt_tile(codes, t0, t, tp).items():
                        flat[i, col, pos] = val
    _check_v8t(flat.reshape(b, heads, c // heads, tp),
               v8_rows.reshape(b, t, heads, c // heads))
    src = (CSRC / "attention_s8.cu").read_text()
    assert "v8t + (static_cast<long long>(b) * c + c0 + col) * tp + t0 + q4)" \
        in src


# ---------------------------------------------------------------------------
# the attention stage
# ---------------------------------------------------------------------------
def _f32(x):
    return np.asarray(x, np.float32)


def stage_model(q8, k8, v8t, sc0, block_k):
    """The stage on one head: q8, k8 int8 [T, d], v8t [d, tp] as the
    producers write it; returns (o32 int64 [T, d], l [T], e8 [T, T])."""
    t = q8.shape[0]
    tp = v8t.shape[1]
    sc0 = np.float32(sc0)
    s32 = q8.astype(np.int64) @ k8.astype(np.int64).T
    m = np.full(t, np.iinfo(np.int32).min, np.int64)
    for k0 in range(0, t, block_k):          # pass 1: the int32 row max
        m = np.maximum(m, s32[:, k0:k0 + block_k].max(1))
    mf = _f32(_f32(m) * sc0)
    l = np.zeros(t, np.float32)
    e8 = np.zeros((t, tp), np.int64)
    for k0 in range(0, tp, block_k):         # pass 2, by tile
        keys = np.arange(k0, min(k0 + block_k, tp))
        s = np.zeros((t, len(keys)), np.int64)
        inside = keys < t
        s[:, inside] = s32[:, keys[inside]]
        sf = _f32(_f32(s) * sc0)
        arg = _f32(_f32(_f32(sf - mf[:, None]) + LN127) * LOG2E)
        e = np.exp2(arg).astype(np.float32)
        e[:, ~inside] = 0.0                   # the ragged tile's mask
        l += e.sum(1, dtype=np.float32)
        e8[:, keys] = np.rint(e)
    pos = np.arange(tp)
    keys = (pos & ~15) + S8.key_of_position(pos & 15)
    e8_pos = np.zeros_like(e8)
    ok = keys < t
    e8_pos[:, ok] = e8[:, keys[ok]]
    o32 = e8_pos @ v8t.T.astype(np.int64)
    return o32, l, e8[:, :t]


def _plain_codes(q8, k8, sc0):
    """The plain version's e and codes (attention_s8_reference's steps)."""
    s = exact_int8_matmul(torch.from_numpy(q8), torch.from_numpy(k8)).float()
    s = s * torch.tensor(np.float32(sc0))
    e = torch.exp((s - s.amax(-1, keepdim=True)) + S8.LN127)
    return e.sum(-1).numpy(), torch.round(e).to(torch.int64).numpy()


@pytest.mark.parametrize("t,d", [(256, 40), (200, 40), (120, 160),
                                 (30, 80)])
def test_stage_model_keeps_k13s_rounding_point(t, d):
    rng = np.random.RandomState(t + d)
    # codes of the spread the paths' quantize gives; scores of a few units
    q8, k8, v8 = (rng.randint(-60, 61, (t, d)).astype(np.int8)
                  for _ in "qkv")
    sc0 = np.float32(1e-3 * 40 / d)
    block_k = S8.sm90_s8pv_attention_plan(16, t, d).block_k
    v8t = quant_pass_v8t(v8[None, :, None])[0, 0]
    o32, l, e8 = stage_model(q8, k8, v8t, sc0, block_k)
    denom, codes = _plain_codes(q8, k8, sc0)
    flips = e8 != codes
    assert flips.mean() <= E8_FLIPS, flips.mean()
    assert np.abs(e8 - codes).max() <= 1
    np.testing.assert_allclose(l, denom, rtol=1e-6)
    np.testing.assert_array_equal(o32, e8 @ v8.astype(np.int64))
    # the cases with a ragged last key tile, whose keys past T the mask
    # takes out of l and e8
    assert (t % block_k != 0) == (t in (200, 120, 30))


def k13_model(q, k, v, scale, act_scale):
    """K13 on the models: the wrapper's quantize, quant_qkv's v8t and the
    stage per head with the bf16 epilogue. q, k, v float [B, T, H, d]."""
    b, t, h, d = q.shape
    s_ = np.float32(act_scale)
    q8, k8, v8 = (np.clip(np.rint(_f32(x) / s_), -127, 127).astype(np.int8)
                  for x in (q, k, v))
    sc0 = _f32(_f32(s_ * s_) * np.float32(scale))
    num = _f32(_f32(s_ / np.float32(127.0)) * np.float32(127.0))
    v8t = quant_pass_v8t(v8)
    block_k = S8.sm90_s8pv_attention_plan(b * h, t, d).block_k
    out = np.zeros((b, t, h, d), np.float32)
    for i in range(b):
        for j in range(h):
            o32, l, _ = stage_model(q8[i, :, j], k8[i, :, j], v8t[i, j], sc0,
                                    block_k)
            f = _f32(num / l)
            out[i, :, j] = _f32(_f32(o32) * f[:, None])
    return torch.from_numpy(out).to(torch.bfloat16).float().numpy()


def test_k13_model_matches_pallas_kernel_in_interpret_mode():
    bh, t, d, bq = 2, 64, 40, 32
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(bh, t, 1, d).astype(np.float32) for _ in "qkv")
    act = 0.03
    out = k13_model(q, k, v, d ** -0.5, act)
    codes = [np.clip(np.rint(x[:, :, 0] / np.float32(act)), -127,
                     127).astype(np.int8) for x in (q, k, v)]
    sc0 = np.float32(np.float32(act) * np.float32(act)) * np.float32(
        d ** -0.5)
    sc1 = np.float32(act) / np.float32(127.0)
    sc = jnp.zeros((8, 128), jnp.float32).at[0, 0].set(sc0).at[0, 1].set(
        sc1)
    ref = pl.pallas_call(
        jattn._attn_kernel_s8,
        grid=(bh, t // bq),
        in_specs=[
            pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((8, 128), lambda i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, t, d), jnp.bfloat16),
        interpret=True,
    )(*(jnp.asarray(x) for x in codes), sc)
    _kernel_close(out[:, :, 0], np.asarray(ref, np.float32),
                  mean_tol=2.5e-3)
    # and the plain version it replaces
    _kernel_close(out, S8.fused_self_attention_s8_reference(
        *(_t(x) for x in (q, k, v)), d ** -0.5, act).float().numpy(),
        mean_tol=2.5e-3)


# ---------------------------------------------------------------------------
# K11 on the models
# ---------------------------------------------------------------------------
def k11_model(x, p):
    """K11 on the models: x8, QkPadEpi's q8/k8 (head-padded, equal scores),
    VtEpi's v8t, the stage with the of8 epilogue, to_out's dequantize."""
    b, t, c = x.shape
    h = p.heads
    d = c // h
    x8 = torch.round(torch.from_numpy(x) / torch.tensor(np.float32(p.xs)))
    x8 = x8.clamp_(-127, 127).to(torch.int8).reshape(b * t, c)
    m = p.m_qkv.numpy()
    qk = exact_int8_matmul(x8, p.w_qkv[:2 * c]).float().numpy()
    q8, k8 = (np.clip(np.rint(_f32(qk[:, i * c:(i + 1) * c]
                                   * m[i * c:(i + 1) * c])), -127,
                      127).astype(np.int8) for i in range(2))
    # the swapped product Wv8 x8^T: [C, B·T], requantized per row
    vT = exact_int8_matmul(p.w_qkv[2 * c:], x8).float().numpy()
    v8 = np.clip(np.rint(_f32(vT * m[2 * c:, None])), -127, 127).astype(
        np.int8).T
    v8t = v_projection_v8t(v8, b, t, h, S8.padded_keys(t))
    block_k = S8.sm90_s8pv_attention_plan(b * h, t, d).block_k
    ratio = p.ratio.numpy()
    of8 = np.zeros((b * t, c), np.int8)
    for i in range(b):
        rows = slice(i * t, (i + 1) * t)
        for j in range(h):
            cols = slice(j * d, (j + 1) * d)
            o32, l, _ = stage_model(q8[rows, cols], k8[rows, cols], v8t[i, j],
                                    p.score_scale, block_k)
            f = _f32(ratio[j] / l)
            of8[rows, cols] = np.clip(np.rint(_f32(_f32(o32) * f[:, None])),
                                      -127, 127)
    o32 = exact_int8_matmul(torch.from_numpy(of8), p.wo_q).float()
    out = o32 * torch.tensor(np.float32(p.out_scale))
    return out.to(torch.bfloat16).float().numpy().reshape(b, t, c)


def test_k11_model_matches_pallas_kernel_in_interpret_mode():
    b, t, heads, d = 2, 32, 4, 8
    c = heads * d
    rng, _, attn, _, w8, scales = _attention_case(13, c, heads)
    x = rng.randn(b, t, c).astype(np.float32)
    act_scale = 0.03
    wqp, wkp, wvp, wop, m, sc = jattn._abs_padded_prep(
        *w8, scales, heads, act_scale, 0.1, d ** -0.5)
    x8 = jnp.clip(jnp.round(jnp.asarray(x) / jnp.float32(act_scale)),
                  -127, 127).astype(jnp.int8)
    ref = np.asarray(jattn._abs_padded_s8_impl(
        x8, wqp, wkp, wvp, wop, m, sc, heads, interpret=True), np.float32)
    p = S8.pack_padded_attention(attn, heads, act_scale)
    out = k11_model(x, p)
    _kernel_close(out, ref, mean_tol=2.5e-3)
    _kernel_close(out, S8.padded_attention_s8_reference(_t(x), p).float()
                  .numpy(), mean_tol=2.5e-3)


# ---------------------------------------------------------------------------
# K17: the amax slots under the projection's tiling, head_out's promotion
# ---------------------------------------------------------------------------
def projection_amax_slots(y, b, t, c, gw, block_m, block_n):
    """AbsorbedProjEpi under gemm_kernel's tiling: per tile, per warp slab
    of 16 rows, per 8-column block (one column group each: part * (c / gw)
    + g), the running max of |y| over the warp's two 8-row groups, handed
    to group_max when the group changes and at the end; group_max folds it
    into slot (part * B + row / t) * (c / gw) + g by a max."""
    rows = b * t
    groups = c // gw
    slots = np.zeros(3 * b * groups, np.float32)
    ay = np.abs(y)

    def flush(group, g0, mx):
        part, g = divmod(group, groups)
        for r in range(2):
            row = g0 + 8 * r
            if row < rows:
                slot = (part * b + row // t) * groups + g
                slots[slot] = max(slots[slot], mx[r])

    for m0 in range(0, rows, block_m):
        for n0 in range(0, 3 * c, block_n):
            for g0 in range(m0, m0 + block_m, 16):   # a warp's slab
                group, mx = -1, [0.0, 0.0]
                for j in range(block_n // 8):
                    col = n0 + 8 * j
                    code = ((col // c) * groups + (col % c) // gw
                            if col < 3 * c else 0)
                    if code != group:
                        if group >= 0:
                            flush(group, g0, mx)
                        group, mx = code, [0.0, 0.0]
                    for r in range(2):
                        lo = g0 + 8 * r
                        if lo < rows and col < 3 * c:
                            assert len({rr // t for rr in range(lo, lo + 8)}
                                       ) == 1
                            mx[r] = max(mx[r], ay[lo:lo + 8,
                                                  col:col + 8].max())
                if group >= 0:
                    flush(group, g0, mx)
    return slots


@pytest.mark.parametrize("t", [32, 120, 128, 2048])
@pytest.mark.parametrize("fullc", [False, True])
def test_k17_amax_slots_equal_the_per_group_amax(t, fullc):
    b, c = 2, 320
    d = c // HEADS
    gw = c if fullc else d
    rng = np.random.RandomState(t)
    y = (rng.randn(b * t, 3 * c) * rng.rand(1, 3 * c) * 4).astype(
        np.float32)
    y[::37, 5] += 50.0                       # rows far from the others
    plan = G.sm90_gemm_plan(b * t, 3 * c, c, "int8")
    slots = projection_amax_slots(y, b, t, c, gw, plan.block_m, plan.block_n)
    want = np.abs(y).reshape(b, t, 3, c // gw, gw).max(axis=(1, 4))
    np.testing.assert_array_equal(slots, want.transpose(1, 0, 2).reshape(-1))
    src = (CSRC / "attention_s8.cu").read_text()
    assert "return which * (c / gw) + (col - which * c) / gw;" in src
    assert ("atomicMax(amax + (part * batch + row / t) * groups + (group - "
            "part *") in src


def head_out_model(oh8p, wo_p, factors, heads, t):
    """gemm_heads_kernel's sums: per head its dp columns' int32 product,
    promoted as acc = fl(acc + fl(float(c32) * f[row / t, h])), h = 0
    first."""
    rows = oh8p.shape[0]
    dp = oh8p.shape[1] // heads
    acc = np.zeros((rows, wo_p.shape[0]), np.float32)
    f = np.repeat(factors, t, axis=0)
    for h in range(heads):
        c32 = (oh8p[:, h * dp:(h + 1) * dp].astype(np.int64)
               @ wo_p[:, h * dp:(h + 1) * dp].astype(np.int64).T)
        acc = _f32(acc + _f32(_f32(c32) * f[:, h:h + 1]))
    return acc


@pytest.mark.parametrize("b,t,c", [(2, 32, 320), (1, 24, 640),
                                   (2, 8, 1280)])
def test_head_out_promotion_equals_the_plain_sum(b, t, c):
    d = c // HEADS
    dp = S8.head_padded_width(d)
    rng = np.random.RandomState(c)
    oh8 = rng.randint(-127, 128, (b * t, c)).astype(np.int8)
    wo8 = torch.from_numpy(rng.randint(-127, 128, (c, c)).astype(np.int8))
    os_ = (rng.rand(b, HEADS) * 1e-3).astype(np.float32)
    wos = (rng.rand(HEADS) * 1e-2).astype(np.float32)
    # oh8 head-padded as group_quant writes it (the padding's codes meet
    # Wo8's zero padding)
    oh8p = np.full((b * t, HEADS, dp), 77, np.int8)
    oh8p[:, :, :d] = oh8.reshape(b * t, HEADS, d)
    wo_p = S8.head_padded_wo(wo8, HEADS).numpy()
    assert not wo_p.reshape(c, HEADS, dp)[..., d:].any()
    factors = _f32(os_ * wos[None, :])        # head_factor: os * wos
    out = head_out_model(oh8p.reshape(b * t, -1), wo_p, factors, HEADS, t)
    # the plain version's loop (absorbed_attention_s8_reference)
    plain = None
    for h in range(HEADS):
        c32 = exact_int8_matmul(
            torch.from_numpy(oh8[:, h * d:(h + 1) * d]),
            wo8[:, h * d:(h + 1) * d])
        f = torch.from_numpy(os_[:, h]).repeat_interleave(t)[:, None] * \
            torch.tensor(wos[h])
        contrib = c32.float() * f
        plain = contrib if plain is None else plain + contrib
    np.testing.assert_array_equal(out, plain.numpy())
    # and the per-head product's own plain version (ops/gemm.py)
    np.testing.assert_array_equal(out, G.gemm_s8_heads(
        torch.from_numpy(oh8p.reshape(b * t, -1)), torch.from_numpy(wo_p),
        torch.from_numpy(factors), HEADS).numpy())


def k17_model(x, w_qkv, wo8, ws, heads, scale, act_scale):
    """K17 on the models: x8; y with the projection's epilogue and its amax
    slots; group_quant's codes (v8 into v8t); the stage with the fp32
    epilogue and its (image, head) amax; oh8; head_out's promotion."""
    b, t, c = x.shape
    d = c // heads
    xs = np.float32(act_scale)
    x8 = np.clip(np.rint(_f32(x) / xs), -127, 127).astype(np.int8)
    x8 = x8.reshape(b * t, c)
    ws = ws.numpy()
    fac = np.concatenate([np.repeat(_f32(xs * ws[i]), d) for i in range(3)])
    y32 = exact_int8_matmul(torch.from_numpy(x8), w_qkv).float().numpy()
    y = _f32(y32 * fac)
    plan = G.sm90_gemm_plan(b * t, 3 * c, c, "int8")
    amax = projection_amax_slots(y, b, t, c, d, plan.block_m, plan.block_n)
    ys = _f32(np.maximum(amax, np.float32(1e-6)) / np.float32(127.0))
    ys = ys.reshape(3, b, heads)
    codes = []
    for part in range(3):
        yp = y[:, part * c:(part + 1) * c].reshape(b, t, heads, d)
        codes.append(np.rint(_f32(yp / ys[part][:, None, :, None])).astype(
            np.int8))
    v8t = quant_pass_v8t(codes[2])
    block_k = S8.sm90_s8pv_attention_plan(b * heads, t, d).block_k
    oh = np.zeros((b, t, heads, d), np.float32)
    for i in range(b):
        for j in range(heads):
            qs, ks, vs = (ys[p_][i, j] for p_ in range(3))
            sc0 = _f32(_f32(qs * ks) * np.float32(scale))
            o32, l, _ = stage_model(codes[0][i, :, j], codes[1][i, :, j],
                                    v8t[i, j], sc0, block_k)
            oh[i, :, j] = _f32(_f32(_f32(o32) * vs) / l[:, None])
    os_ = _f32(np.maximum(np.abs(oh).max(axis=(1, 3)), np.float32(1e-6))
               / np.float32(127.0))                     # [B, H]
    oh8 = np.rint(_f32(oh / os_[:, None, :, None])).astype(np.int8)
    dp = S8.head_padded_width(d)
    oh8p = np.zeros((b * t, heads, dp), np.int8)
    oh8p[:, :, :d] = oh8.reshape(b * t, heads, d)
    factors = _f32(os_ * ws[3][None, :])
    out = head_out_model(oh8p.reshape(b * t, -1),
                         S8.head_padded_wo(wo8, heads).numpy(), factors,
                         heads, t)
    return torch.from_numpy(out).to(torch.bfloat16).float().numpy().reshape(
        b, t, c)


@pytest.mark.parametrize("b,t,heads,d", [(2, 32, 4, 8), (1, 24, 2, 16)])
def test_k17_model_matches_pallas_kernel_in_interpret_mode(b, t, heads, d):
    x, w = _case(2 * t + d, b, t, heads, d)
    scale = d ** -0.5
    act_scale = 0.03
    ref = np.asarray(_k17_pallas(jnp.asarray(x), w, heads, scale,
                                 act_scale), np.float32)
    w_qkv, wo8, sc = _port_head_codes(w, heads)
    out = k17_model(x, w_qkv, wo8, sc, heads, scale, act_scale)
    _kernel_close(out, ref, mean_tol=2.5e-3)
    _kernel_close(out, S8.absorbed_attention_s8_reference(
        _t(x), w_qkv, wo8, sc, heads, scale, act_scale).float().numpy(),
        mean_tol=2.5e-3)


def test_absorbed_pack_carries_the_head_padded_to_out():
    c, heads = 64, 4
    attn = __import__("ldmseg_torch.models.unet", fromlist=["x"]) \
        .CrossAttention(c, heads)
    p = S8.pack_absorbed_attention(attn, heads, 0.1)
    dp = S8.head_padded_width(c // heads)
    assert p.wo_p.shape == (c, heads * dp) and p.wo_p.is_contiguous()
    np.testing.assert_array_equal(
        p.wo_p.reshape(c, heads, dp)[..., :c // heads].numpy(),
        p.wo_q.reshape(c, heads, c // heads).numpy())
