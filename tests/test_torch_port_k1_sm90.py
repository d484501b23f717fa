"""K1's bf16 kernel on Hopper: the launch plan and the rounding point.

``csrc/attention_fwd.cu:attention_fwd_kernel_sm90`` runs only on the card
(``tests/test_torch_port_k1_sm90_card.py`` holds it against the plain
version there). What the CPU can pin:

* the launch plan, which ``ops/attention.py:sm90_launch_plan`` chooses and
  the C entry points check: shared memory within a block's 232,448 bytes,
  TMA boxes whose rows are whole 16-byte units inside the 128-byte swizzle,
  a grid within the card's limits, 128-row query tiles on the long shapes;
* the rounding point. A blocked two-pass model of the kernel's arithmetic
  at the plan's key tile (pass 1: running max and sum of 2^(s c - m) in
  fp32; pass 2: p = 2^(s c - m) * (1 / l), rounded to bf16, then P·V in
  fp32) is compared with the TPU kernel ``_attn_kernel`` run through
  ``pl.pallas_call(..., interpret=True)``: O within 1.6e-2 (two bf16 ulps
  at 1.0), and the rounded P equal to ``_attn_body``'s ``p.astype(bf16)``
  on all but ``P_FLIPS`` of the entries, each off by one bf16 ulp at most
  (exp2 against exp and a reciprocal against a division move p by a few
  fp32 ulps, which flips a rounding only next to a bf16 tie).
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

from ldmseg_tpu.ops.pallas.attention import _attn_kernel  # noqa: E402
from ldmseg_torch.ops import attention as port  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "ldmseg_torch/csrc/attention_fwd.cu"
SKELETON = ROOT / "ldmseg_torch/csrc/attention_sm90.cuh"
SM90 = ROOT / "ldmseg_torch/csrc/sm90.cuh"

HEAD_DIMS = list(range(8, 161, 8))
# the path's T (sampling 2048/512/128/32, training 1920/480/120/30) and the
# card tests' ragged and tile-edge T
SEQ_LENS = (1, 30, 32, 63, 64, 65, 100, 120, 127, 128, 129, 480, 512, 1920,
            2048)
HEADS = (1, 16, 64)  # B*H: one head, the sampling path's, the training's
MAX_GRID_Y = 65535
P_FLIPS = 2e-4


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_launch_plan_fits_the_card(d):
    for bh in HEADS:
        for t in SEQ_LENS:
            plan = port.sm90_launch_plan(bh, t, d)
            what = f"(B*H, T, D) = ({bh}, {t}, {d}): {plan}"
            assert plan.smem_bytes <= port.SM90_SMEM_LIMIT, what
            assert plan.smem_bytes == port.sm90_smem_bytes(
                plan.block_q, plan.block_k, plan.chunks, plan.stages), what
            # a box row: whole 16-byte units within the 128-byte swizzle
            row_bytes = 2 * plan.box_d
            assert row_bytes % 16 == 0 and row_bytes <= 128, what
            # box rows (64 query rows, block_k keys) within TMA's 256
            assert 64 <= plan.block_k <= 256 and plan.block_q % 64 == 0, what
            assert plan.head_class in port.SM90_HEAD_CLASSES, what
            assert d <= plan.head_class <= plan.chunks * plan.box_d, what
            assert plan.head_class % 8 == 0, what  # N of a wgmma
            tiles, heads = plan.grid
            assert heads == bh <= MAX_GRID_Y, what
            assert (tiles - 1) * plan.block_q < t <= tiles * plan.block_q, what
            assert 2 <= plan.stages <= port.SM90_MAX_STAGES, what


def test_launch_plan_takes_128_row_tiles_on_the_long_shapes():
    # two consumer warpgroups where the grid still covers the 132 SMs
    assert port.sm90_launch_plan(16, 2048, 40).block_q == 128
    assert port.sm90_launch_plan(64, 1920, 40).block_q == 128
    assert port.sm90_launch_plan(64, 480, 80).block_q == 128
    # one warpgroup where 128 rows would leave SMs idle: T = 512 at
    # B*H = 16 is 64 blocks of 128 rows, 128 of 64
    assert port.sm90_launch_plan(16, 512, 80).block_q == 64
    assert port.sm90_launch_plan(16, 512, 80).grid == (8, 16)
    # 64-key tiles above D = 80: two score tiles and O in registers
    assert port.sm90_launch_plan(16, 128, 160).block_k == 64
    assert port.sm90_launch_plan(16, 2048, 40).block_k == 128


def test_launch_plan_matches_the_kernel_source():
    """The C side reads the plan as ``struct Plan`` and checks it with its
    own copies of the classes, the limit and the key-tile rule (in the
    source and the headers that hold the skeleton K1 shares with K3)."""
    src = SOURCE.read_text() + SKELETON.read_text() + SM90.read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"int (\w+);", body)
    plan = port.sm90_launch_plan(16, 2048, 40)
    assert fields == ["head_class", "block_q", "block_k", "stages", "box_d",
                      "chunks", "smem_bytes", "grid_x", "grid_y"]
    assert list(plan.as_c()) == [plan.head_class, plan.block_q, plan.block_k,
                                 plan.stages, plan.box_d, plan.chunks,
                                 plan.smem_bytes, *plan.grid]
    classes = re.search(r"kClasses\[\] = \{([\d, ]+)\}", src).group(1)
    assert tuple(int(c) for c in classes.split(",")) == \
        port.SM90_HEAD_CLASSES
    assert f"kSmemLimit = {port.SM90_SMEM_LIMIT};" in src
    assert f"kBox = {port.SM90_BOX_D};" in src
    assert "block_k == (cls <= 80 ? 128 : 64)" in src
    assert "return attn90::launch<K1Kernel>(a, stream);" in src
    for c in port.SM90_HEAD_CLASSES:
        assert f"case {c}: return launch_as<K, {c}, kWG>(a, stream);" in src


def test_ablation_edits_still_match_the_kernel_source():
    """``tools/ablate_attention_fwd.py`` takes parts out of the kernel by
    textual edits; each must still find its text."""
    from ldmseg_torch.tools import ablate_attention_fwd as ablate
    src = SKELETON.read_text()
    out = ablate.variants(src)
    assert out["kernel"] == src
    assert len({text for text in out.values()}) == len(out)


# ---------------------------------------------------------------------------
# the rounding point
# ---------------------------------------------------------------------------
def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _two_pass_model(q, k, v, scale, block_k):
    """The kernel's arithmetic on one head ([T, D] float32 arrays holding
    bf16 values): returns (O rounded to bf16, P rounded to bf16)."""
    t = q.shape[0]
    c = np.float32(np.float32(scale) * np.float32(math.log2(math.e)))
    s = q @ k.T  # fp32 sums

    def shifted(x, m):  # fma(s, c, -m): one rounding
        return (x.astype(np.float64) * np.float64(c)
                - m.astype(np.float64)[:, None]).astype(np.float32)

    m = np.full(t, -np.inf, np.float32)
    l = np.zeros(t, np.float32)
    for k0 in range(0, t, block_k):  # pass 1, tile by tile
        st = s[:, k0:k0 + block_k]
        mn = np.maximum(m, (st.max(axis=1) * c).astype(np.float32))
        e = np.exp2(shifted(st, mn)).sum(axis=1, dtype=np.float32)
        l = (l * np.exp2(m - mn) + e).astype(np.float32)
        m = mn
    r = (np.float32(1) / l).astype(np.float32)
    p = _bf16(np.exp2(shifted(s, m)) * r[:, None])  # pass 2
    return _bf16(p @ v), p


def _pallas(q, k, v, scale, out_dtype):
    """``_attn_kernel`` over ``[BH, T, D]`` (V ``[BH, T, N]``) in interpret
    mode, one query block per head."""
    bh, t, d = q.shape
    n = v.shape[-1]
    return pl.pallas_call(
        functools.partial(_attn_kernel, scale=scale),
        grid=(bh, 1),
        in_specs=[pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((1, t, n), lambda i, j: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, t, n), lambda i, j: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, t, n), out_dtype),
        interpret=True,
    )(q, k, v)


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("t", [30, 100, 200])
def test_two_pass_model_keeps_attn_body_rounding_point(t, d):
    bh = 2
    rng = np.random.RandomState(t * 1000 + d)
    q, k, v = (_bf16(rng.randn(bh, t, d)) for _ in range(3))
    scale = d ** -0.5
    block_k = port.sm90_launch_plan(bh, t, d).block_k
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o_ref = np.asarray(_pallas(jq, jk, jv, scale, jnp.bfloat16)
                       .astype(jnp.float32))
    # V = I turns _attn_body's P·V into its rounded P, read back in fp32
    eye = jnp.broadcast_to(jnp.eye(t, dtype=jnp.bfloat16), (bh, t, t))
    p_ref = np.asarray(_pallas(jq, jk, eye, scale, jnp.float32))

    flips = 0
    for i in range(bh):
        o, p = _two_pass_model(q[i], k[i], v[i], scale, block_k)
        np.testing.assert_allclose(o, o_ref[i], rtol=0, atol=1.6e-2)
        differ = p != p_ref[i]
        flips += int(differ.sum())
        # a flip moves p by one bf16 ulp (8 bits of mantissa) at most
        ulp = np.exp2(np.floor(np.log2(np.maximum(p_ref[i], 1e-38))) - 7)
        assert np.all(np.abs(p - p_ref[i])[differ] <= ulp[differ] * 1.0001)
        assert np.all(np.isfinite(p)) and np.allclose(p.sum(axis=1), 1,
                                                      atol=t * 2 ** -8)
    assert flips <= P_FLIPS * bh * t * t, f"{flips} of {bh * t * t} flipped"
