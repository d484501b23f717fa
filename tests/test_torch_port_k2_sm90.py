"""K2's bf16 kernels on Hopper: the launch plan, the order of dQ's sum and
the arithmetic.

``csrc/attention_bwd.cu`` (a stats kernel and a main kernel on TMA and
``wgmma``) runs only on the card (``tests/test_torch_port_k2_sm90_card.py``
holds it against the plain version there). What the CPU can pin:

* the launch plan, which ``ops/attention.py:sm90_bwd_launch_plan`` chooses
  and the C entry point checks: shared memory within a block's 232,448
  bytes, TMA boxes of whole 128-byte rows, grids within the card's limits;
* the order of dQ's sum over key blocks: for every query tile the ranks of
  the key blocks are a permutation, in the order in which the blocks reach
  the tile, so every wait is for a block that reaches it earlier;
* the arithmetic. A blocked model of the two kernels (the stats pass key
  tile by key tile with the running max, the sum of 2^(s c - m) and the
  rescaled a = sum 2^(s c - m) dP, delta = a / l; the main pass 64 keys by
  64 queries, P^T = 2^(s c - m) (1 / l), dS^T = P^T (dP^T - delta), both
  rounded to bf16 as product operands; dQ summed over key blocks in rank
  order) is compared with the TPU backward ``_flash_bwd(..., interpret=True)``:
  dQ, dK and dV within 1.6e-2 x max|ref| (two bf16 ulps at the gradient's
  largest value), and with a transcription of ``_attn_bwd_kernel``'s body:
  delta within 1e-5 of the row's sum of P |dP| (the size of its terms:
  the two sums run in another order and the model's P comes from exp2 and
  a reciprocal), and the rounded P and dS equal on all but ``FLIPS`` of the
  entries, each off by one bf16 ulp at most.
"""

import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.ops.pallas.attention import _flash_bwd  # noqa: E402
from ldmseg_torch.ops import attention as port  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = ROOT / "ldmseg_torch/csrc/attention_bwd.cu"

HEAD_DIMS = list(range(8, 161, 8))
# the path's T (training 1920/480/120/30, the forward's 2048/512/128/32)
# and the card tests' ragged and tile-edge T
SEQ_LENS = (1, 30, 32, 63, 64, 65, 100, 120, 127, 128, 129, 480, 512, 1920,
            2048)
HEADS = (1, 16, 64)  # B*H: one head, the sampling path's, the training's
MAX_GRID = 65535
MAX_ROTATE = 32  # csrc/attention_bwd.cu: kMaxRotate
FLIPS = 2e-4
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_bwd_launch_plan_fits_the_card(d):
    for bh in HEADS:
        for t in SEQ_LENS:
            plan = port.sm90_bwd_launch_plan(bh, t, d)
            what = f"(B*H, T, D) = ({bh}, {t}, {d}): {plan}"
            assert plan.head_class in port.SM90_HEAD_CLASSES, what
            assert d <= plan.head_class <= plan.chunks * port.SM90_BOX_D
            assert plan.q_tiles == -(-t // 64), what
            for smem in (plan.stats_smem, plan.main_smem):
                assert smem <= port.SM90_SMEM_LIMIT, what
            assert plan.stats_smem == port.sm90_bwd_stats_smem(
                plan.stats_block_q, plan.stats_block_k, plan.chunks,
                plan.stats_stages), what
            assert plan.main_smem == port.sm90_bwd_main_smem(
                plan.main_block_k, plan.head_class, plan.chunks,
                plan.main_stages), what
            # 64 rows per consumer warpgroup; TMA boxes of at most 256 rows
            assert plan.stats_block_q in (64, 128), what
            assert plan.main_block_k in (64, 128), what
            assert plan.stats_block_k == (128 if plan.head_class <= 80
                                          else 64), what
            assert plan.main_block_k == 64 or plan.head_class <= 80, what
            for block, regs in ((plan.stats_block_q, plan.stats_regs),
                                (plan.main_block_k, plan.main_regs)):
                assert regs == (port.SM90_CONSUMER_REGS if block == 128
                                else 0), what
            for grid_x, block in ((plan.stats_grid_x, plan.stats_block_q),
                                  (plan.main_grid_x, plan.main_block_k)):
                assert (grid_x - 1) * block < t <= grid_x * block, what
            assert plan.grid_y == bh <= MAX_GRID, what
            assert 2 <= plan.stats_stages <= port.SM90_MAX_STAGES, what
            assert 2 <= plan.main_stages <= port.SM90_MAX_STAGES, what
            # the stats of a query tile (a bulk copy) and a dQ tile (a bulk
            # store or add) are whole 16-byte units
            assert (4 * port.SM90_BWD_STATS_FLOATS) % 16 == 0
            assert (4 * 64 * d) % 16 == 0


def test_bwd_launch_plan_at_the_training_shapes():
    # (B*H, T, D) of the training path at batch 8, 8 heads
    big = port.sm90_bwd_launch_plan(64, 1920, 40)
    assert (big.stats_block_q, big.main_block_k) == (128, 128)
    assert (big.stats_grid_x, big.main_grid_x, big.q_tiles) == (15, 15, 30)
    assert big.main_stages == 4 and big.main_regs == 232
    mid = port.sm90_bwd_launch_plan(64, 480, 80)
    assert (mid.stats_block_q, mid.main_block_k) == (128, 128)
    # above D = 80 the main kernel's consumer is alone in its block (dK
    # and dV take 160 of its registers at D = 160)
    small = port.sm90_bwd_launch_plan(64, 120, 160)
    assert (small.stats_block_q, small.stats_block_k) == (64, 64)
    assert (small.main_block_k, small.chunks) == (64, 3)
    # one warpgroup where 128-row blocks would leave SMs idle
    assert port.sm90_bwd_launch_plan(2, 100, 40).stats_block_q == 64
    assert port.sm90_bwd_launch_plan(2, 100, 40).main_block_k == 64


def test_bwd_launch_plan_matches_the_kernel_source():
    """The C side reads the plan as ``struct BwdPlan`` and checks it with its
    own copies of the classes, the limits and the tile rules."""
    src = SOURCE.read_text()
    body = re.search(r"struct BwdPlan \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"int (\w+);", body)
    plan = port.sm90_bwd_launch_plan(64, 1920, 40)
    names = [f.name for f in port.BwdLaunchPlan.__dataclass_fields__.values()]
    assert fields == names
    assert list(plan.as_c()) == [getattr(plan, n) for n in names]
    classes = re.search(r"kClasses\[\] = \{([\d, ]+)\}", src).group(1)
    assert tuple(int(c) for c in classes.split(",")) == \
        port.SM90_HEAD_CLASSES
    assert f"kSmemLimit = {port.SM90_SMEM_LIMIT};" in src
    assert f"kConsumerRegs = {port.SM90_CONSUMER_REGS};" in src
    assert f"kMaxRotate = {MAX_ROTATE};" in src
    assert f"kStatsBytes = 3 * 64 * 4;" in src
    assert "p.stats_block_k == (cls <= 80 ? 128 : 64)" in src
    assert "(p.main_block_k == 128 && cls <= 80)" in src
    assert "head_class <= 64 ? 3 : head_class <= 80 ? 2 : 1" in src
    assert "kDqBufs = kDN <= 64 ? 3 : kDN <= 80 ? 2 : 1" in src
    for c in port.SM90_HEAD_CLASSES:
        assert f"case {c}: return launch_class<{c}>" in src


def test_ablation_edits_still_match_the_kernel_source():
    """``tools/ablate_attention_bwd.py`` takes parts out of the kernels by
    textual edits; each must still find its text."""
    from ldmseg_torch.tools import ablate_attention_bwd as ablate
    src = SOURCE.read_text()
    out = ablate.variants(src)
    assert out["kernel"] == src
    assert len({text for text in out.values()}) == len(out)


# ---------------------------------------------------------------------------
# the order of dQ's sum
# ---------------------------------------------------------------------------
def _dq_rank(x, i, blocks, q_tiles, wgs, rotate):
    """``dq_rank``: block x's place among the key blocks adding to query
    tile i's dQ, by the step at which each reaches tile i, then by index."""
    def step(xx):
        return (i - (wgs * xx if rotate else 0)) % q_tiles
    return sum(1 for xx in range(blocks)
               if (step(xx), xx) < (step(x), x))


@pytest.mark.parametrize("bh,t,d", [(64, 1920, 40), (64, 480, 80),
                                    (64, 120, 160), (2, 100, 40),
                                    (1, 2048, 160), (1, 4096, 40)])
def test_dq_ranks_follow_the_blocks_schedules(bh, t, d):
    plan = port.sm90_bwd_launch_plan(bh, t, d)
    blocks, q_tiles = plan.main_grid_x, plan.q_tiles
    wgs = plan.main_block_k // 64
    rotate = blocks <= MAX_ROTATE
    assert rotate == (t <= MAX_ROTATE * plan.main_block_k)
    first = [(wgs * x if rotate else 0) % q_tiles for x in range(blocks)]
    for i in range(q_tiles):
        ranks = [_dq_rank(x, i, blocks, q_tiles, wgs, rotate)
                 for x in range(blocks)]
        assert sorted(ranks) == list(range(blocks))
        # block x reaches tile i at step (i - first[x]) mod q_tiles: a
        # block waits only for blocks that reach the tile at an earlier
        # step, or at the same step with a lower index
        arrive = [((i - first[x]) % q_tiles, x) for x in range(blocks)]
        assert [x for _, x in sorted(arrive)] == \
            sorted(range(blocks), key=ranks.__getitem__)
    if rotate and blocks > 1:
        # the staggered starts: no two blocks start on one tile
        assert len(set(first)) == blocks


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------
def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _fma(a, b, c):
    """fp32 a * b + c with one rounding (float64 holds a * b exactly)."""
    return (np.asarray(a, np.float64) * np.float64(b)
            + np.asarray(c, np.float64)).astype(np.float32)


def _pad(x, rows):
    out = np.zeros((rows, x.shape[1]), np.float32)
    out[:x.shape[0]] = x
    return out


def _blocked_model(q, k, v, do, scale, plan):
    """The two kernels' arithmetic on one head ([T, D] float32 arrays of
    bf16 values, zero-filled past T as TMA fills them). Returns dQ, dK,
    dV (bf16 values), delta and the rounded P and dS ([T, T], query rows)."""
    t, d = q.shape
    c = np.float32(np.float32(scale) * np.float32(LOG2E))
    tq = 64 * plan.q_tiles

    # stats pass: key tiles of stats_block_k, one pass
    kb = plan.stats_block_k
    tk = kb * -(-t // kb)
    qp, dop, kp, vp = _pad(q, tq), _pad(do, tq), _pad(k, tk), _pad(v, tk)
    m = np.full(tq, -np.inf, np.float32)
    l = np.zeros(tq, np.float32)
    a = np.zeros(tq, np.float32)
    for k0 in range(0, tk, kb):
        s = qp @ kp[k0:k0 + kb].T  # fp32 sums
        dp = dop @ vp[k0:k0 + kb].T
        if c > 0:  # the max of s c is c times the max of s
            keys = np.arange(k0, k0 + kb) < t
            mx = np.where(keys, s, -np.inf).max(axis=1) * c
            mn = np.maximum(m, mx.astype(np.float32))
            e = np.exp2(_fma(s, c, -mn[:, None]))
        else:
            sc = (s * c).astype(np.float32)
            keys = np.arange(k0, k0 + kb) < t
            mn = np.maximum(m, np.where(keys, sc, -np.inf).max(axis=1))
            e = np.exp2(sc - mn[:, None]).astype(np.float32)
        e = np.where(np.arange(k0, k0 + kb) < t, e, 0).astype(np.float32)
        alpha = np.exp2(m - mn).astype(np.float32)
        l = _fma(l, alpha, e.sum(axis=1, dtype=np.float32))
        a = _fma(a, alpha, (e * dp).sum(axis=1, dtype=np.float32))
        m = mn
    rows = np.arange(tq) < t
    rl = np.where(rows, np.float32(1) / l, 0).astype(np.float32)
    delta = np.where(rows, a / l, 0).astype(np.float32)
    m = np.where(rows, m, 0).astype(np.float32)

    # main pass: 64 keys (a warpgroup) by 64 queries (a ring stage)
    tk = 64 * -(-t // 64)
    kp, vp = _pad(k, tk), _pad(v, tk)
    wgs = plan.main_block_k // 64
    blocks = plan.main_grid_x
    rotate = blocks <= MAX_ROTATE
    dk = np.zeros((tk, d), np.float32)
    dv = np.zeros((tk, d), np.float32)
    partial = {}  # (block, query tile) -> fp32 dQ partial
    p_all = np.zeros((tq, tk), np.float32)
    ds_all = np.zeros((tq, tk), np.float32)
    for x in range(blocks):
        first = wgs * x if rotate else 0
        for n in range(plan.q_tiles):
            i = (first + n) % plan.q_tiles
            qs = slice(64 * i, 64 * i + 64)
            for w in range(wgs):
                ks = slice(64 * (wgs * x + w), 64 * (wgs * x + w) + 64)
                if ks.start >= tk:
                    continue  # a warpgroup past T adds zeros
                st = kp[ks] @ qp[qs].T  # S^T, [key, query]
                dpt = vp[ks] @ dop[qs].T
                pt = np.exp2(_fma(st, c, -m[qs][None, :])) * rl[qs][None, :]
                pt[np.arange(ks.start, ks.stop) >= t] = 0
                dst = (pt * (dpt - delta[qs][None, :])).astype(np.float32)
                pb, dsb = _bf16(pt), _bf16(dst)
                dv[ks] += pb @ dop[qs]
                dk[ks] += dsb @ qp[qs]
                part = dsb.T @ kp[ks]
                partial[x, i] = partial.get((x, i), 0) + part
                p_all[qs, ks] = pb.T
                ds_all[qs, ks] = dsb.T
    dq = np.zeros((tq, d), np.float32)
    for i in range(plan.q_tiles):
        order = sorted(range(blocks), key=lambda x: _dq_rank(
            x, i, blocks, plan.q_tiles, wgs, rotate))
        acc = np.zeros((64, d), np.float32)
        for x in order:
            acc = (acc + partial[x, i]).astype(np.float32)
        dq[64 * i:64 * i + 64] = acc
    return (_bf16(dq[:t] * scale), _bf16(dk[:t] * scale), _bf16(dv[:t]),
            delta[:t], p_all[:t, :t], ds_all[:t, :t])


def _tpu_body(q, k, v, do, scale):
    """``_attn_bwd_kernel``'s body on one head in fp32 numpy: its delta and
    its rounded P and dS."""
    s = (q @ k.T) * np.float32(scale)
    s = s - s.max(axis=1, keepdims=True)
    e = np.exp(s)
    p = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    dp = do @ v.T
    delta = (dp * p).sum(axis=1, dtype=np.float32)
    ds = (p * (dp - delta[:, None])).astype(np.float32)
    return delta, (p * np.abs(dp)).sum(axis=1), _bf16(p), _bf16(ds)


def _ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-38))) - 7)


@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("t", [30, 100, 200])
def test_blocked_model_matches_the_tpu_backward(t, d):
    bh = 2
    rng = np.random.RandomState(t * 1000 + d)
    q, k, v, do = (_bf16(rng.randn(bh, t, d)) for _ in range(4))
    scale = d ** -0.5
    plan = port.sm90_bwd_launch_plan(bh, t, d)
    refs = _flash_bwd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)),
                      scale, t, interpret=True)
    refs = [np.asarray(r.astype(jnp.float32)) for r in refs]
    flips = {"P": 0, "dS": 0}
    for h in range(bh):
        dq, dk, dv, delta, p, ds = _blocked_model(q[h], k[h], v[h], do[h],
                                                  scale, plan)
        for name, got, ref in zip(("dQ", "dK", "dV"), (dq, dk, dv), refs):
            bound = 1.6e-2 * np.abs(ref[h]).max()
            err = np.abs(got - ref[h]).max()
            assert err <= bound, f"{name} (T={t}, D={d}): {err} > {bound}"
        delta_ref, size, p_ref, ds_ref = _tpu_body(q[h], k[h], v[h], do[h],
                                                   scale)
        np.testing.assert_array_less(np.abs(delta - delta_ref),
                                     1e-5 * size + 1e-30)
        for name, got, ref in (("P", p, p_ref), ("dS", ds, ds_ref)):
            differ = got != ref
            flips[name] += int(differ.sum())
            # a flip moves the value by one bf16 ulp (8 bits) at most
            assert np.all(np.abs(got - ref)[differ]
                          <= _ulp(ref)[differ] * 1.0001), name
        assert np.allclose(p.sum(axis=1), 1, atol=t * 2 ** -8)
    for name, n in flips.items():
        assert n <= FLIPS * bh * t * t, f"{name}: {n} of {bh * t * t} flipped"


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_blocked_model_takes_scores_near_80_and_a_negative_scale(sign):
    # q = 8 k on unit rows with scale 10: logits of about +-80; and the
    # negative scale of the card tests
    t, d = 100, 64
    rng = np.random.RandomState(7)
    k = rng.randn(t, d)
    k = _bf16(k / np.linalg.norm(k, axis=1, keepdims=True))
    q = _bf16(sign * 8.0 * k)
    v, do = _bf16(rng.randn(t, d)), _bf16(rng.randn(t, d))
    for scale in (10.0, -d ** -0.5):
        plan = port.sm90_bwd_launch_plan(1, t, d)
        got = _blocked_model(q, k, v, do, scale, plan)[:3]
        refs = port.attention_backward_reference(
            *(torch.from_numpy(x[None, :, None]).to(torch.bfloat16)
              for x in (q, k, v, do)), scale)
        for g, r in zip(got, refs):
            r = r[0, :, 0].float().numpy()
            assert np.all(np.isfinite(g))
            assert np.abs(g - r).max() <= 1.6e-2 * max(np.abs(r).max(), 1e-6)
