"""K5's and K6's Hopper design (``csrc/groupnorm_silu.cu``: one
thread-block cluster per (image, group) span) and the repaired LN +
quantize stage of the int8 blocks (fault F2), on the CPU.

- :func:`ldmseg_torch.ops.groupnorm_silu.sm90_gn_plan` at the 44 resnet
  norms of a sampling forward and of a train step (``tools/profile_gn.py:
  site_shapes``), at the 8 MiB rule's edge and on the scalar path: the CTAs
  tile every span exactly, a cluster has at most 8, a thread holds at most
  32 values, K6's scratch has its words.
- :func:`gn_fold_model`, the kernels' arithmetic in PyTorch in their order
  of the sums (each thread over its values in load order, a butterfly over
  the warp, the warps in order, the cluster's CTAs in rank order), against
  the plain version ``gn_silu_rows`` and against ``_gn_silu_kernel`` and
  ``_gn_silu_quant_kernel`` in interpret mode, at the tolerances of
  ``tests/test_torch_port_groupnorm.py`` (fp32 1e-5 of max|ref|; K6's
  codes +-1 at no more than 1e-3 of them, its scale within 1e-5).
- F2: ``ln_quant_warp_model`` (the repaired ``ln_quant_kernel``'s
  ``__fmul_rn``/``__fadd_rn`` steps and ``rsqrt``, in its warp's order)
  gives ``_layer_norm``'s codes bit for bit on every row where its sums
  equal PyTorch's, and elsewhere differs by one only next to a .5.

The JAX functions take NHWC, the port NCHW: the tests transpose at the
boundary; inputs are made with numpy from a seed.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ldmseg_tpu.ops.pallas import groupnorm_silu as jgn  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops.attention import SM90_SMS  # noqa: E402
from ldmseg_torch.ops import groupnorm_silu as GN  # noqa: E402
from ldmseg_torch.tools.profile_gn import site_shapes  # noqa: E402

from test_torch_port_gn_sm90_card import (  # noqa: E402
    CLUSTERS, SAMPLING, SCALAR, TRAINING, _true_div, check_code_flips,
    ln_quant_warp_model)

ROUND = GN.THREADS * GN.VALUES


@functools.lru_cache(maxsize=None)
def _sites(batch, h, w):
    return tuple(shape for shape, _ in site_shapes(batch, h, w))


def _plan_of(shape, dtype, aligned=True, groups=32):
    b, c, h, w = shape
    return GN.sm90_gn_plan(b, c, h * w, groups, dtype, aligned)


def _check_tiles(plan, shape, groups=32):
    """What the C entry points check, and the register budget."""
    b, c, h, w = shape
    span = c // groups * h * w
    k, per, vec = plan.cluster, plan.per_cta, plan.vec
    assert (plan.span, plan.spans) == (span, b * groups)
    assert 1 <= k <= GN.MAX_CLUSTER
    assert per % vec == 0 and span % vec == 0
    # k slices, each non-empty, covering the span with no gap or overlap
    assert (k - 1) * per < span <= k * per
    bounds = [(r * per, min((r + 1) * per, span)) for r in range(k)]
    assert bounds[0][0] == 0 and bounds[-1][1] == span
    assert all(lo < hi for lo, hi in bounds)
    assert all(bounds[r][1] == bounds[r + 1][0] for r in range(k - 1))
    assert (plan.rounds - 1) * ROUND < per <= plan.rounds * ROUND
    assert plan.fields() == (int(vec > 1), k, per, plan.rounds)
    assert plan.ctas == b * groups * k
    assert plan.k6_scratch_words(b) == 2 * b * groups + plan.ctas + b


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("path,batch,h,w", [("sampling", 2, 32, 64),
                                            ("training", 8, 24, 80)])
def test_plan_tiles_the_unet_sites(path, batch, h, w, dtype):
    sites = _sites(batch, h, w)
    assert len(sites) == 44
    classes = SAMPLING if path == "sampling" else TRAINING
    assert set(sites) == set(classes)
    for shape in sites:
        plan = _plan_of(shape, dtype)
        _check_tiles(plan, shape)
        # the UNet's spans fit the registers in one round, 16-byte packs
        assert plan.rounds == 1 and plan.vec == 16 // dtype.itemsize
        # the fewest CTAs that hold the span; the large spans cover the SMs
        assert plan.cluster == -(-plan.span // ROUND)
        if plan.span > 2 * ROUND:
            assert plan.ctas >= SM90_SMS, (shape, plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 2048, 32, 32), (1, 512, 64, 64),
                                   (2, 128, 128, 128), (1, 32, 256, 256)])
def test_plan_at_the_8mib_edge(shape, dtype):
    b, c, h, w = shape
    assert GN.takes_kernel(torch.empty((1, c, h, w), device="meta"),
                           GN.MAX_TILE_BYTES)
    plan = _plan_of(shape, dtype)
    _check_tiles(plan, shape)
    assert plan.cluster == GN.MAX_CLUSTER and plan.rounds == 1
    assert plan.per_cta == ROUND


@pytest.mark.parametrize("groups,rounds", [(16, 2), (8, 4), (4, 8)])
def test_plan_takes_rounds_where_a_span_outgrows_the_cluster(groups, rounds):
    shape = (1, 2048, 32, 32)          # at the 8 MiB edge, fewer groups
    plan = _plan_of(shape, torch.bfloat16, groups=groups)
    _check_tiles(plan, shape, groups)
    assert plan.cluster == GN.MAX_CLUSTER and plan.rounds == rounds


@pytest.mark.parametrize("shape", SCALAR + [(2, 320, 16, 32)])
def test_plan_takes_the_scalar_path(shape):
    aligned = shape in SCALAR          # the last: a misaligned base
    plan = _plan_of(shape, torch.bfloat16, aligned=aligned)
    _check_tiles(plan, shape)
    assert plan.vec == 1 and plan.fields()[0] == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_takes_every_cluster_size_at_the_card_tests_shapes(dtype):
    shapes = SAMPLING + TRAINING + SCALAR + CLUSTERS
    assert {_plan_of(s, dtype).cluster for s in shapes} == set(
        range(1, GN.MAX_CLUSTER + 1))


# ---------------------------------------------------------------------------
# the kernels' order of the sums, modelled
# ---------------------------------------------------------------------------
def gn_fold_model(x, scale, bias, groups, eps, plan):
    """``y`` (fp32, x's shape) and per span ``(mean, inv)`` as the cluster
    kernel computes them under ``plan``: each thread adds its values in
    load order (round, pack, element), a butterfly over its warp, the
    warps in order, the cluster's CTAs in rank order; then
    ``span_stats`` and ``gn_silu``, one rounding per operation."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b * groups, -1)
    span = xf.shape[1]
    k, per, vec, rounds = plan.cluster, plan.per_cta, plan.vec, plan.rounds
    iters = GN.VALUES // vec
    r = torch.arange(k)[:, None, None, None, None]
    t = torch.arange(GN.THREADS)[None, :, None, None, None]
    rd = torch.arange(rounds)[None, None, :, None, None]
    it = torch.arange(iters)[None, None, None, :, None]
    e = torch.arange(vec)[None, None, None, None, :]
    pack = r * per + rd * ROUND + (it * GN.THREADS + t) * vec
    valid = pack < torch.clamp((r + 1) * per, max=span)
    idx = (pack + e).expand(k, GN.THREADS, rounds, iters, vec)
    vals = torch.where(valid, xf[:, idx.clamp(max=span - 1)], 0.0)
    vals = vals.reshape(b * groups, k, GN.THREADS, -1)
    s1 = torch.zeros(vals.shape[:3])
    s2 = torch.zeros(vals.shape[:3])
    for j in range(vals.shape[-1]):
        f = vals[..., j]
        s1 = s1 + f
        s2 = s2 + f * f
    lane = torch.arange(32)

    def fold(v):                                  # [spans, k, THREADS]
        v = v.reshape(*v.shape[:2], GN.THREADS // 32, 32)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., lane ^ o]
        warps = v[..., 0]
        cta = torch.zeros(warps.shape[:2])
        for w in range(warps.shape[-1]):
            cta = cta + warps[..., w]
        total = torch.zeros(cta.shape[:1])
        for q in range(k):
            total = total + cta[:, q]
        return total[:, None]

    n = float(span)
    mean = _true_div(fold(s1), n)
    var = _true_div(fold(s2), n) - mean * mean
    inv = 1.0 / torch.sqrt(var + eps)
    y = ((xf - mean) * inv).reshape(x.shape)
    y = y * scale.float()[:, None, None] + bias.float()[:, None, None]
    y = y * (1.0 / (1.0 + torch.exp(-y)))
    return y, mean[:, 0], inv[:, 0]


def _case(seed, shape, offset=0.5):
    """NCHW x with a non-zero mean, and GN scale and shift, float32."""
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = (1.5 * rng.randn(*shape) + offset).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    return x, scale, bias


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _hand_plan(shape, groups, cluster, per_cta, vec, rounds):
    b, c, h, w = shape
    return GN.GNPlan(span=c // groups * h * w, spans=b * groups, vec=vec,
                     cluster=cluster, per_cta=per_cta, rounds=rounds)


# shapes, groups and plans: the plan's own, and hand-made ones that give a
# small span several CTAs or several rounds (the kernel's arithmetic for
# any plan the C side takes)
MODEL_CASES = [
    ((2, 64, 8, 16), 8, None),
    ((2, 96, 7, 9), 8, None),                    # scalar, ragged span
    ((2, 64, 8, 16), 8, (3, 456, 8, 1)),         # 3 CTAs, the last shorter
    ((1, 64, 16, 16), 4, (1, 4096, 4, 1)),
    ((1, 64, 16, 16), 4, (5, 820, 4, 1)),
    ((1, 32, 8, 8), 1, (1, 2048, 8, 1)),
]


def _model_plan(shape, groups, hand, dtype=torch.float32):
    if hand is None:
        return _plan_of(shape, dtype, groups=groups)
    return _hand_plan(shape, groups, *hand)


@pytest.mark.parametrize("shape,groups,hand", MODEL_CASES)
def test_fold_model_matches_the_plain_version(shape, groups, hand):
    x, scale, bias = _case(0, shape)
    plan = _model_plan(shape, groups, hand)
    _check_tiles(plan, shape, groups)
    y, _, _ = gn_fold_model(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), groups, 1e-5, plan)
    ref = GN.gn_silu_rows(torch.from_numpy(x), torch.from_numpy(scale),
                          torch.from_numpy(bias), groups, 1e-5)
    # the same arithmetic, the sums in another order
    assert _rel(y, ref) <= 1e-5


def test_fold_model_over_rounds_matches_one_round():
    # a span held in 2 rounds against the same span in one: only the
    # sums' order differs
    shape, groups = (1, 32, 32, 32), 2
    x, scale, bias = (torch.from_numpy(a) for a in _case(5, shape))
    one = gn_fold_model(x, scale, bias, groups, 1e-5,
                        _hand_plan(shape, groups, 2, 8192, 8, 1))[0]
    two = gn_fold_model(x, scale, bias, groups, 1e-5,
                        _hand_plan(shape, groups, 1, 16384, 8, 2))[0]
    assert _rel(two, one) <= 1e-5


def _nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


def _pallas(kernel, x, scale, bias, groups, out_shape, out_specs):
    b, h, w, c = x.shape
    specs = [pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
             pl.BlockSpec((c,), lambda i: (0,)),
             pl.BlockSpec((c,), lambda i: (0,))]
    return pl.pallas_call(
        functools.partial(kernel, groups=groups, eps=1e-5), grid=(b,),
        in_specs=specs, out_specs=out_specs, out_shape=out_shape,
        interpret=True)(jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias))


@pytest.mark.parametrize("shape,groups,hand", MODEL_CASES)
def test_fold_model_matches_k5_pallas_kernel_in_interpret_mode(shape, groups,
                                                               hand):
    x, scale, bias = _case(1, shape)
    b, c, h, w = shape
    xh = _nhwc(x)
    ref = _pallas(jgn._gn_silu_kernel, xh, scale, bias, groups,
                  jax.ShapeDtypeStruct(xh.shape, jnp.float32),
                  pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)))
    y, _, _ = gn_fold_model(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), groups, 1e-5,
                            _model_plan(shape, groups, hand))
    assert _rel(_nhwc(y.numpy()), ref) <= 1e-5


@pytest.mark.parametrize("shape,groups,hand", MODEL_CASES)
def test_fold_model_matches_k6_pallas_kernel_in_interpret_mode(shape, groups,
                                                               hand):
    x, scale, bias = _case(2, shape)
    b, c, h, w = shape
    xh = _nhwc(x)
    q_ref, s_ref = _pallas(
        jgn._gn_silu_quant_kernel, xh, scale, bias, groups,
        (jax.ShapeDtypeStruct(xh.shape, jnp.int8),
         jax.ShapeDtypeStruct((b, 8, 128), jnp.float32)),
        (pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
         pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))))
    y, _, _ = gn_fold_model(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), groups, 1e-5,
                            _model_plan(shape, groups, hand))
    # launch B: s from the maxima, a true division
    s = _true_div(y.abs().amax(dim=(1, 2, 3)).clamp_min(1e-6), 127.0)
    q = torch.round(y / s[:, None, None, None]).to(torch.int8)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref)[:, 0, 0],
                               rtol=1e-5)
    d = np.abs(_nhwc(q.numpy()).astype(np.int32)
               - np.asarray(q_ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), d.mean())


# ---------------------------------------------------------------------------
# F2: the LN + quantize stage's rounding points
# ---------------------------------------------------------------------------
LN_CASES = [((2, 256, 320), 0.05), ((2, 64, 640), 0.1), ((1, 32, 1280), 0.05),
            ((3, 24, 48), 0.02), ((1, 40, 100), 0.05)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,xs", LN_CASES)
def test_ln_quant_model_equals_layer_norm_where_the_sums_agree(shape, xs,
                                                               dtype):
    rng = np.random.RandomState(shape[-1] + shape[1])
    c = shape[-1]
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    w = torch.from_numpy((1 + 0.3 * rng.randn(c)).astype(np.float32))
    b = torch.from_numpy((0.3 * rng.randn(c)).astype(np.float32))
    eps = 1e-5
    x8, mu, var, r = ln_quant_warp_model(x, w, b, xs, eps)
    ref8 = S8.ln_quant_reference(x, w, b, xs, eps)
    xf = x.float().reshape(-1, c)
    pmu = xf.mean(-1)
    pvar = ((xf - pmu[:, None]) * (xf - pmu[:, None])).mean(-1)
    same = (pmu == mu) & (pvar == var)
    assert bool(same.any())
    # r is rsqrt(var + eps), the plain version's step
    assert torch.equal(r, torch.rsqrt(var + eps))
    x8r, ref8r = x8.reshape(-1, c), ref8.reshape(-1, c)
    assert torch.equal(x8r[same], ref8r[same])
    # elsewhere the last bit of mu or var may flip a code next to a .5
    hn = S8._layer_norm(x.float(), w, b, eps)
    check_code_flips(x8, ref8, _true_div(hn, xs))


def test_ln_quant_s8_on_the_cpu_is_the_plain_version():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 16, 64).astype(np.float32))
    w = torch.from_numpy((1 + 0.3 * rng.randn(64)).astype(np.float32))
    b = torch.from_numpy((0.3 * rng.randn(64)).astype(np.float32))
    before = S8.ln_quant_s8.launches
    x8, st = S8.ln_quant_s8(x, w, b, 0.05, 1e-5, stats=True)
    assert S8.ln_quant_s8.launches == before
    assert torch.equal(x8, S8.ln_quant_reference(x, w, b, 0.05, 1e-5))
    assert st.shape == (32, 3)
    assert torch.equal(st[:, 2], torch.rsqrt(st[:, 1] + 1e-5))
