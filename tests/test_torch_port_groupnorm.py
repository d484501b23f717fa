"""The port's GroupNorm + SiLU family against the JAX package on the CPU
(``UNetConfig.use_pallas_gn``, ``int8_fuse_gn`` and the ``gn_silu_conv``
op).

K5's, K6's and K7's plain versions against the Pallas kernels in interpret
mode, their dispatch fallbacks and recompute backwards against the JAX
wrappers, ``QuantConv2d`` on K6's ``(q, s)`` against ``QuantConv``'s
prequantized branch, the tiny UNet with each flag against JAX's, and the
slice: 2 DDIM steps of the tiny trainer's ``sample_panoptic`` with both
flags (float and int8) and one train step on K5's plain version against
compositions of the JAX functions. The JAX functions take NHWC, the port
NCHW: the tests transpose at the boundary. Inputs are made with numpy from
a seed and handed to both packages; each tolerance is stated with its
reason where it is used.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models import unet as junet  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_tpu.ops.pallas import gn_silu_conv as jgc  # noqa: E402
from ldmseg_tpu.ops.pallas import groupnorm_silu as jgn  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.layers import ResnetBlock  # noqa: E402
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa
from ldmseg_torch.ops import gn_silu_conv as K7  # noqa: E402
from ldmseg_torch.ops import groupnorm_silu as K5  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_int8 import (  # noqa: E402
    INT8_KW, TINY_KW, _rel, _t)
from test_torch_port_int8_unfused import _int8_kw  # noqa: E402
from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)
from test_torch_port_training import (  # noqa: E402,F401
    _jax_step, step_inputs, unet_params)

K6 = K5  # K6's wrappers live beside K5's
CPU = torch.device("cpu")
GN_FLAGS = dict(use_pallas_gn=True, int8_fuse_gn=True)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def _gn_case(seed, shape, offset=0.5):
    """NHWC x with a non-zero mean, and GN scale and shift, float32."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (1.5 * rng.randn(*shape) + offset).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    return x, scale, bias


def _max_close(out, ref, tol):
    """max |out - ref| <= tol * max|ref|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    err = float(np.abs(out - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, np.abs(ref).max())


def _codes_close(q, ref, share=1e-3):
    """int8 codes equal but for +-1 at no more than ``share`` of them: the
    two sides' statistics differ in the last fp32 bit (another summation
    order, or the variance as E[x²] - mean² against the two-pass one), which
    moves a code whose y / s sits on a .5 tie."""
    d = np.abs(np.asarray(q, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), d.mean())


def _gn_specs(h, w, c):
    return [pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
            pl.BlockSpec((c,), lambda i: (0,)),
            pl.BlockSpec((c,), lambda i: (0,))]


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 16), 4),
    ((2, 4, 6, 24), 4)])   # C/G = 6, not a power of two
def test_k5_plain_version_matches_pallas_kernel_in_interpret_mode(shape,
                                                                  groups):
    x, scale, bias = _gn_case(0, shape)
    b, h, w, c = shape
    ref = pl.pallas_call(
        functools.partial(jgn._gn_silu_kernel, groups=groups, eps=1e-5),
        grid=(b,), in_specs=_gn_specs(h, w, c),
        out_specs=pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    out = K5.group_norm_silu_reference(_nchw(x), _t(scale), _t(bias), groups,
                                       1e-5)
    assert out.dtype == torch.float32
    # the same arithmetic (E[x²] - mean² in fp32), sums in another order
    _max_close(_nhwc(out), ref, 1e-5)
    # the CPU wrapper takes that plain version at a kernel shape
    before = (K5.group_norm_silu.launches, K5.group_norm_silu.fallbacks)
    assert torch.equal(K5.group_norm_silu(_nchw(x), _t(scale), _t(bias),
                                          groups, 1e-5), out)
    assert (K5.group_norm_silu.launches,
            K5.group_norm_silu.fallbacks) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_fallback_matches_jax_reference(dtype):
    x, scale, bias = _gn_case(1, (2, 4, 4, 32))
    xj = jnp.asarray(x).astype(dtype)
    ref = np.asarray(jgn._reference(xj, jnp.asarray(scale),
                                    jnp.asarray(bias), 8, 1e-6), np.float32)
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    before = K5.group_norm_silu.fallbacks
    out = K5.group_norm_silu(xt, _t(scale), _t(bias), 8, 1e-6,
                             max_tile_bytes=64)
    assert K5.group_norm_silu.fallbacks == before + 1
    assert out.dtype == xt.dtype
    # fp32: the same two-pass arithmetic, summed in another order; bf16:
    # the fp32 results rounded to bf16, one bf16 ulp apart where they
    # straddle a rounding boundary
    _max_close(_nhwc(out), ref, 1e-5 if dtype == "float32" else 2.0 ** -7)


def test_k5_autograd_function_on_cpu_matches_jax_vjp():
    x, scale, bias = _gn_case(2, (2, 4, 4, 16))
    g = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, b: jgn._reference(a, s, b, 4, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    refs = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in (_nchw(x), _t(scale), _t(bias))]
    out = K5._FusedGroupNormSiLU.apply(*leaves, 4, 1e-5)
    out.backward(_nchw(g))
    # the backward recomputes through the reference as JAX's _bwd does:
    # the same function differentiated, fp32 sums in another order
    for got, ref in zip((_nhwc(leaves[0].grad), leaves[1].grad.numpy(),
                         leaves[2].grad.numpy()), refs):
        _max_close(got, ref, 1e-5)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------
def _k6_pallas(x, scale, bias, groups, eps):
    b, h, w, c = x.shape
    q, s = pl.pallas_call(
        functools.partial(jgn._gn_silu_quant_kernel, groups=groups, eps=eps),
        grid=(b,), in_specs=_gn_specs(h, w, c),
        out_specs=(pl.BlockSpec((1, h, w, c), lambda i: (i, 0, 0, 0)),
                   pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((b, h, w, c), jnp.int8),
                   jax.ShapeDtypeStruct((b, 8, 128), jnp.float32)),
        interpret=True,
    )(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return np.asarray(q), np.asarray(s[:, 0, 0])


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 4),
                                          ((2, 4, 6, 24), 4)])
def test_k6_plain_version_matches_pallas_kernel_in_interpret_mode(shape,
                                                                  groups):
    x, scale, bias = _gn_case(4, shape)
    q_ref, s_ref = _k6_pallas(x, scale, bias, groups, 1e-6)
    q, s = K6.group_norm_silu_quant_reference(_nchw(x), _t(scale), _t(bias),
                                              groups, 1e-6)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    # s = max(max|y|, 1e-6) / 127 per image: y to the last fp32 bits
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-6)
    _codes_close(_nhwc(q), q_ref)
    # the kernel's arithmetic as jnp, which the UNet tests give JAX: XLA
    # fuses it and the interpreted kernel apart by an fp32 ulp of s
    q_jnp, s_jnp = _jax_k6(jnp.asarray(x), scale, bias, groups, 1e-6)
    np.testing.assert_allclose(np.asarray(s_jnp), s_ref, rtol=1e-6)
    _codes_close(q_jnp, q_ref)
    before = K6.group_norm_silu_quant.fallbacks
    q2, s2 = K6.group_norm_silu_quant(_nchw(x), _t(scale), _t(bias), groups,
                                      1e-6)
    assert torch.equal(q2, q) and torch.equal(s2, s)
    assert K6.group_norm_silu_quant.fallbacks == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_fallback_matches_jax_wrapper_on_cpu(dtype):
    # JAX's CPU path is always its fallback: _reference, then the amax
    x, scale, bias = _gn_case(5, (2, 4, 4, 32))
    xj = jnp.asarray(x).astype(dtype)
    q_ref, s_ref = jgn.group_norm_silu_quant(xj, jnp.asarray(scale),
                                             jnp.asarray(bias), 8, 1e-6)
    xt = _nchw(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    before = K6.group_norm_silu_quant.fallbacks
    q, s = K6.group_norm_silu_quant(xt, _t(scale), _t(bias), 8, 1e-6,
                                    max_tile_bytes=64)
    assert K6.group_norm_silu_quant.fallbacks == before + 1
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)
    _codes_close(_nhwc(q), q_ref)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------
def _conv_case(seed, b, h, w, c, co):
    x, scale, bias = _gn_case(seed, (b, h, w, c))
    rng = np.random.RandomState(seed + 1)
    wk = (rng.randn(3, 3, c, co) * 0.1).astype(np.float32)   # HWIO
    bk = (rng.randn(co) * 0.1).astype(np.float32)
    return x, scale, bias, wk, bk


def _oihw(wk):
    return torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))


def test_k7_plain_version_matches_pallas_kernel_in_interpret_mode():
    b, h, w, c, co, g = 2, 8, 16, 16, 8, 4
    x, scale, bias, wk, bk = _conv_case(6, b, h, w, c, co)
    ref = pl.pallas_call(
        functools.partial(jgc._kernel, groups=g, eps=1e-5),
        grid=(b,),
        in_specs=_gn_specs(h, w, c) + [
            pl.BlockSpec((3, 3, c, co), lambda i: (0, 0, 0, 0)),
            pl.BlockSpec((co,), lambda i: (0,))],
        out_specs=pl.BlockSpec((1, h, w, co), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, h, w, co), jnp.float32),
        scratch_shapes=[pltpu.VMEM((h + 2, w + 2, c), jnp.float32),
                        pltpu.VMEM((h, w + 2, co), jnp.float32)],
        interpret=True,
    )(*(jnp.asarray(a) for a in (x, scale, bias, wk, bk)))
    args = (_nchw(x), _t(scale), _t(bias), _oihw(wk), _t(bk), g, 1e-5)
    out = K7.gn_silu_conv_reference(*args)
    assert out.shape == (b, co, h, w) and out.dtype == torch.float32
    # fp32: the zero padding of y (not of x), the nine taps summed in
    # another order than the kernel's nine shifted products
    _max_close(_nhwc(out), ref, 1e-4)
    before = (K7.gn_silu_conv.launches, K7.gn_silu_conv.fallbacks)
    assert torch.equal(K7.gn_silu_conv(*args), out)
    assert (K7.gn_silu_conv.launches, K7.gn_silu_conv.fallbacks) == before


def test_k7_fallback_and_backward_match_jax():
    b, h, w, c, co, g = 2, 4, 6, 16, 8, 4
    x, scale, bias, wk, bk = _conv_case(7, b, h, w, c, co)
    jargs = [jnp.asarray(a) for a in (x, scale, bias, wk, bk)]
    ref, vjp = jax.vjp(lambda *a: jgc._reference(*a, g, 1e-5), *jargs)
    cot = np.random.RandomState(8).randn(b, h, w, co).astype(np.float32)
    ref_grads = vjp(jnp.asarray(cot))
    args = [_nchw(x), _t(scale), _t(bias), _oihw(wk), _t(bk)]
    before = K7.gn_silu_conv.fallbacks
    out = K7.gn_silu_conv(*args, g, 1e-5, max_tile_bytes=64)
    assert K7.gn_silu_conv.fallbacks == before + 1
    # the same two-pass GN and fp32 conv, summed in another order
    _max_close(_nhwc(out), ref, 1e-5)
    # the autograd Function's backward recomputes through that fallback, as
    # the JAX _bwd through _reference
    leaves = [a.clone().requires_grad_() for a in args]
    K7.fused_gn_silu_conv(*leaves, g, 1e-5).backward(_nchw(cot))
    got = [_nhwc(leaves[0].grad), leaves[1].grad.numpy(),
           leaves[2].grad.numpy(),
           leaves[3].grad.numpy().transpose(2, 3, 1, 0),
           leaves[4].grad.numpy()]
    for name, gt, rf in zip(("x", "scale", "bias", "w", "b"), got,
                            ref_grads):
        _max_close(gt, rf, 1e-5), name


# ---------------------------------------------------------------------------
# QuantConv2d on K6's (q, s)
# ---------------------------------------------------------------------------
def test_quant_conv_on_prequantized_codes_matches_jax_bit_for_bit():
    rng = np.random.RandomState(9)
    b, h, w, cin, cout = 2, 5, 6, 16, 24
    wk = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    q = rng.randint(-127, 128, size=(b, h, w, cin)).astype(np.int8)
    s = (rng.rand(b) * 0.05 + 0.01).astype(np.float32)
    w_q, w_scale = jquant.quantize_weight(jnp.asarray(wk))
    ref = jquant.QuantConv(cout, (3, 3), padding=1).apply(
        {"params": {"kernel": {"q": w_q, "scale": w_scale},
                    "bias": jnp.asarray(bias)}},
        (jnp.asarray(q), jnp.asarray(s)))
    assert ref.dtype == jnp.bfloat16
    src = torch.nn.Conv2d(cin, cout, 3, padding=1)
    with torch.no_grad():
        src.weight.copy_(_oihw(wk))
    conv = quant.QuantConv2d(cin, cout, act_scale=0.05)
    with torch.no_grad():
        conv.bias.copy_(_t(bias))
    conv.prepare(src)
    conv.x_scale = 0.3   # a calibrated scale: not read on this branch
    with torch.no_grad():
        out = conv((_nchw(q), torch.from_numpy(s)))
    # bf16 whatever the compute dtype; the same int32 sums, scale products
    # and roundings: equal bit for bit
    assert out.dtype == torch.bfloat16 and out.shape == (b, cout, h, w)
    np.testing.assert_array_equal(_nhwc(out),
                                  np.asarray(ref.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the tiny UNet with each flag
# ---------------------------------------------------------------------------
def _jax_tiny(**flags):
    return junet.UNet2DCondition(junet.UNetConfig(
        use_cross_attention=False, cond_channels=4, **TINY_KW, **flags))


@pytest.fixture(scope="module")
def tiny():
    params = _random_params(lambda: _jax_tiny().init(
        jax.random.key(0), jnp.zeros((1, 6, 6, 12)),
        jnp.zeros((1,), jnp.int32)), 5)
    ucfg = UNetConfig(**TINY_KW, use_pallas_gn=True)
    float_unet = UNet2DCondition(ucfg)
    # the flags leave the parameter tree as it is: strict loading
    float_unet.load_state_dict(convert.unet_state_dict_from_jax(params, ucfg),
                               strict=True)
    # a 6x6 latent: T = 36 and 9, no multiple of 8, so every transformer
    # site takes the fallback on both sides, and the resnets decide
    rng = np.random.RandomState(INT8_SEED)
    x = rng.randn(2, 6, 6, 12).astype(np.float32)
    t = np.array([999, 19])
    jfloat = jax.jit(_jax_tiny(use_pallas_gn=True).apply)
    return params, float_unet, x, t, np.asarray(jfloat(params, x, t))


def test_tiny_unet_with_use_pallas_gn_matches_jax(tiny):
    _, float_unet, x, t, ref = tiny
    before = (K5.group_norm_silu.launches, K5.group_norm_silu.fallbacks)
    with torch.no_grad():
        out = float_unet(_nchw(x), torch.from_numpy(t))
    # 8 resnets (1 down and 2 up per level, 2 mid), 2 norms each, on K5's
    # plain version (JAX's CPU path takes _reference); no fallback
    assert (K5.group_norm_silu.launches,
            K5.group_norm_silu.fallbacks) == before
    assert all(m.norm1.use_pallas for m in float_unet.modules()
               if isinstance(m, ResnetBlock))
    # fp32: the variance as E[x²] - mean² against the two-pass one
    _max_close(_nhwc(out), ref, 1e-5)


# An input at which no int8 code or bf16 conv output of the tiny int8 UNet
# lies on a rounding tie that the two sides' statistics (sums in another
# order, so a per-image scale an fp32 ulp apart) move apart: measured 4e-7
# and 6e-7 of max|ref| (fused, (a)); 12 of the 16 seeds 0-15 have no such
# tie in either variant. At FLIP_SEED one moves the output by 1e-2 (fused)
# and 3e-3 (a) of max|ref|.
INT8_SEED, FLIP_SEED = 8, 6


def _jax_k6(x, scale, bias, groups=32, eps=1e-5):
    """``_gn_silu_quant_kernel``'s arithmetic (:151-166) as plain jnp, per
    image: ``gn_silu_rows``, the JAX package's single definition of the GN
    numerics, then the kernel's quantize. It equals the kernel in interpret
    mode up to an fp32 ulp of s (``test_k6_plain_version_matches_pallas_
    kernel_in_interpret_mode``) and compiles in half the time in a UNet."""
    b, h, w, c = x.shape
    y = jax.vmap(lambda xi: jgn.gn_silu_rows(
        xi.astype(jnp.float32).reshape(h * w, c), scale, bias, groups,
        eps))(x)
    s = jnp.maximum(jnp.max(jnp.abs(y), axis=(1, 2)), 1e-6) / 127.0
    q = jnp.round(y / s[:, None, None]).astype(jnp.int8)
    return q.reshape(b, h, w, c), s


@pytest.fixture
def jax_k6_kernel():
    """JAX's ``group_norm_silu_quant`` with its kernel's arithmetic. On the
    CPU it would take its fallback, ``_reference`` rounded to the input's
    dtype: the resnets' second norm reads the s8 conv's bf16 output, so that
    fallback quantizes a bf16-rounded y where the kernel (and the port)
    quantize the fp32 y, and a few percent of the codes differ."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgn, "group_norm_silu_quant", _jax_k6)
        yield


def _int8_unet_pair(params, variant):
    heads = TINY_KW["attention_head_dim"]
    if variant == "fused":
        kw = INT8_KW
        tree = jquant.pack_inference_tiles(
            jquant.prequantize_conv_tree(params, quantize_ff=True,
                                         absorbed_attention=True,
                                         attention_heads=heads),
            attention_heads=heads, int8_act_scale=0.05,
            int8_attn_act_scale=0.1)
    else:   # (a): K13 + K12, fused_norms False
        kw = _int8_kw("a")
        tree = jquant.prequantize_conv_tree(params, quantize_ff=True,
                                            absorbed_attention=False,
                                            attention_heads=heads)
    # XLA may skip a rounding to bf16 inside a fusion (excess precision);
    # PyTorch rounds where the code says, so JAX is compiled to do so too
    japply = jax.jit(_jax_tiny(**kw, **GN_FLAGS).apply,
                     compiler_options={"xla_allow_excess_precision": False})
    return (UNet2DCondition(UNetConfig(**TINY_KW, **kw, **GN_FLAGS)),
            japply, tree)


@pytest.mark.parametrize("variant", ["fused", "a"])
def test_tiny_int8_unet_with_int8_fuse_gn_matches_jax(tiny, jax_k6_kernel,
                                                      variant):
    params, float_unet, x, t, ref_float = tiny
    int8_unet, japply, tree = _int8_unet_pair(params, variant)
    quant.prepare_int8_unet(int8_unet, float_unet)
    norms = [m for r in int8_unet.modules() if isinstance(r, ResnetBlock)
             for m in (r.norm1, r.norm2)]
    assert len(norms) == 16 and all(m.quantize for m in norms)
    before = (K6.group_norm_silu_quant.fallbacks,
              K5.group_norm_silu.fallbacks)
    inputs = [x, np.random.RandomState(FLIP_SEED).randn(
        *x.shape).astype(np.float32)]
    for i, xi in enumerate(inputs):
        ref = np.asarray(japply(tree, xi, t))
        with torch.no_grad():
            out = _nhwc(int8_unet(_nchw(xi), torch.from_numpy(t)))
        if i == 0:
            # at INT8_SEED the same codes on both sides: the conv on K6's
            # codes, its bf16 output and the sites pinned (fp32 otherwise)
            _max_close(out, ref, 1e-5)
            quant_effect = _rel(ref, ref_float)
            assert quant_effect > 1e-3, "the int8 path changed nothing"
        # at any input, a tie or not: well under the quantization's own
        # effect
        assert _rel(out, ref) <= 0.5 * quant_effect, (i, _rel(out, ref),
                                                      quant_effect)
    # every norm took K6's plain version: no fallback, no K5
    assert (K6.group_norm_silu_quant.fallbacks,
            K5.group_norm_silu.fallbacks) == before


# ---------------------------------------------------------------------------
# the slice: sample_panoptic with both flags, and a train step on K5
# ---------------------------------------------------------------------------
STEPS = 2


@pytest.fixture(scope="module")
def slice_jax():
    """The tiny trainer's weights, frames and noise, and the x0 of 2 DDIM
    steps of the JAX compositions with both flags: the float UNet, and the
    int8 UNet after the JAX trainer's calibrate_int8 and _prequant, its K6
    with the kernel's arithmetic (see ``jax_k6_kernel``)."""
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    calib_noise = rng.randn(2, 4, 8, 4).astype(np.float32)
    heads = UNET_KW["attention_head_dim"]
    jcfg = dict(use_cross_attention=False, cond_channels=4, **UNET_KW,
                **GN_FLAGS)
    unet = junet.UNet2DCondition(junet.UNetConfig(**jcfg))
    unet8 = junet.UNet2DCondition(junet.UNetConfig(**dict(jcfg,
                                                          **INT8_KW)))
    ivae = JImageVAE(decoder_enabled=False, **CFG["image_vae_kwargs"])
    vk = {k: v for k, v in CFG["vae_model_kwargs"].items()
          if k != "pretrained_path"}
    vk["block_out_channels"] = tuple(vk["block_out_channels"])
    svae = JSegVAE(**vk)
    k = jax.random.split(jax.random.key(0), 3)
    up = _random_params(lambda: unet.init(
        k[0], jnp.zeros((1, 4, 8, 12)), jnp.zeros((1,), jnp.int32)), 0)
    ip = _random_params(lambda: ivae.init(
        k[1], jnp.zeros((1, 32, 64, 3)), method=JImageVAE.encode), 1)
    sp = _random_params(lambda: svae.init(
        {"params": k[2], "sample": k[2]}, jnp.zeros((1, 32, 64, 10)),
        sample_posterior=False), 2)
    sched = jddim.make_ddim_schedule(**CFG["noise_scheduler_kwargs"])
    lat = ivae.apply(ip, 2.0 * _jax_unnormalize_to01(jnp.asarray(image))
                     - 1.0, method=JImageVAE.encode).mode() * 0.18215
    inp = jnp.concatenate([jnp.asarray(calib_noise), lat,
                           jnp.zeros((2, 4, 8, 4))], axis=-1)
    scales = jquant.calibrate_act_scale_tree(
        unet.apply, up, (inp, jnp.full((2,), 500, jnp.int32)))
    up8 = jquant.pack_inference_tiles(
        jquant.apply_act_scales(jquant.prequantize_conv_tree(
            up, quantize_ff=True, absorbed_attention=True,
            attention_heads=heads), scales),
        attention_heads=heads, int8_act_scale=0.05, int8_attn_act_scale=0.1)

    def jax_x0(model, params):
        def model_fn(latents, condition, t):
            x = jnp.concatenate([latents, lat, condition], axis=-1)
            return model.apply(params, x, t)
        return np.asarray(jax.jit(lambda z: jddim_sample(
            sched, model_fn, z, num_inference_steps=STEPS,
            self_condition=True))(jnp.asarray(init)))

    x0_f = jax_x0(unet, up)
    with pytest.MonkeyPatch.context() as mp:   # K6 as in jax_k6_kernel
        mp.setattr(jgn, "group_norm_silu_quant", _jax_k6)
        x0_8 = jax_x0(unet8, up8)
    return dict(image=image, init=init, calib_noise=calib_noise, up=up,
                ip=ip, sp=sp, x0_f=x0_f, x0_8=x0_8)


def _slice_trainer(j, int8: bool):
    cfg = merge_dicts(CFG, {"sampling_kwargs": {"int8_inference": int8}})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(**UNET_KW,
                                                           **GN_FLAGS),
                               device=CPU)
    trainer.load_jax_params(j["up"], j["ip"], j["sp"])
    return trainer


def test_sample_panoptic_with_use_pallas_gn_against_jax(slice_jax):
    j = slice_jax
    trainer = _slice_trainer(j, int8=False)
    before = (K5.group_norm_silu.fallbacks,
              K6.group_norm_silu_quant.fallbacks)
    logits, x0 = trainer.sample_panoptic({"image": j["image"]},
                                         init_noise=j["init"],
                                         num_inference_steps=STEPS)
    assert (K5.group_norm_silu.fallbacks,
            K6.group_norm_silu_quant.fallbacks) == before
    assert logits.shape == (2, 32, 64, 24) and bool(torch.isfinite(
        logits).all())
    # fp32 through 2 steps x 2 UNet passes: K5's plain E[x²] - mean²
    # against JAX's two-pass _reference
    _max_close(x0.numpy(), j["x0_f"], 1e-4)


def test_int8_sample_panoptic_with_int8_fuse_gn_against_jax(slice_jax):
    j = slice_jax
    trainer = _slice_trainer(j, int8=True)
    trainer.calibrate_int8({"image": j["image"]}, noise=j["calib_noise"])
    before = (K5.group_norm_silu.fallbacks,
              K6.group_norm_silu_quant.fallbacks)
    logits, x0 = trainer.sample_panoptic({"image": j["image"]},
                                         init_noise=j["init"],
                                         num_inference_steps=STEPS)
    assert (K5.group_norm_silu.fallbacks,
            K6.group_norm_silu_quant.fallbacks) == before
    assert logits.shape == (2, 32, 64, 24) and bool(torch.isfinite(
        logits).all())
    # JAX's CPU path takes its fallbacks (float attention, exact gelu, one
    # amax per tensor) where the port runs K3's and K4's plain versions:
    # held to half the quantization's own effect, as the int8 slice is
    quant_effect = _rel(j["x0_8"], j["x0_f"])
    assert quant_effect > 1e-3, "the int8 path changed nothing"
    assert _rel(x0.numpy(), j["x0_8"]) <= 0.5 * quant_effect


def test_train_step_with_use_pallas_gn_matches_jax(unet_params, step_inputs):
    # JAX's use_pallas_gn on the CPU runs _reference, the plain GN's
    # arithmetic, and differentiates it: the composition of
    # test_torch_port_training is that step. The port's forward takes K5's
    # plain version, its backward recomputes through the reference. Loss to
    # 1e-5 relative, every UNet gradient to 1e-4 of its largest value
    _, ip, _, sp, batch, noise, timesteps = step_inputs
    ref_loss, ref_grads = _jax_step(unet_params, step_inputs)
    trainer = TrainerDiffusion(CFG, unet_config=UNetConfig(
        **UNET_KW, use_pallas_gn=True), device=CPU)
    trainer.load_jax_params(unet_params, ip, sp)
    loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                          timesteps=timesteps)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = convert.unet_state_dict_from_jax(ref_grads, trainer.unet_config)
    for name, p in trainer.unet.named_parameters():
        assert p.grad is not None, name
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)
