"""The port's int8 sampling without fused norms against the JAX package on
the CPU (``sampling_kwargs.fused_norms`` / ``fused_ff`` False).

K13's and K12's plain versions against the Pallas kernels in interpret mode,
their dispatch branches against the JAX wrappers, ``QuantLinear`` against
``QuantDense``, the weight preparation bit for bit against
``prequantize_conv_tree(quantize_ff=True, absorbed_attention=False)``, the
tiny unfused int8 UNet against JAX's at a latent where every transformer
site falls back on both sides (the same arithmetic, so fp32-close), and 2
DDIM steps of the tiny trainer's ``sample_panoptic`` against a composition
of the JAX functions. Inputs are made with numpy from a seed and handed to
both packages; each tolerance is stated with its reason where it is used.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models import unet as junet  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_tpu.ops.pallas import geglu as jgeglu  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import (  # noqa: E402
    BasicTransformerBlock, FeedForwardS8, UNet2DCondition, UNetConfig)
from ldmseg_torch.ops import attention_s8 as K13  # noqa: E402
from ldmseg_torch.ops import geglu as K12  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_int8 import (  # noqa: E402
    TINY_KW, _eq, _geglu_case, _jax_operands, _kernel_close, _rel, _t,
    _tree, jax_path)
from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------
def _quantized_qkv(seed, bh, t, d):
    """int8 q, k, v codes of randn tensors with their per-tensor dynamic
    scales, and the kernel's sc0 and sc1, all float32 as the JAX wrapper
    computes them."""
    rng = np.random.RandomState(seed)
    xs = [rng.randn(bh, t, d).astype(np.float32) for _ in range(3)]
    scales = [np.float32(np.abs(x).max()) / np.float32(127.0) for x in xs]
    codes = [np.clip(np.round(x / s), -127, 127).astype(np.int8)
             for x, s in zip(xs, scales)]
    qs, ks, vs = scales
    sc0 = qs * ks * np.float32(d ** -0.5)
    sc1 = vs / np.float32(127.0)
    return codes, np.float32(sc0), np.float32(sc1)


@pytest.mark.parametrize("bh,t,d,bq", [(2, 64, 40, 32), (2, 64, 80, 64),
                                       (2, 24, 40, 24)])  # T % 16 != 0
def test_k13_plain_version_matches_pallas_kernel_in_interpret_mode(bh, t, d,
                                                                   bq):
    (q8, k8, v8), sc0, sc1 = _quantized_qkv(bh + t + d, bh, t, d)
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
    )(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), sc)
    ref = np.asarray(ref, np.float32)

    def bthd(x):  # [BH, T, D] -> [B=BH, T, H=1, D]
        return torch.from_numpy(x)[:, :, None]
    out = K13.attention_s8_reference(bthd(q8), bthd(k8), bthd(v8),
                                     float(sc0), float(sc1))
    assert out.dtype == torch.bfloat16 and out.shape == (bh, t, 1, d)
    # the same rounding points; a code of e flips by one where PyTorch's
    # and XLA's exp differ by an ulp at a .5 boundary (measured: equal, or
    # within one bf16 ulp of the output)
    _kernel_close(out[:, :, 0].float().numpy(), ref, mean_tol=2.5e-3)


@pytest.mark.parametrize("t,act_scale", [(30, 0.1), (30, None),
                                         (1920, 0.1)])
def test_k13_fallback_matches_jax_wrapper_on_cpu(t, act_scale):
    # T % 8 and T % 1024 (KITTI's first level): float attention, no
    # quantization, on both sides
    b, h, d = (2, 2, 8) if t < 100 else (1, 1, 8)
    rng = np.random.RandomState(t)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    ref = jattn.fused_self_attention_s8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5,
        act_scale=act_scale)
    before = K13.fused_self_attention_s8.fallbacks
    out = K13.fused_self_attention_s8(_t(q), _t(k), _t(v), d ** -0.5,
                                      act_scale)
    assert K13.fused_self_attention_s8.fallbacks == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, t, h, d)
    # fp32 on both sides: only the summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_k13_wrapper_takes_the_plain_version_at_kernel_shapes_on_cpu():
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(2, 32, 2, 8)) for _ in range(3))
    before = (K13.fused_self_attention_s8.fallbacks,
              K13.fused_self_attention_s8.launches)
    for act in (0.05, None):
        out = K13.fused_self_attention_s8(q, k, v, 8 ** -0.5, act)
        assert torch.equal(out, K13.fused_self_attention_s8_reference(
            q, k, v, 8 ** -0.5, act).float())
        # int8 against float attention: the quantization's own error
        ref = K13.attention_s8_fallback(q, k, v, 8 ** -0.5)
        assert _rel(out.numpy(), ref.numpy()) < 0.05
    assert (K13.fused_self_attention_s8.fallbacks,
            K13.fused_self_attention_s8.launches) == before


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,static", [
    (1, 1024, False),  # two 512-token blocks, each its own dynamic amax
    (2, 16, True)])
def test_k12_plain_version_matches_pallas_kernel_in_interpret_mode(b, t,
                                                                   static):
    c, m = 64, 128
    rng, norm, proj_in, proj_out = _geglu_case(17, c, m)
    x = rng.randn(b, t, c).astype(np.float32)
    if t > 512:
        # the second block's interior range differs from the first's
        x[:, 512:, 0] += 12.0
    act_scale, g_scale = 0.08, (0.02 if static else None)
    p = K12.pack_geglu(norm, proj_in, proj_out, act_scale, g_scale)
    w1q, w2q, (s1, b1, s2, _, _, _) = _jax_operands(p)
    s1t = jnp.zeros((8, 2 * m), jnp.float32).at[0].set(s1).at[1].set(b1)
    s2t = jnp.zeros((8, c), jnp.float32).at[0].set(s2)
    sc = jnp.zeros((8, 128), jnp.float32).at[0, 0].set(act_scale)
    if static:
        sc = sc.at[0, 1].set(g_scale)
    bt = min(512, t)
    ref = pl.pallas_call(
        functools.partial(jgeglu._geglu_kernel, static_g=static),
        grid=(b, t // bt),
        in_specs=[
            pl.BlockSpec((1, bt, c), lambda i, j: (i, j, 0)),
            pl.BlockSpec(w1q.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(w2q.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(s1t.shape, lambda i, j: (0, 0)),
            pl.BlockSpec(s2t.shape, lambda i, j: (0, 0)),
            pl.BlockSpec((8, 128), lambda i, j: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, bt, c), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(x), w1q, w2q, s1t, s2t, sc)
    ref = np.asarray(ref, np.float32)
    out = K12.geglu_s8_reference(_t(x), p)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    # K4's tolerances: the same rounding points, sums in another order
    _kernel_close(out.float().numpy(), ref)
    if t > 512:
        per_tensor = K12.geglu_s8_reference(_t(x), p, block_t=t)
        assert not torch.equal(per_tensor, out), \
            "the case cannot tell one amax per block from one per tensor"
    # the CPU wrapper takes the same plain version at a kernel shape
    before = K12.fused_geglu_s8.fallbacks
    assert torch.equal(K12.fused_geglu_s8(_t(x), p), out.float())
    assert K12.fused_geglu_s8.fallbacks == before


@pytest.mark.parametrize("t,static,via_wrapper", [
    (20, False, True),    # T % 8: the rule sends it to the fallback
    (20, True, True),
    (24, False, False),   # a kernel shape, the fallback called directly
])
def test_k12_fallback_matches_jax_wrapper_on_cpu(t, static, via_wrapper):
    c, m = 32, 64
    rng, norm, proj_in, proj_out = _geglu_case(8, c, m)
    x = rng.randn(2, t, c).astype(np.float32)
    g_scale = 0.02 if static else None
    p = K12.pack_geglu(norm, proj_in, proj_out, 0.05, g_scale)
    w1q, w2q, (s1, b1, s2, _, _, _) = _jax_operands(p)
    if via_wrapper:
        ref = jgeglu.fused_geglu_s8(jnp.asarray(x), w1q, s1, b1, w2q, s2,
                                    0.05, g_scale=g_scale)
        before = K12.fused_geglu_s8.fallbacks
        out = K12.fused_geglu_s8(_t(x), p)
        assert K12.fused_geglu_s8.fallbacks == before + 1
    else:
        ref = jgeglu._xla_geglu_s8(jnp.asarray(x), w1q, w2q,
                                   jnp.stack([s1, b1]), s2[None], 0.05,
                                   g_scale=g_scale)
        out = K12.geglu_s8_fallback(_t(x), p)
    assert out.dtype == torch.float32
    # fp32 on both sides: only the summation order and erf may differ
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# QuantLinear
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["static", "calibrated", "dynamic"])
def test_quant_linear_matches_quant_dense(mode):
    rng = np.random.RandomState(21)
    cin, cout = 24, 40
    w = (rng.randn(cin, cout) * 0.2).astype(np.float32)   # JAX [in, out]
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    x = rng.randn(2, 10, cin).astype(np.float32)
    act = None if mode == "dynamic" else 0.02
    src = torch.nn.Linear(cin, cout)
    with torch.no_grad():
        src.weight.copy_(_t(w.T))
        src.bias.copy_(_t(bias))
    lin = quant.QuantLinear(cin, cout, act_scale=act)
    with torch.no_grad():
        lin.bias.copy_(src.bias)
    lin.prepare(src)
    tree = jquant.prequantize_conv_tree(
        {"ff": {"proj_in": {"kernel": jnp.asarray(w),
                            "bias": jnp.asarray(bias)},
                "proj_out": {"kernel": jnp.asarray(w),
                             "bias": jnp.asarray(bias)}}},
        quantize_ff=True)
    leaf = tree["ff"]["proj_in"]
    _eq(lin.w_q.numpy(), np.asarray(leaf["kernel"]["q"]).T, "codes")
    _eq(lin.w_scale.numpy(), leaf["kernel"]["scale"], "scales")
    if mode == "calibrated":
        lin.x_scale = quant.f32(0.031)
        leaf = {"kernel": dict(leaf["kernel"], x_scale=jnp.float32(0.031)),
                "bias": leaf["bias"]}
    ref = jquant.QuantDense(cout, act_scale=act).apply(
        {"params": leaf}, jnp.asarray(x))
    with torch.no_grad():
        out = lin(_t(x))
    assert out.dtype == torch.float32 and out.shape == (2, 10, cout)
    # equal codes and exact int32 sums: fp32 rounding only
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the tiny UNet without fused norms
# ---------------------------------------------------------------------------
def _int8_kw(variant):
    """The JAX trainer's flags, which the port reads the same way, for
    variant (a) K13 + K12, (b) K13 + QuantDense, (c) K3 + QuantDense
    (trainer_ldm.py:163-176)."""
    fused_norms = variant == "c"
    return dict(use_int8_conv=True, int8_act_scale=0.05,
                use_int8_attention=not fused_norms,
                use_fused_attention=not fused_norms, use_int8_ff=True,
                use_fused_ff=variant == "a", use_fused_norms=fused_norms,
                use_padded_attention=fused_norms, int8_attn_act_scale=0.1)


@pytest.fixture(scope="module")
def tiny():
    unet = junet.UNet2DCondition(junet.UNetConfig(
        use_cross_attention=False, cond_channels=4, **TINY_KW))
    params = _random_params(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 6, 6, 12)),
        jnp.zeros((1,), jnp.int32)), 5)
    ucfg = UNetConfig(**TINY_KW)
    float_unet = UNet2DCondition(ucfg)
    float_unet.load_state_dict(convert.unet_state_dict_from_jax(params, ucfg))
    # an input at which no int8 code of the UNet lies within an fp32 ulp of
    # a rounding boundary: XLA and PyTorch round the float layers apart by
    # an ulp, and one flipped code moves the output by ~8e-3 of max|ref|
    # (seeds 6 and 7 have one; 8-12 none)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 6, 6, 12).astype(np.float32)
    t = np.array([999, 19])
    with torch.no_grad():
        scales = quant.calibrate_act_scale_tree(
            float_unet, _t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    return params, float_unet, x, t, scales


@pytest.mark.parametrize("calibrated", [False, True])
def test_unfused_weight_preparation_matches_jax_bit_for_bit(tiny,
                                                            calibrated):
    params, float_unet, _, _, scales = tiny
    kw = _int8_kw("a")
    int8_unet = UNet2DCondition(UNetConfig(**TINY_KW, **kw))
    # the calibration's attn1.to_q keys are taken and ignored
    quant.apply_act_scales(int8_unet, scales if calibrated else None)
    quant.prepare_int8_unet(int8_unet, float_unet)
    tree = jquant.prequantize_conv_tree(
        params, quantize_ff=True, absorbed_attention=False,
        attention_heads=TINY_KW["attention_head_dim"])
    if calibrated:
        tree = jquant.apply_act_scales(
            tree, {jax_path(k): v for k, v in scales.items()})
    n_lin = n_ff = 0
    for name, m in int8_unet.named_modules():
        if isinstance(m, quant.QuantLinear):
            k = _tree(tree, jax_path(name))["kernel"]
            _eq(m.w_q.numpy(), np.asarray(k["q"]).T, name)
            _eq(m.w_scale.numpy(), k["scale"], name)
            assert (m.x_scale is None) == ("x_scale" not in k), name
            if m.x_scale is not None:
                assert np.float32(m.x_scale) == k["x_scale"], name
            n_lin += 1
        elif isinstance(m, FeedForwardS8):
            # K12's pack: the QuantLinear codes, the masters' fp32 biases,
            # the sites' scales (net.0.proj's or 0.05, net.2's or dynamic)
            node = _tree(tree, jax_path(name))
            k1, k2 = node["proj_in"], node["proj_out"]
            p = m.pack
            assert p.w1 is m.net[0].proj.w_q and p.w2 is m.net[2].w_q
            _eq(p.b1.numpy(), k1["bias"], name)
            _eq(p.b2.numpy(), k2["bias"], name)
            assert np.float32(p.xs) == np.float32(
                k1["kernel"].get("x_scale", 0.05)), name
            assert (p.gs is None) == ("x_scale" not in k2["kernel"]), name
            n_ff += 1
        elif isinstance(m, BasicTransformerBlock):
            # the attention projections stay float (absorbed_attention off)
            at = _tree(tree, jax_path(name))["attn1"]
            assert not isinstance(at["to_q"]["kernel"], dict), name
    assert n_lin == 14 and n_ff == 7   # 7 blocks x (proj_in, proj_out)


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_unfused_int8_unet_matches_jax(tiny, variant, calibrated):
    params, float_unet, x, t, scales = tiny
    kw = _int8_kw(variant)
    heads = TINY_KW["attention_head_dim"]
    int8_unet = UNet2DCondition(UNetConfig(**TINY_KW, **kw))
    quant.apply_act_scales(int8_unet, scales if calibrated else None)
    quant.prepare_int8_unet(int8_unet, float_unet)
    tree = jquant.prequantize_conv_tree(
        params, quantize_ff=True, absorbed_attention=variant == "c",
        attention_heads=heads)
    if calibrated:
        # JAX drops attn1.to_q where to_q is float, as the port ignores it
        tree = jquant.apply_act_scales(
            tree, {jax_path(k): v for k, v in scales.items()})
    if variant == "c":
        tree = jquant.pack_inference_tiles(tree, attention_heads=heads,
                                           int8_act_scale=0.05,
                                           int8_attn_act_scale=0.1)
    junet8 = junet.UNet2DCondition(junet.UNetConfig(
        use_cross_attention=False, cond_channels=4, **TINY_KW, **kw))
    ref = np.asarray(jax.jit(junet8.apply)(tree, jnp.asarray(x),
                                           jnp.asarray(t)))
    counts = (K13.fused_self_attention_s8.fallbacks,
              K12.fused_geglu_s8.fallbacks,
              K13.ln_attention_s8.fallbacks)
    with torch.no_grad():
        out = int8_unet(_t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    out = out.permute(0, 2, 3, 1).numpy()
    # 6x6: T = 36 and 9, no multiple of 8, so every transformer site takes
    # the fallback on both sides (7 blocks: 2 down, 1 mid, 4 up)
    n_k13, n_k12, n_k3 = {"a": (7, 7, 0), "b": (7, 0, 0),
                          "c": (0, 0, 7)}[variant]
    assert (K13.fused_self_attention_s8.fallbacks - counts[0],
            K12.fused_geglu_s8.fallbacks - counts[1],
            K13.ln_attention_s8.fallbacks - counts[2]) == (n_k13, n_k12,
                                                          n_k3)
    # the same arithmetic in fp32 (equal codes, exact int32 sums): sites,
    # biases, the static-0.05 proj_out and the ignored to_q scale pinned
    # (measured 2e-7 to 7e-7 of max|ref|)
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


# ---------------------------------------------------------------------------
# the slice: unfused int8 sample_panoptic
# ---------------------------------------------------------------------------
STEPS = 2


@pytest.mark.parametrize("variant", ["a"])
def test_unfused_int8_sample_panoptic_against_jax(variant):
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    calib_noise = rng.randn(2, 4, 8, 4).astype(np.float32)
    heads = UNET_KW["attention_head_dim"]
    jcfg = dict(use_cross_attention=False, cond_channels=4, **UNET_KW)
    kw = _int8_kw(variant)
    unet = junet.UNet2DCondition(junet.UNetConfig(**jcfg))
    unet8 = junet.UNet2DCondition(junet.UNetConfig(**dict(jcfg, **kw)))
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

    # the JAX trainer's calibrate_int8 and _prequant without fused norms
    inp = jnp.concatenate([jnp.asarray(calib_noise), lat,
                           jnp.zeros((2, 4, 8, 4))], axis=-1)
    scales = jquant.calibrate_act_scale_tree(
        unet.apply, up, (inp, jnp.full((2,), 500, jnp.int32)))
    up8 = jquant.apply_act_scales(jquant.prequantize_conv_tree(
        up, quantize_ff=True, absorbed_attention=False,
        attention_heads=heads), scales)

    def jax_x0(model, params):
        def model_fn(latents, condition, t):
            x = jnp.concatenate([latents, lat, condition], axis=-1)
            return model.apply(params, x, t)
        return np.asarray(jax.jit(lambda z: jddim_sample(
            sched, model_fn, z, num_inference_steps=STEPS,
            self_condition=True))(jnp.asarray(init)))

    x0_f = jax_x0(unet, up)
    x0_8 = jax_x0(unet8, up8)

    sk = {"int8_inference": True, "fused_norms": False}
    if variant == "b":
        sk["fused_ff"] = False
    trainer = TrainerDiffusion(merge_dicts(CFG, {"sampling_kwargs": sk}),
                               unet_config=UNetConfig(**UNET_KW), device=CPU)
    trainer.load_jax_params(up, ip, sp)
    ours = trainer.calibrate_int8({"image": image}, noise=calib_noise)
    assert {jax_path(key) for key in ours} == set(scales)
    counts = (K13.fused_self_attention_s8.fallbacks,
              K12.fused_geglu_s8.fallbacks, K13.ln_attention_s8.fallbacks,
              K12.geglu_ln_s8.fallbacks)
    logits, x0 = trainer.sample_panoptic({"image": image}, init_noise=init,
                                         num_inference_steps=STEPS)
    # T = 32 and 8: every K13 and K12 site takes the kernels' plain
    # versions; no K3/K4 module is built
    assert (K13.fused_self_attention_s8.fallbacks,
            K12.fused_geglu_s8.fallbacks, K13.ln_attention_s8.fallbacks,
            K12.geglu_ln_s8.fallbacks) == counts
    assert logits.shape == (2, 32, 64, 24) and bool(torch.isfinite(
        logits).all())
    # JAX's CPU path takes its fallbacks (float attention, exact gelu, one
    # amax per tensor) where the port runs its kernels' plain versions, so
    # the port is held to a yardstick from the same run: its distance from
    # the JAX int8 result is well under the quantization's own effect
    quant_effect = _rel(x0_8, x0_f)
    assert quant_effect > 1e-3, "the int8 path changed nothing"
    err = _rel(x0.numpy(), x0_8)
    assert err <= 0.5 * quant_effect, (err, quant_effect)
