"""K8, K9 and K11 of the port against the JAX package on the CPU.

K8 (the int8 LN + attention block with Transformer2D's ``proj_in`` as a
bf16 prologue), K9 (the int8 LN + GEGLU block with ``proj_out`` as a bf16
epilogue) and K11 (the padded int8 attention without fused norms): each
plain version against its Pallas kernel in interpret mode at a kernel
shape, and each dispatch branch against the JAX wrapper on the CPU at a
ragged T; and 2 DDIM steps of the tiny trainer's ``sample_panoptic`` with
``use_fused_projs`` (the slice) against a composition of the JAX
functions. Inputs are made with numpy from a seed and handed to both
packages; each tolerance is stated with its reason where it is used.
"""

import dataclasses
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
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops import geglu as G  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_int8 import (  # noqa: E402
    INT8_KW, _attention_case, _geglu_case, _jax_operands, _kernel_close,
    _rel, _t, jax_path)
from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)

CPU = torch.device("cpu")


def _conv(rng, c):
    """A Transformer2D 1x1 proj conv with drawn weight and bias (the init
    leaves the bias 0, so a dropped bias would not show)."""
    conv = torch.nn.Conv2d(c, c, 1)
    with torch.no_grad():
        conv.weight.copy_(_t(rng.randn(c, c, 1, 1) * 0.2))
        conv.bias.copy_(_t(rng.randn(c) * 0.05))
    return conv


def _jax_proj(conv, dtype=jnp.float32):
    """The conv as JAX's fused-projs operand ``(w [C_in, C_out], b)``."""
    w = conv.weight.detach().numpy()[:, :, 0, 0].T
    return jnp.asarray(w, dtype), jnp.asarray(conv.bias.detach().numpy())


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
def test_k8_plain_version_matches_pallas_kernel_in_interpret_mode():
    b, t, heads, d = 2, 32, 4, 8
    c = heads * d
    rng, norm, attn, (g1, be1, bo), w8, scales = _attention_case(31, c,
                                                                 heads)
    conv = _conv(rng, c)
    # the GroupNorm output in bf16, as the UNet hands it to the kernel
    x = torch.from_numpy(rng.randn(b, t, c).astype(np.float32)).to(
        torch.bfloat16)
    act_scale = 0.04
    wpi, bpi = _jax_proj(conv, jnp.bfloat16)
    pack = jattn.pack_padded_ln_vt_tiles(
        *w8, scales, heads, d ** -0.5, act_scale, jnp.asarray(g1),
        jnp.asarray(be1), jnp.asarray(bo), proj_in_bias=bpi)
    ref = jattn._abs_padded_ln_s8_vt_pin_impl(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), wpi, pack["wqp"],
        pack["wkp"], pack["wvt"], pack["wo"], pack["m"], pack["g"],
        pack["sc"], heads, 1e-6, interpret=True)
    ref = np.asarray(ref, np.float32)
    p = S8.with_proj_in(S8.pack_ln_attention(norm, attn, heads, act_scale),
                        conv)
    # with the TPU kernel's softmax the plain arithmetic is the kernel's,
    # rounding point for rounding point (the prologue's exact bf16 products
    # summed in fp32)
    np.testing.assert_array_equal(
        S8.ln_attention_s8_pin_reference(x, p, static_offset=0.0).float()
        .numpy(), ref)
    out = S8.ln_attention_s8_pin_reference(x, p)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    # the port's row max: as K3 (tests/test_torch_port_int8.py), P rounds
    # to bf16 at another scale: mean tolerance 2.5e-3
    _kernel_close(out.float().numpy(), ref, mean_tol=2.5e-3)
    before = S8.ln_attention_s8_pin.fallbacks
    np.testing.assert_array_equal(
        S8.ln_attention_s8_pin(x, p).float().numpy(), out.float().numpy())
    # the channel-major view the UNet hands over: the same numbers
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    np.testing.assert_array_equal(
        S8.ln_attention_s8_pin(xt, p).float().numpy(), out.float().numpy())
    assert S8.ln_attention_s8_pin.fallbacks == before


@pytest.mark.parametrize("static", [False, True])
def test_k9_plain_version_matches_pallas_kernel_in_interpret_mode(static):
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
    # _geglu_ln_pout_impl takes no interpret flag: the same pallas_call
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
    out = G.geglu_ln_s8_pout_reference(_t(x), p)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    # K4's tolerance (tests/test_torch_port_int8.py): the tanh gelu and
    # the sums in another order move a rare interior code
    _kernel_close(out.float().numpy(), ref)
    before = G.geglu_ln_s8_pout.fallbacks
    np.testing.assert_array_equal(G.geglu_ln_s8_pout(_t(x), p).numpy(),
                                  out.float().numpy())
    assert G.geglu_ln_s8_pout.fallbacks == before


def test_k11_plain_version_matches_pallas_kernel_in_interpret_mode():
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
    out = S8.padded_attention_s8_reference(_t(x), p)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    # the same rounding points, the same int8 codes and int32 sums
    np.testing.assert_array_equal(out.float().numpy(), ref)
    before = S8.padded_attention_s8.fallbacks
    np.testing.assert_array_equal(
        S8.padded_attention_s8(_t(x), p).numpy(), out.float().numpy())
    assert S8.padded_attention_s8.fallbacks == before


# ---------------------------------------------------------------------------
# the fallbacks against the JAX wrappers on the CPU
# ---------------------------------------------------------------------------
def _k8_case(t, seed=7):
    heads, d = 4, 8
    c = heads * d
    rng, norm, attn, (g1, be1, bo), w8, scales = _attention_case(seed, c,
                                                                 heads)
    conv = _conv(rng, c)
    x = rng.randn(2, t, c).astype(np.float32)
    ref = jattn.absorbed_padded_ln_self_attention_s8(
        jnp.asarray(x), jnp.asarray(g1), jnp.asarray(be1), jnp.asarray(bo),
        *w8, scales, heads, d ** -0.5, 0.1, proj_in=_jax_proj(conv))
    p = S8.with_proj_in(S8.pack_ln_attention(norm, attn, heads, 0.1), conv)
    return x, ref, p, S8.ln_attention_s8_pin, S8.ln_attention_s8_pin_fallback


def _k9_case(t, seed=5):
    c, m = 32, 64
    rng, norm, proj_in, proj_out = _geglu_case(seed, c, m)
    conv = _conv(rng, c)
    x = rng.randn(2, t, c).astype(np.float32)
    p = G.with_proj_out(G.pack_geglu(norm, proj_in, proj_out, 0.05), conv)
    w1q, w2q, (s1, b1, s2, b2, lw, lb) = _jax_operands(p)
    ref = jgeglu.fused_geglu_ln_s8(jnp.asarray(x), lw, lb, w1q, s1, b1, w2q,
                                   s2, b2, 0.05, proj_out=_jax_proj(conv))
    return x, ref, p, G.geglu_ln_s8_pout, G.geglu_ln_s8_pout_fallback


def _k11_case(t, seed=9):
    heads, d = 4, 8
    c = heads * d
    rng, _, attn, _, w8, scales = _attention_case(seed, c, heads)
    x = rng.randn(2, t, c).astype(np.float32)
    ref = jattn.absorbed_padded_self_attention_s8(
        jnp.asarray(x), *w8, scales, heads, d ** -0.5, 0.1)
    p = S8.pack_padded_attention(attn, heads, 0.1)
    return (x, ref, p, S8.padded_attention_s8,
            S8.padded_attention_s8_fallback)


@pytest.mark.parametrize("kernel,t,via_wrapper", [
    ("K8", 30, True),     # T % 8: the rule sends it to the fallback
    ("K8", 32, False),    # a kernel shape, the fallback called directly
    ("K9", 20, True),
    ("K9", 24, False),
    ("K11", 30, True),
    ("K11", 32, False),
])
def test_fallback_matches_jax_wrapper_on_cpu(kernel, t, via_wrapper):
    case = {"K8": _k8_case, "K9": _k9_case, "K11": _k11_case}[kernel]
    x, ref, p, wrapper, fallback = case(t)
    before = wrapper.fallbacks
    if via_wrapper:
        out = wrapper(_t(x), p)
        assert wrapper.fallbacks == before + 1
    else:
        out = fallback(_t(x), p)
    assert out.dtype == torch.float32 and out.shape == x.shape
    # fp32 on both sides (the projs on the float32 weights): only the
    # summation order and erf may differ
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the slice: int8 sample_panoptic with fused projs
# ---------------------------------------------------------------------------
STEPS = 2


def test_fused_projs_sample_panoptic_against_jax():
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    calib_noise = rng.randn(2, 4, 8, 4).astype(np.float32)
    heads = UNET_KW["attention_head_dim"]
    jcfg = dict(use_cross_attention=False, cond_channels=4, **UNET_KW)
    unet = junet.UNet2DCondition(junet.UNetConfig(**jcfg))
    unet8 = junet.UNet2DCondition(junet.UNetConfig(**dict(
        jcfg, **INT8_KW, use_fused_projs=True)))
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

    # the JAX trainer's calibrate_int8 and _prequant (which packs without
    # fuse_projs: on the CPU its fallbacks take the raw proj biases)
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
    x0_8 = jax_x0(unet8, up8)

    cfg = merge_dicts(CFG, {"sampling_kwargs": {"int8_inference": True}})
    trainer = TrainerDiffusion(cfg, unet_config=dataclasses.replace(
        UNetConfig(**UNET_KW), use_fused_projs=True), device=CPU)
    trainer.load_jax_params(up, ip, sp)
    ours = trainer.calibrate_int8({"image": image}, noise=calib_noise)
    assert {jax_path(key) for key in ours} == set(scales)
    counters = (S8.ln_attention_s8, G.geglu_ln_s8, S8.ln_attention_s8_pin,
                G.geglu_ln_s8_pout)
    before = [f.fallbacks for f in counters]
    logits, x0 = trainer.sample_panoptic({"image": image}, init_noise=init,
                                         num_inference_steps=STEPS)
    # d = 4 at the first level: the rule sends those K8 sites (one down,
    # two up) to the fallback, one UNet pass per step; K9 takes all; no
    # K3 or K4 module is built
    assert [f.fallbacks - n for f, n in zip(counters, before)] == [
        0, 0, 3 * STEPS, 0]
    assert logits.shape == (2, 32, 64, 24) and bool(torch.isfinite(
        logits).all())
    # as tests/test_torch_port_int8.py: JAX's CPU path takes its fallbacks
    # where the port runs its kernels' plain versions, so the port is held
    # to a yardstick from the same run, well under the quantization's own
    # effect
    quant_effect = _rel(x0_8, x0_f)
    assert quant_effect > 1e-3, "the int8 path changed nothing"
    err = _rel(x0.numpy(), x0_8)
    assert err <= 0.5 * quant_effect, (err, quant_effect)
