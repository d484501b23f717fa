"""``UNetConfig.use_packed_attention`` in the port against the JAX package on
the CPU.

The tiny UNet with the flag (K14's plain version at T = 64 and 16, its
fallback at T = 36 and 9) in fp32 and bf16, one tiny train step's loss and
every UNet gradient (K14's backward on K2's arithmetic), the tiny unfused
int8 UNet with the flag (K15's sites at fallback shapes, K15's own
arithmetic being pinned by ``test_torch_port_packed_kernels.py``), the
flags' precedence, K15's dynamic scales, and 2 DDIM steps of the tiny
trainer's ``sample_panoptic`` with the flag, float and int8 without fused
norms, against compositions of the JAX functions. Inputs are made with
numpy from a seed and handed to both packages; each tolerance is stated
with its reason where it is used.
"""

import copy
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models import unet as junet  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models import unet as U  # noqa: E402
from ldmseg_torch.models.unet import (  # noqa: E402
    CrossAttention, LNAttentionS8, LNFeedForwardS8, PaddedAttentionS8,
    UNet2DCondition, UNetConfig)
from ldmseg_torch.ops import attention as A  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops import geglu as G  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_int8 import TINY_KW, _rel, _t, jax_path  # noqa: E402
from test_torch_port_int8_unfused import _int8_kw  # noqa: E402
from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)
import test_torch_port_training as training  # noqa: E402
from test_torch_port_training import (  # noqa: E402,F401
    step_inputs, unet_params)

CPU = torch.device("cpu")
PACKED = dict(use_fused_attention=True, use_packed_attention=True)


def _jax_tiny(**flags):
    return junet.UNet2DCondition(junet.UNetConfig(
        use_cross_attention=False, cond_channels=4, **TINY_KW, **flags))


def _max_close(out, ref, tol):
    """max |out - ref| <= tol * max|ref|."""
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= tol * float(np.abs(ref).max()), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny():
    params = _random_params(lambda: _jax_tiny().init(
        jax.random.key(0), jnp.zeros((1, 6, 6, 12)),
        jnp.zeros((1,), jnp.int32)), 5)
    ucfg = UNetConfig(**TINY_KW, **PACKED)
    unet = UNet2DCondition(ucfg)
    # the flag adds no parameter: the JAX tree loads strictly
    unet.load_state_dict(convert.unet_state_dict_from_jax(params, ucfg),
                         strict=True)
    return params, unet


def _count_calls(monkeypatch, names):
    """Count the calls the UNet module makes to each of its attention
    functions ``names`` (on the CPU no kernel counter moves)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(U, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(U, name, counted)
    return calls


# ---------------------------------------------------------------------------
# the tiny UNet with the flag
# ---------------------------------------------------------------------------
# 8x8: T = 64 and 16, K14's plain version at every site; 6x6: T = 36 and 9,
# no multiple of 8, the rule's fallback (_xla_btc) at every site
@pytest.mark.parametrize("hw,fallbacks", [(8, 0), (6, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_unet_with_packed_attention_matches_jax(tiny, monkeypatch, hw,
                                                     fallbacks, dtype):
    params, unet = tiny
    rng = np.random.RandomState(hw)
    x = rng.randn(2, hw, hw, 12).astype(np.float32)
    t = np.array([999, 19])
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    ref = np.asarray(jax.jit(_jax_tiny(**PACKED).apply)(
        jparams, jnp.asarray(x, jdt), jnp.asarray(t)).astype(jnp.float32))
    calls = _count_calls(monkeypatch, ["fused_self_attention_packed",
                                       "fused_self_attention"])
    before = A.fused_self_attention_packed.fallbacks
    with torch.no_grad():
        out = copy.deepcopy(unet).to(tdt)(
            _t(x).permute(0, 3, 1, 2).to(tdt), torch.from_numpy(t))
    # 7 transformer blocks (2 down, 1 mid, 4 up), every one on K14's wrapper
    # although use_fused_attention is set: packed wins, as in JAX
    assert calls == {"fused_self_attention_packed": 7,
                     "fused_self_attention": 0}
    assert A.fused_self_attention_packed.fallbacks == before + fallbacks
    out = out.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        # fp32 on both sides; the plain version's softmax and XLA's in
        # another order (measured below 1e-6 of max|ref|)
        _max_close(out, ref, 1e-5)
    else:
        # bf16 through the whole UNet: XLA and PyTorch round the convs, the
        # norms and the attention's scores (JAX's CPU path takes _xla_btc,
        # bf16 scores; the port K14's fp32 scores at 8x8) at other places,
        # so the two bf16 outputs differ by about bf16's own error: 4e-2 of
        # max|ref| (measured 2.2e-2 and 2.1e-2); and the port's bf16 output
        # is no further from JAX's fp32 one than 1.5x JAX's bf16 output is
        # (measured 0.93x and 1.12x)
        _max_close(out, ref, 4e-2)
        jref = np.asarray(jax.jit(_jax_tiny(**PACKED).apply)(
            params, jnp.asarray(x), jnp.asarray(t)))
        assert np.abs(out - jref).max() <= 1.5 * np.abs(ref - jref).max()


def test_train_step_with_packed_attention_matches_jax(
        monkeypatch, unet_params, step_inputs):
    # one tiny train step (test_torch_port_training's composition) with the
    # JAX UNet built with use_packed_attention, whose CPU path takes
    # _xla_btc and XLA's VJP of it; the port's forward takes K14's plain
    # version (T = 32 and 8), its backward K2's arithmetic. fp32: loss to
    # 1e-5 relative, every UNet gradient to 1e-4 of its largest value
    _, ip, _, sp, batch, noise, timesteps = step_inputs
    monkeypatch.setattr(training, "UNET_KW",
                        dict(UNET_KW, use_packed_attention=True))
    ref_loss, ref_grads = training._jax_step(unet_params, step_inputs)
    trainer = TrainerDiffusion(CFG, unet_config=UNetConfig(
        **UNET_KW, use_packed_attention=True), device=CPU)
    trainer.load_jax_params(unet_params, ip, sp)
    calls = _count_calls(monkeypatch, ["fused_self_attention_packed",
                                       "fused_self_attention"])
    before = A.fused_self_attention_packed.fallbacks
    loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                          timesteps=timesteps)
    # 4 blocks (1 down, 1 mid, 2 up) x 2 passes, no fallback
    assert calls == {"fused_self_attention_packed": 8,
                     "fused_self_attention": 0}
    assert A.fused_self_attention_packed.fallbacks == before
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = convert.unet_state_dict_from_jax(ref_grads, trainer.unet_config)
    attn = 0
    for name, p in trainer.unet.named_parameters():
        assert p.grad is not None, name
        scale = float(ref[name].abs().max())
        if name.endswith(("to_q.weight", "to_k.weight", "to_v.weight")):
            attn += 1
            assert scale > 0 and float(p.grad.abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)
    assert attn == 12


# ---------------------------------------------------------------------------
# the tiny unfused int8 UNet with the flag
# ---------------------------------------------------------------------------
def _int8_unet(float_unet, kw, scales=None):
    unet = UNet2DCondition(UNetConfig(**TINY_KW, **kw))
    quant.apply_act_scales(unet, scales)
    quant.prepare_int8_unet(unet, float_unet)
    return unet


@pytest.mark.parametrize("calibrated", [False, True])
def test_tiny_unfused_int8_unet_with_packed_attention_matches_jax(
        tiny, calibrated):
    params, float_unet = tiny
    kw = dict(_int8_kw("a"), use_packed_attention=True)
    heads = TINY_KW["attention_head_dim"]
    # an input at which no int8 code lies within an fp32 ulp of a rounding
    # boundary (test_torch_port_int8_unfused.py's seed)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 6, 6, 12).astype(np.float32)
    t = np.array([999, 19])
    scales = None
    tree = jquant.prequantize_conv_tree(params, quantize_ff=True,
                                        absorbed_attention=False,
                                        attention_heads=heads)
    if calibrated:
        with torch.no_grad():
            scales = quant.calibrate_act_scale_tree(
                float_unet, _t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
        tree = jquant.apply_act_scales(
            tree, {jax_path(k): v for k, v in scales.items()})
    int8_unet = _int8_unet(float_unet, kw, scales)
    ref = np.asarray(jax.jit(_jax_tiny(**kw).apply)(
        tree, jnp.asarray(x), jnp.asarray(t)))
    counts = (S8.fused_self_attention_packed_s8.fallbacks,
              S8.fused_self_attention_s8.fallbacks,
              G.fused_geglu_s8.fallbacks)
    with torch.no_grad():
        out = int8_unet(_t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    # 6x6: T = 36 and 9, so every K15 and K12 site takes the fallback on
    # both sides (7 blocks); K13 is not reached: packed wins
    assert (S8.fused_self_attention_packed_s8.fallbacks - counts[0],
            S8.fused_self_attention_s8.fallbacks - counts[1],
            G.fused_geglu_s8.fallbacks - counts[2]) == (7, 0, 7)
    # the same arithmetic in fp32 (equal codes, exact int32 sums), as the
    # unfused int8 UNet without the flag
    _max_close(out.permute(0, 2, 3, 1).numpy(), ref, 1e-5)


def test_packed_flag_precedence(tiny):
    params, float_unet = tiny

    def attns(unet):
        return [blk.attn1 for blk in unet.modules()
                if isinstance(blk, U.BasicTransformerBlock)]
    # with fused norms the block is K3 + K4 and the flag does nothing
    fused = UNet2DCondition(UNetConfig(
        **TINY_KW, **dict(_int8_kw("c"), use_fused_ff=True,
                          use_packed_attention=True)))
    blocks = [m for m in fused.modules()
              if isinstance(m, U.BasicTransformerBlock)]
    assert len(blocks) == 7
    assert all(b.fuse_attn and isinstance(b.attn1, LNAttentionS8)
               and isinstance(b.ff, LNFeedForwardS8) for b in blocks)
    assert not any(isinstance(m, CrossAttention) for m in fused.modules())
    # padded attention without fused norms wins over packed (K11)
    padded = UNet2DCondition(UNetConfig(
        **TINY_KW, **dict(_int8_kw("a"), use_padded_attention=True,
                          use_packed_attention=True)))
    assert all(isinstance(a, PaddedAttentionS8) for a in attns(padded))
    # packed wins over use_fused_attention: K15 (int8) and K14 (float)
    for kw, int8 in ((dict(_int8_kw("a"), use_packed_attention=True), True),
                     (PACKED, False)):
        unet = UNet2DCondition(UNetConfig(**TINY_KW, **kw))
        for a in attns(unet):
            assert type(a) is CrossAttention and a.packed and a.use_fused
            assert a.int8 == int8
    # the trainer carries the flag into both of its UNets
    cfg = merge_dicts(CFG, {"sampling_kwargs": {"int8_inference": True,
                                                "fused_norms": False}})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(
        **UNET_KW, use_packed_attention=True), device=CPU)
    for unet, int8 in ((trainer.unet, False), (trainer._unet_int8, True)):
        assert unet.config.use_packed_attention
        assert all(a.packed and a.int8 == int8 for a in attns(unet))


def test_k15_ignores_the_static_scale_and_the_to_q_site(tiny):
    # at 8x8 (T = 64 and 16) every site takes K15's plain version
    params, float_unet = tiny
    rng = np.random.RandomState(3)
    x = _t(rng.randn(2, 12, 8, 8))
    t = torch.tensor([999, 19])
    to_q = {f"{name}.attn1.to_q": 0.37 for name, m in
            float_unet.named_modules()
            if isinstance(m, U.BasicTransformerBlock)}
    assert len(to_q) == 7

    def run(**kw):
        scales = kw.pop("scales", None)
        unet = _int8_unet(float_unet, dict(_int8_kw("a"), **kw), scales)
        with torch.no_grad():
            return unet(x, t)
    base = run(use_packed_attention=True)
    # K15: the same output whatever int8_attn_act_scale and the to_q sites
    # say (the wrapper has no static scale; to_q is a float leaf)
    assert torch.equal(base, run(use_packed_attention=True,
                                 int8_attn_act_scale=0.5))
    assert torch.equal(base, run(use_packed_attention=True, scales=to_q))
    # K13 (no packed) reads int8_attn_act_scale: the check has teeth
    assert not torch.equal(run(), run(int8_attn_act_scale=0.5))


# ---------------------------------------------------------------------------
# the slice: 2 DDIM steps of sample_panoptic with the flag
# ---------------------------------------------------------------------------
STEPS = 2


@pytest.fixture(scope="module")
def slice_jax():
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    calib_noise = rng.randn(2, 4, 8, 4).astype(np.float32)
    heads = UNET_KW["attention_head_dim"]
    jcfg = dict(use_cross_attention=False, cond_channels=4, **UNET_KW,
                use_packed_attention=True)
    unet = junet.UNet2DCondition(junet.UNetConfig(**jcfg))
    unet8 = junet.UNet2DCondition(junet.UNetConfig(**dict(
        jcfg, **_int8_kw("a"))))
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

    return dict(image=image, init=init, calib_noise=calib_noise, up=up,
                ip=ip, sp=sp, scales=scales, x0_f=jax_x0(unet, up),
                x0_8=jax_x0(unet8, up8))


def _slice_trainer(j, **sk):
    cfg = merge_dicts(CFG, {"sampling_kwargs": sk})
    trainer = TrainerDiffusion(cfg, unet_config=dataclasses.replace(
        UNetConfig(**UNET_KW), use_packed_attention=True), device=CPU)
    trainer.load_jax_params(j["up"], j["ip"], j["sp"])
    return trainer


def test_sample_panoptic_with_packed_attention_against_jax(slice_jax):
    j = slice_jax
    trainer = _slice_trainer(j)
    before = A.fused_self_attention_packed.fallbacks
    logits, x0 = trainer.sample_panoptic({"image": j["image"]},
                                         init_noise=j["init"],
                                         num_inference_steps=STEPS)
    # T = 32 and 8: K14's plain version at every site
    assert A.fused_self_attention_packed.fallbacks == before
    assert logits.shape == (2, 32, 64, 24) and bool(torch.isfinite(
        logits).all())
    # fp32 through 2 steps x 2 UNet passes (test_torch_port_sampling's
    # 1e-3 on the logits; here on x0, the UNet's own output)
    _max_close(x0.numpy(), j["x0_f"], 1e-4)


def test_int8_sample_panoptic_with_packed_attention_against_jax(slice_jax):
    j = slice_jax
    trainer = _slice_trainer(j, int8_inference=True, fused_norms=False)
    ours = trainer.calibrate_int8({"image": j["image"]},
                                  noise=j["calib_noise"])
    assert {jax_path(key) for key in ours} == set(j["scales"])
    counts = (S8.fused_self_attention_packed_s8.fallbacks,
              S8.fused_self_attention_s8.fallbacks,
              G.fused_geglu_s8.fallbacks)
    logits, x0 = trainer.sample_panoptic({"image": j["image"]},
                                         init_noise=j["init"],
                                         num_inference_steps=STEPS)
    # T = 32 and 8: every K15 and K12 site takes the kernels' plain
    # versions, no K13 is built
    assert (S8.fused_self_attention_packed_s8.fallbacks,
            S8.fused_self_attention_s8.fallbacks,
            G.fused_geglu_s8.fallbacks) == counts
    assert logits.shape == (2, 32, 64, 24) and bool(torch.isfinite(
        logits).all())
    # JAX's CPU path takes its fallbacks (float attention where K15 would
    # quantize) where the port runs the kernels' plain versions: held to
    # half the quantization's own effect, as the other int8 slices are
    quant_effect = _rel(j["x0_8"], j["x0_f"])
    assert quant_effect > 1e-3, "the int8 path changed nothing"
    assert _rel(x0.numpy(), j["x0_8"]) <= 0.5 * quant_effect
