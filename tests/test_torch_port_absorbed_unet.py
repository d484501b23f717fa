"""``UNetConfig.use_absorbed_attention`` in the port against the JAX package
on the CPU.

The tiny UNet with the flag (K16's plain version at T = 64 and 16, its
fallback at T = 36 and 9) in fp32 and bf16, one tiny train step's loss and
every UNet gradient (K16's backward on K2's arithmetic), the tiny unfused
int8 UNet with the flag (K17's sites at fallback shapes, K17's own
arithmetic being pinned by ``test_torch_port_absorbed_kernels.py``), the
flags' precedence, the act scale K17 takes (the trainer's, and the
calibrated ``to_q`` site with the absorbed storage of
``prequantize_conv_tree(absorbed_attention=True)``), and 2 DDIM steps of
the tiny trainer's ``sample_panoptic`` with the flag against a composition
of the JAX functions. Inputs are made with numpy from a seed and handed to
both packages; each tolerance is stated with its reason where it is used.
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
    AbsorbedAttentionS8, CrossAttention, LNAttentionS8, LNFeedForwardS8,
    PaddedAttentionS8, UNet2DCondition, UNetConfig)
from ldmseg_torch.ops import attention as A  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops import geglu as G  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_int8 import TINY_KW, _t, jax_path  # noqa: E402
from test_torch_port_int8_unfused import _int8_kw  # noqa: E402
from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)
import test_torch_port_training as training  # noqa: E402
from test_torch_port_training import (  # noqa: E402,F401
    step_inputs, unet_params)

CPU = torch.device("cpu")
ABSORBED = dict(use_fused_attention=True, use_absorbed_attention=True)


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
    ucfg = UNetConfig(**TINY_KW, **ABSORBED)
    unet = UNet2DCondition(ucfg)
    # the flag adds no parameter: the JAX tree loads strictly, with no new
    # or missing key
    sd = convert.unet_state_dict_from_jax(params, ucfg)
    assert set(sd) == set(unet.state_dict())
    unet.load_state_dict(sd, strict=True)
    return params, unet


@pytest.fixture(scope="module")
def jax_out(tiny):
    """JAX's tiny UNet with the flag on the input of latent size ``hw`` in
    ``dtype``, computed once per (hw, dtype) for the module's tests."""
    params, _ = tiny
    cache = {}

    def out(hw, dtype):
        if (hw, dtype) not in cache:
            x = np.random.RandomState(hw).randn(2, hw, hw, 12).astype(
                np.float32)
            jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
            jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt),
                                             params)
            cache[hw, dtype] = np.asarray(jax.jit(_jax_tiny(
                **ABSORBED).apply)(jparams, jnp.asarray(x, jdt), jnp.asarray(
                    [999, 19])).astype(jnp.float32))
        return cache[hw, dtype]
    return out


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


def _attns(unet):
    return [blk.attn1 for blk in unet.modules()
            if isinstance(blk, U.BasicTransformerBlock)]


# ---------------------------------------------------------------------------
# the tiny UNet with the flag
# ---------------------------------------------------------------------------
# 8x8: T = 64 and 16, K16's plain version at every site; 6x6: T = 36 and 9,
# no multiple of 8, the rule's fallback (_xla_absorbed) at every site
@pytest.mark.parametrize("hw,fallbacks", [(8, 0), (6, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_unet_with_absorbed_attention_matches_jax(
        tiny, jax_out, monkeypatch, hw, fallbacks, dtype):
    _, unet = tiny
    x = np.random.RandomState(hw).randn(2, hw, hw, 12).astype(np.float32)
    t = np.array([999, 19])
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_out(hw, dtype)
    calls = _count_calls(monkeypatch, ["absorbed_self_attention",
                                       "fused_self_attention_packed",
                                       "fused_self_attention"])
    before = A.absorbed_self_attention.fallbacks
    with torch.no_grad():
        out = copy.deepcopy(unet).to(tdt)(
            _t(x).permute(0, 3, 1, 2).to(tdt), torch.from_numpy(t))
    # 7 transformer blocks (2 down, 1 mid, 4 up), every one on K16's wrapper
    # although use_fused_attention is set: absorbed wins, as in JAX
    assert calls == {"absorbed_self_attention": 7,
                     "fused_self_attention_packed": 0,
                     "fused_self_attention": 0}
    assert A.absorbed_self_attention.fallbacks == before + fallbacks
    out = out.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        # fp32 on both sides; the plain version's products and softmax and
        # XLA's in another order: 1e-5 of max|ref|
        _max_close(out, ref, 1e-5)
    else:
        # bf16 through the whole UNet: XLA and PyTorch round the convs, the
        # norms and the attention (JAX's CPU path takes _xla_absorbed, bf16
        # scores; the port K16's fp32 scores at 8x8) at other places, so
        # the two bf16 outputs differ by about bf16's own error: 4e-2 of
        # max|ref| (the packed flag's tolerance); and the port's bf16 output
        # is no further from JAX's fp32 one than 1.5x JAX's bf16 output is
        _max_close(out, ref, 4e-2)
        jref = jax_out(hw, "float32")
        assert np.abs(out - jref).max() <= 1.5 * np.abs(ref - jref).max()


def test_train_step_with_absorbed_attention_matches_jax(
        monkeypatch, unet_params, step_inputs):
    # one tiny train step (test_torch_port_training's composition) with the
    # JAX UNet built with use_absorbed_attention, whose CPU path takes
    # _xla_absorbed and XLA's VJP of it; the port's forward takes K16's
    # plain version at the mid block (C = 16, d = 8, T = 8) and the
    # fallback at the C = 8 blocks (d = 4), its backward K2's arithmetic
    # there. fp32: loss to 1e-5 relative, every UNet gradient to 1e-4 of
    # its largest value
    _, ip, _, sp, batch, noise, timesteps = step_inputs
    monkeypatch.setattr(training, "UNET_KW",
                        dict(UNET_KW, use_absorbed_attention=True))
    ref_loss, ref_grads = training._jax_step(unet_params, step_inputs)
    trainer = TrainerDiffusion(CFG, unet_config=UNetConfig(
        **UNET_KW, use_absorbed_attention=True), device=CPU)
    trainer.load_jax_params(unet_params, ip, sp)
    calls = _count_calls(monkeypatch, ["absorbed_self_attention",
                                       "fused_self_attention"])
    before = A.absorbed_self_attention.fallbacks
    loss, _, _ = trainer.forward_backward(batch, noise=noise,
                                          timesteps=timesteps)
    # 4 blocks (1 down, 1 mid, 2 up) x 2 passes; 3 of each pass's 4 fall
    # back (d = 4)
    assert calls == {"absorbed_self_attention": 8,
                     "fused_self_attention": 0}
    assert A.absorbed_self_attention.fallbacks == before + 6
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    ref = convert.unet_state_dict_from_jax(ref_grads, trainer.unet_config)
    attn = 0
    for name, p in trainer.unet.named_parameters():
        assert p.grad is not None, name
        scale = float(ref[name].abs().max())
        if name.endswith(("to_q.weight", "to_k.weight", "to_v.weight",
                          "to_out.0.weight")):
            attn += 1
            assert scale > 0 and float(p.grad.abs().max()) > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)
    assert attn == 16


# ---------------------------------------------------------------------------
# the tiny unfused int8 UNet with the flag
# ---------------------------------------------------------------------------
def _int8_unet(float_unet, kw, scales=None, absorbed_attention=False):
    unet = UNet2DCondition(UNetConfig(**TINY_KW, **kw))
    quant.apply_act_scales(unet, scales)
    quant.prepare_int8_unet(unet, float_unet,
                            absorbed_attention=absorbed_attention)
    return unet


@pytest.mark.parametrize("calibrated", [False, True])
def test_tiny_unfused_int8_unet_with_absorbed_attention_matches_jax(
        tiny, calibrated):
    params, float_unet = tiny
    kw = dict(_int8_kw("a"), use_absorbed_attention=True)
    heads = TINY_KW["attention_head_dim"]
    # an input at which no int8 code lies within an fp32 ulp of a rounding
    # boundary (test_torch_port_int8_unfused.py's seed)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 6, 6, 12).astype(np.float32)
    t = np.array([999, 19])
    scales = None
    # the JAX trainer's storage without fused norms: attn1 keeps float
    # leaves, so JAX's _absorbed takes its in-graph int8 branch
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
    assert all(isinstance(a, AbsorbedAttentionS8) for a in _attns(int8_unet))
    ref = np.asarray(jax.jit(_jax_tiny(**kw).apply)(
        tree, jnp.asarray(x), jnp.asarray(t)))
    counts = (S8.absorbed_self_attention_s8.fallbacks,
              S8.fused_self_attention_s8.fallbacks,
              G.fused_geglu_s8.fallbacks)
    with torch.no_grad():
        out = int8_unet(_t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    # 6x6: T = 36 and 9, so every K17 and K12 site takes the fallback on
    # both sides (7 blocks); K13 is not reached: absorbed wins
    assert (S8.absorbed_self_attention_s8.fallbacks - counts[0],
            S8.fused_self_attention_s8.fallbacks - counts[1],
            G.fused_geglu_s8.fallbacks - counts[2]) == (7, 0, 7)
    # the same arithmetic in fp32 (equal codes, exact int32 sums), as the
    # unfused int8 UNet without the flag: 1e-5 of max|ref|
    _max_close(out.permute(0, 2, 3, 1).numpy(), ref, 1e-5)


def test_absorbed_flag_precedence(tiny, monkeypatch):
    params, float_unet = tiny
    # with fused norms the block is K3 + K4 and the flag does nothing
    fused = UNet2DCondition(UNetConfig(
        **TINY_KW, **dict(_int8_kw("c"), use_fused_ff=True,
                          use_absorbed_attention=True)))
    blocks = [m for m in fused.modules()
              if isinstance(m, U.BasicTransformerBlock)]
    assert len(blocks) == 7
    assert all(b.fuse_attn and isinstance(b.attn1, LNAttentionS8)
               and isinstance(b.ff, LNFeedForwardS8) for b in blocks)
    assert not any(isinstance(m, CrossAttention) for m in fused.modules())
    # padded attention without fused norms wins over absorbed (K11)
    padded = UNet2DCondition(UNetConfig(
        **TINY_KW, **dict(_int8_kw("a"), use_padded_attention=True,
                          use_absorbed_attention=True)))
    assert all(type(a) is PaddedAttentionS8 for a in _attns(padded))
    # absorbed wins over packed and use_fused_attention: K17 (int8) and
    # K16 (float)
    int8 = UNet2DCondition(UNetConfig(
        **TINY_KW, **dict(_int8_kw("a"), use_absorbed_attention=True,
                          use_packed_attention=True)))
    assert all(type(a) is AbsorbedAttentionS8 for a in _attns(int8))
    unet = UNet2DCondition(UNetConfig(**TINY_KW, **ABSORBED,
                                      use_packed_attention=True))
    assert all(type(a) is CrossAttention and a.absorbed for a in
               _attns(unet))
    unet.load_state_dict(float_unet.state_dict())
    calls = _count_calls(monkeypatch, ["absorbed_self_attention",
                                       "fused_self_attention_packed",
                                       "fused_self_attention"])
    with torch.no_grad():
        unet(torch.zeros((1, 12, 8, 8)), torch.tensor([5]))
    assert calls == {"absorbed_self_attention": 7,
                     "fused_self_attention_packed": 0,
                     "fused_self_attention": 0}
    # the trainer carries the flag into both of its UNets
    cfg = merge_dicts(CFG, {"sampling_kwargs": {"int8_inference": True,
                                                "fused_norms": False}})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(
        **UNET_KW, use_absorbed_attention=True), device=CPU)
    assert trainer.unet.config.use_absorbed_attention
    assert trainer._unet_int8.config.use_absorbed_attention
    assert all(type(a) is CrossAttention and a.absorbed
               for a in _attns(trainer.unet))
    assert all(type(a) is AbsorbedAttentionS8
               for a in _attns(trainer._unet_int8))
    # K17 is inference only
    with pytest.raises(RuntimeError, match="inference only"):
        _int8_unet(float_unet, dict(_int8_kw("a"),
                                    use_absorbed_attention=True))(
            torch.zeros((1, 12, 8, 8), requires_grad=True),
            torch.tensor([5]))


def test_k17_act_scale_follows_the_storage(tiny):
    # at 8x8 (T = 64 and 16) every site takes K17's plain version
    params, float_unet = tiny
    heads = TINY_KW["attention_head_dim"]
    kw = dict(_int8_kw("a"), use_absorbed_attention=True)
    rng = np.random.RandomState(3)
    x = _t(rng.randn(2, 12, 8, 8))
    t = torch.tensor([999, 19])
    names = [name for name, m in float_unet.named_modules()
             if isinstance(m, U.BasicTransformerBlock)]
    to_q = {f"{name}.attn1.to_q": 0.37 for name in names}
    assert len(to_q) == 7

    def run(unet):
        with torch.no_grad():
            return unet(x, t)
    trainer_like = _int8_unet(float_unet, kw)
    base = run(trainer_like)
    assert {a.pack.xs for a in _attns(trainer_like)} == {quant.f32(0.1)}
    # the trainer's storage (float leaves, JAX's in-graph branch): a
    # calibrated to_q site changes nothing
    ignored = _int8_unet(float_unet, kw, to_q)
    assert all(a.x_scale == quant.f32(0.37) and a.pack.xs == quant.f32(0.1)
               for a in _attns(ignored))
    assert torch.equal(base, run(ignored))
    # the absorbed storage: K17 reads the site, as JAX's _absorbed reads
    # x_scale from the leaves of prequantize_conv_tree(absorbed_attention=
    # True) + apply_act_scales; the codes and the per-head scales are that
    # tree's, bit for bit
    read = _int8_unet(float_unet, kw, to_q, absorbed_attention=True)
    tree = jquant.apply_act_scales(
        jquant.prequantize_conv_tree(params, absorbed_attention=True,
                                     attention_heads=heads),
        {jax_path(k): v for k, v in to_q.items()})
    for name, a in zip(names, _attns(read)):
        node = tree["params"]
        for part in jax_path(f"{name}.attn1"):
            node = node[part]
        assert a.pack.xs == float(node["to_q"]["kernel"]["x_scale"])
        c = a.pack.wo_q.shape[0]
        for i, key in enumerate(("to_q", "to_k", "to_v")):
            leaf = node[key]["kernel"]
            np.testing.assert_array_equal(
                a.pack.w_qkv[i * c:(i + 1) * c].numpy(),
                np.asarray(leaf["q"]).T)
            np.testing.assert_array_equal(a.pack.w_scale[i].numpy(),
                                          np.asarray(leaf["scale"]))
        leaf = node["to_out"]["kernel"]
        np.testing.assert_array_equal(a.pack.wo_q.numpy(),
                                      np.asarray(leaf["q"]).T)
        np.testing.assert_array_equal(a.pack.w_scale[3].numpy(),
                                      np.asarray(leaf["scale"]))
    assert not torch.equal(base, run(read))


# ---------------------------------------------------------------------------
# the slice: 2 DDIM steps of sample_panoptic with the flag
# ---------------------------------------------------------------------------
STEPS = 2


@pytest.fixture(scope="module")
def slice_jax():
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    unet = junet.UNet2DCondition(junet.UNetConfig(
        use_cross_attention=False, cond_channels=4, **UNET_KW,
        use_absorbed_attention=True))
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

    def model_fn(latents, condition, t):
        x = jnp.concatenate([latents, lat, condition], axis=-1)
        return unet.apply(up, x, t)
    x0 = np.asarray(jax.jit(lambda z: jddim_sample(
        sched, model_fn, z, num_inference_steps=STEPS,
        self_condition=True))(jnp.asarray(init)))
    return dict(image=image, init=init, up=up, ip=ip, sp=sp, x0=x0)


def test_sample_panoptic_with_absorbed_attention_against_jax(slice_jax):
    j = slice_jax
    trainer = TrainerDiffusion(CFG, unet_config=dataclasses.replace(
        UNetConfig(**UNET_KW), use_absorbed_attention=True), device=CPU)
    trainer.load_jax_params(j["up"], j["ip"], j["sp"])
    before = A.absorbed_self_attention.fallbacks
    logits, x0 = trainer.sample_panoptic({"image": j["image"]},
                                         init_noise=j["init"],
                                         num_inference_steps=STEPS)
    # per UNet pass the mid block (d = 8, T = 8) takes K16's plain version
    # and the three C = 8 blocks (d = 4) the fallback: 2 steps of one pass
    assert A.absorbed_self_attention.fallbacks == before + 6
    assert logits.shape == (2, 32, 64, 24) and bool(torch.isfinite(
        logits).all())
    # fp32 through 2 steps x 2 UNet passes (test_torch_port_sampling's
    # 1e-3 on the logits; here on x0, the UNet's own output)
    _max_close(x0.numpy(), j["x0"], 1e-4)
