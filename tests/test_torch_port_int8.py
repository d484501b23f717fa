"""The port's int8 sampling slice against the JAX package on the CPU.

K3's and K4's plain versions against the Pallas kernels in interpret mode,
their dispatch branches against the JAX wrappers, the weight preparation
bit for bit against ``prequantize_conv_tree`` + ``pack_inference_tiles``,
the s8 conv and the int8 resnet/Down/Upsample blocks, the per-site
calibration, and the whole ``sample_panoptic`` with ``int8_inference`` of
the tiny trainer (``UNET_KW``/``CFG`` of ``test_torch_port_sampling.py``)
against a composition of the JAX functions the JAX trainer runs (its own
tests are slow-marked for their compile cost). Inputs are made with numpy
from a seed and handed to both packages; each tolerance is stated with its
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

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models import layers as jlayers  # noqa: E402
from ldmseg_tpu.models import unet as junet  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_tpu.ops.pallas import geglu as jgeglu  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.layers import LayerNorm, ResnetBlock  # noqa: E402
from ldmseg_torch.models.unet import (  # noqa: E402
    BasicTransformerBlock, CrossAttention, Downsample, UNet2DCondition,
    UNetConfig, Upsample)
from ldmseg_torch.ops import attention_s8 as K3  # noqa: E402
from ldmseg_torch.ops import geglu as K4  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _kernel_close(out, ref, mean_tol=1e-3):
    """The kernels' tolerance, relative to the reference: max |err| <=
    1.6e-2 * max|ref| (two bf16 ulps: both sides round to bf16 and sum in
    another order), mean |err| <= ``mean_tol`` * mean|ref| (so a rare int8
    code flipped by a summation order cannot hide a systematic error)."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out - ref)
    assert err.max() <= 1.6e-2 * np.abs(ref).max(), err.max()
    assert err.mean() <= mean_tol * np.abs(ref).mean(), err.mean()


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------
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
    # prequantize_conv_tree's storage: [C, C] codes, per-head scales
    w8 = tuple(jnp.transpose(x, (1, 0, 2)).reshape(c, c)
               for x in jw8[:3]) + (jw8[3].reshape(c, c),)
    return rng, norm, attn, (g1, be1, bo), w8, scales


def test_k3_plain_version_matches_pallas_kernel_in_interpret_mode():
    b, t, heads, d = 2, 32, 4, 8
    c = heads * d
    rng, norm, attn, (g1, be1, bo), w8, scales = _attention_case(29, c,
                                                                 heads)
    x = rng.randn(b, t, c).astype(np.float32)
    act_scale = 0.04
    pack = jattn.pack_padded_ln_vt_tiles(
        *w8, scales, heads, d ** -0.5, act_scale, jnp.asarray(g1),
        jnp.asarray(be1), jnp.asarray(bo))
    ref = jattn._abs_padded_ln_s8_vt_impl(
        jnp.asarray(x), pack["wqp"], pack["wkp"], pack["wvt"], pack["wo"],
        pack["m"], pack["g"], pack["sc"], heads, 1e-6, interpret=True)
    ref = np.asarray(ref, np.float32)
    p = K3.pack_ln_attention(norm, attn, heads, act_scale)
    # with the TPU kernel's softmax (static offset 0, clamp at 80) the plain
    # arithmetic is the kernel's, rounding point for rounding point
    np.testing.assert_array_equal(
        K3.ln_attention_s8_reference(_t(x), p, static_offset=0.0).float()
        .numpy(), ref)
    out = K3.ln_attention_s8_reference(_t(x), p)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    # the port's row max (normal-range scores): P rounds to bf16 at another
    # scale, so o moves by up to a bf16 ulp and the output's own bf16
    # rounding flips on about a third of the elements (1.2e-3 of mean|ref|
    # measured): mean tolerance 2.5e-3
    _kernel_close(out.float().numpy(), ref, mean_tol=2.5e-3)
    # the CPU wrapper takes the same plain version at a kernel shape
    before = K3.ln_attention_s8.fallbacks
    np.testing.assert_array_equal(
        K3.ln_attention_s8(_t(x), p).numpy(), out.float().numpy())
    assert K3.ln_attention_s8.fallbacks == before


@pytest.mark.parametrize("t,heads,d,via_wrapper", [
    (30, 4, 8, True),    # T % 8: the rule sends it to the fallback
    (16, 4, 4, True),    # d % 8
    (32, 4, 8, False),   # a kernel shape, the fallback called directly
])
def test_k3_fallback_matches_jax_wrapper_on_cpu(t, heads, d, via_wrapper):
    c = heads * d
    rng, norm, attn, (g1, be1, bo), w8, scales = _attention_case(7, c,
                                                                 heads)
    x = rng.randn(2, t, c).astype(np.float32)
    ref = jattn.absorbed_padded_ln_self_attention_s8(
        jnp.asarray(x), jnp.asarray(g1), jnp.asarray(be1), jnp.asarray(bo),
        *w8, scales, heads, d ** -0.5, 0.1)
    p = K3.pack_ln_attention(norm, attn, heads, 0.1)
    before = K3.ln_attention_s8.fallbacks
    if via_wrapper:
        out = K3.ln_attention_s8(_t(x), p)
        assert K3.ln_attention_s8.fallbacks == before + 1
    else:
        out = K3.ln_attention_s8_fallback(_t(x), p)
    assert out.dtype == torch.float32
    # fp32 on both sides: only the summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------
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


def _jax_operands(p):
    """The JAX kernel's operands from a port pack (the codes and scales are
    the same bits, see the weight-preparation test)."""
    w1q = jnp.asarray(p.w1.numpy().T)
    w2q = jnp.asarray(p.w2.numpy().T)
    return w1q, w2q, tuple(jnp.asarray(v.numpy()) for v in
                           (p.s1, p.b1, p.s2, p.b2, p.ln_w, p.ln_b))


@pytest.mark.parametrize("b,t,static", [
    (2, 16, False), (2, 16, True),
    (1, 1024, False),  # two 512-token blocks, each its own dynamic amax
    (1, 1024, True)])
def test_k4_plain_version_matches_pallas_kernel_in_interpret_mode(b, t,
                                                                  static):
    c, m = 64, 128
    rng, norm, proj_in, proj_out = _geglu_case(11, c, m)
    x = rng.randn(b, t, c).astype(np.float32)
    if t > 512:
        # spiky rows in the second block: its LN output and interior range
        # differ from the first block's, so one amax per tensor would not do
        x[:, 512:, 0] += 12.0
    act_scale, g_scale = 0.08, (0.02 if static else None)
    p = K4.pack_geglu(norm, proj_in, proj_out, act_scale, g_scale)
    w1q, w2q, (s1, b1, s2, b2, lw, lb) = _jax_operands(p)
    tiles = jgeglu.pack_geglu_ln_tiles(s1, b1, s2, b2, lw, lb, act_scale,
                                       g_scale)
    bt = min(512, t)
    ref = pl.pallas_call(
        functools.partial(jgeglu._geglu_ln_kernel, eps=1e-6,
                          static_g=static),
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
    ref = np.asarray(ref, np.float32)
    out = K4.geglu_ln_s8_reference(_t(x), p)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    _kernel_close(out.float().numpy(), ref)
    if t > 512 and not static:
        per_tensor = K4.geglu_ln_s8_reference(_t(x), p, block_t=t)
        assert not torch.equal(per_tensor, out), \
            "the case cannot tell one amax per block from one per tensor"


@pytest.mark.parametrize("t,static,via_wrapper", [
    (20, False, True),    # T % 8: the rule sends it to the fallback
    (20, True, True),
    (24, False, False),   # a kernel shape, the fallback called directly
])
def test_k4_fallback_matches_jax_wrapper_on_cpu(t, static, via_wrapper):
    c, m = 32, 64
    rng, norm, proj_in, proj_out = _geglu_case(5, c, m)
    x = rng.randn(2, t, c).astype(np.float32)
    g_scale = 0.02 if static else None
    p = K4.pack_geglu(norm, proj_in, proj_out, 0.05, g_scale)
    w1q, w2q, (s1, b1, s2, b2, lw, lb) = _jax_operands(p)
    ref = jgeglu.fused_geglu_ln_s8(jnp.asarray(x), lw, lb, w1q, s1, b1, w2q,
                                   s2, b2, 0.05, g_scale=g_scale)
    before = K4.geglu_ln_s8.fallbacks
    if via_wrapper:
        out = K4.geglu_ln_s8(_t(x), p)
        assert K4.geglu_ln_s8.fallbacks == before + 1
    else:
        out = K4.geglu_ln_s8_fallback(_t(x), p)
    assert out.dtype == torch.float32
    # fp32 on both sides: only the summation order and erf may differ
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the tiny UNet: weight preparation, calibration, blocks
# ---------------------------------------------------------------------------
TINY_KW = dict(in_channels=12, out_channels=4, block_out_channels=(16, 32),
               attn_down=(True, True), layers_per_block=1,
               attention_head_dim=2, norm_num_groups=4)
# the int8 UNet's flags in both packages (the JAX trainer's, :164-176)
INT8_KW = dict(use_int8_conv=True, int8_act_scale=0.05, use_fused_norms=True,
               use_padded_attention=True, use_int8_ff=True,
               use_fused_ff=True, int8_attn_act_scale=0.1,
               use_fused_attention=False, use_int8_attention=False)


def jax_path(name: str) -> tuple:
    """A port module name -> the JAX module path."""
    toks, out, i = name.split("."), [], 0
    while i < len(toks):
        tok = toks[i]
        nxt = toks[i + 1] if i + 1 < len(toks) else None
        if tok in ("down_blocks", "up_blocks"):
            out.append(tok + nxt)
        elif tok == "resnets":
            out.append("resnet" + nxt)
        elif tok == "attentions":
            out.append("attn" if out[-1] == "mid_block" else "attn" + nxt)
        elif tok == "transformer_blocks":
            out.append("block" + nxt)
        elif tok in ("downsamplers", "upsamplers"):
            out.append(tok[:-len("rs")])
        elif tok == "net":  # ff.net.0.proj, ff.net.2
            out.append("proj_in" if nxt == "0" else "proj_out")
            i += 3 if nxt == "0" else 2
            continue
        else:
            out.append(tok)
            i += 1
            continue
        i += 2
    return tuple(out)


@pytest.fixture(scope="module")
def tiny():
    unet = junet.UNet2DCondition(junet.UNetConfig(
        use_cross_attention=False, cond_channels=4, **TINY_KW))
    params = _random_params(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 4, 8, 12)),
        jnp.zeros((1,), jnp.int32)), 3)
    ucfg = UNetConfig(**TINY_KW)
    float_unet = UNet2DCondition(ucfg)
    float_unet.load_state_dict(convert.unet_state_dict_from_jax(params, ucfg))
    int8_unet = UNet2DCondition(UNetConfig(**TINY_KW, **INT8_KW))
    return unet, params, float_unet, int8_unet


def _tree(params, path):
    node = params["params"]
    for p in path:
        node = node[p]
    return node


def _eq(port, ref, what):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=what)


@pytest.mark.parametrize("calibrated", [False, True])
def test_weight_preparation_matches_jax_bit_for_bit(tiny, calibrated):
    _, params, float_unet, int8_unet = tiny
    heads = TINY_KW["attention_head_dim"]
    sites = quant.act_scale_sites(int8_unet)
    scales = ({key: 0.01 + 0.001 * i for i, key in enumerate(sorted(sites))}
              if calibrated else None)
    quant.apply_act_scales(int8_unet, scales)
    quant.prepare_int8_unet(int8_unet, float_unet)
    tree = jquant.prequantize_conv_tree(params, quantize_ff=True,
                                        absorbed_attention=True,
                                        attention_heads=heads)
    if calibrated:
        tree = jquant.apply_act_scales(
            tree, {jax_path(k): v for k, v in scales.items()})
    tree = jquant.pack_inference_tiles(tree, attention_heads=heads,
                                       int8_act_scale=0.05,
                                       int8_attn_act_scale=0.1)
    n_conv = n_block = 0
    for name, m in int8_unet.named_modules():
        if isinstance(m, quant.QuantConv2d):
            k = _tree(tree, jax_path(name))["kernel"]
            _eq(m.weight_codes().numpy(),
                np.asarray(k["q"]).transpose(3, 2, 0, 1), name)
            _eq(m.w_scale.numpy(), k["scale"], name)
            assert (m.x_scale is None) == ("x_scale" not in k), name
            if m.x_scale is not None:
                assert np.float32(m.x_scale) == k["x_scale"], name
            n_conv += 1
        if not (isinstance(m, BasicTransformerBlock) and m.fuse_attn):
            continue
        n_block += 1
        node = _tree(tree, jax_path(name))
        a, f = m.attn1.pack, m.ff.pack
        c = a.ln_w.shape[0]
        d = c // heads
        at = node["attn1"]
        for i, proj in enumerate(("to_q", "to_k", "to_v")):
            kq = at[proj]["kernel"]
            _eq(a.w_qkv[i * c:(i + 1) * c].numpy(), np.asarray(kq["q"]).T,
                f"{name} {proj}")
            _eq(a.w_scale[i].numpy(), kq["scale"], f"{name} {proj}")
        ko = at["to_out"]["kernel"]
        _eq(a.wo_q.numpy(), np.asarray(ko["q"]).T, name)
        _eq(a.w_scale[3].numpy(), ko["scale"], name)
        mrows = np.asarray(ko["t_m"]).reshape(8, heads, -1)[:, :, :d]
        _eq(a.m_qkv[:2 * c].numpy(), mrows[:2].reshape(-1), f"{name} m")
        sc = np.asarray(ko["t_sc"])
        _eq(a.m_qkv[2 * c::d].numpy(), sc[2, :heads], f"{name} v scale")
        assert np.float32(a.score_scale) == sc[0, 0]
        assert np.float32(a.xs) == sc[0, 2]
        _eq(a.wo.float().numpy(),
            np.asarray(ko["t_wo"], np.float32).T, f"{name} wo")
        g = np.asarray(ko["t_g"])
        for row, v in enumerate((a.ln_w, a.ln_b, a.out_b)):
            _eq(v.numpy(), g[row], f"{name} g{row}")
        k1 = node["ff"]["proj_in"]["kernel"]
        k2 = node["ff"]["proj_out"]["kernel"]
        _eq(f.w1.numpy(), np.asarray(k1["q"]).T, name)
        _eq(f.w2.numpy(), np.asarray(k2["q"]).T, name)
        _eq(f.s1.numpy(), np.asarray(k1["t_s1"])[0], name)
        _eq(f.b1.numpy(), np.asarray(k1["t_s1"])[1], name)
        _eq(f.s2.numpy(), np.asarray(k2["t_s2"])[0], name)
        gg = np.asarray(k2["t_g"])
        for row, v in enumerate((f.ln_w, f.ln_b, f.b2)):
            _eq(v.numpy(), gg[row], f"{name} ff g{row}")
        fsc = np.asarray(k1["t_sc"])
        assert np.float32(f.xs) == fsc[0, 0]
        assert np.float32(f.gs or 0.0) == fsc[0, 1]
    assert n_conv == 18 and n_block == 7  # 16 resnet convs + 2 samplers
    quant.apply_act_scales(int8_unet, None)


def test_calibrate_act_scale_tree_matches_jax(tiny):
    unet, params, float_unet, _ = tiny
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 16, 12).astype(np.float32)
    t = np.array([500, 500])
    ref = jquant.calibrate_act_scale_tree(unet.apply, params,
                                          (jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        ours = quant.calibrate_act_scale_tree(
            float_unet, _t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    assert {jax_path(k) for k in ours} == set(ref)
    assert len(ours) == 2 * 8 + 3 * 7  # 8 resnets x 2, 7 blocks x 3
    for key, value in ours.items():
        # fp32 activations on both sides: the amax moves by rounding only
        np.testing.assert_allclose(value, ref[jax_path(key)], rtol=2e-2)
    with pytest.raises(KeyError):
        quant.apply_act_scales(UNet2DCondition(UNetConfig(**TINY_KW,
                                                          **INT8_KW)),
                               {"down_blocks.0.nowhere": 0.1})


def _bf16(tree):
    """Float leaves to bf16, the int8 kernel dicts' scales kept fp32."""
    def cast(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        if leaf.dtype == jnp.float32 and "kernel" not in keys[-2:-1]:
            return leaf.astype(jnp.bfloat16)
        return leaf
    return jax.tree_util.tree_map_with_path(cast, tree)


def _ulp_close(out, ref, steps=1):
    """Each value within ``steps`` bf16 steps of the reference's."""
    err = np.abs(out - ref)
    assert np.all(err <= steps * (2 ** -7 * np.abs(ref) + 2 ** -14)), \
        err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", ["resnet", "downsample", "upsample"])
def test_int8_blocks_match_jax(block, dtype):
    rng = np.random.RandomState(12)
    cin, cout, groups, eps = 8, 16, 4, 1e-5
    if block == "resnet":
        jmod = jlayers.ResnetBlock(cout, groups=groups, eps=eps,
                                   use_int8=True, int8_act_scale=0.05)
        x = rng.randn(2, 8, 16, cin).astype(np.float32)
        temb = rng.randn(2, 32).astype(np.float32)
        args = (jnp.zeros_like(x), jnp.zeros_like(temb))
        fl = ResnetBlock(cin, cout, groups, eps, 32)
        q8 = ResnetBlock(cin, cout, groups, eps, 32, use_int8=True,
                         int8_act_scale=0.05)
    else:
        cls = Downsample if block == "downsample" else Upsample
        jcls = junet.Downsample if block == "downsample" else junet.Upsample
        jmod = jcls(cout, use_int8=True)
        x = (3.0 * rng.randn(2, 8, 16, cout)).astype(np.float32)
        args = (jnp.zeros_like(x),)
        fl, q8 = cls(cout), cls(cout, use_int8=True)
    params = _random_params(lambda: jmod.init(jax.random.key(0), *args), 13)
    sd = {}
    if block == "resnet":
        convert._resnet(sd, "", params["params"])
        pq = jquant.prequantize_conv_tree(params)
    else:
        convert._conv(sd, ".conv", params["params"]["conv"])
        qk, sk = jquant.quantize_weight(params["params"]["conv"]["kernel"])
        pq = {"params": {"conv": dict(params["params"]["conv"],
                                      kernel={"q": qk, "scale": sk})}}
    fl.load_state_dict({k[1:]: v for k, v in sd.items()})
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    q8 = q8.to(tdt)
    quant.prepare_int8_unet(q8, fl)
    jx = [jnp.asarray(x, jdt)]
    tx = [_t(x).permute(0, 3, 1, 2).to(tdt)]
    if block == "resnet":
        jx.append(jnp.asarray(temb, jdt))
        tx.append(_t(temb).to(tdt))
    ref = np.asarray(jmod.apply(_bf16(pq) if dtype == "bfloat16" else pq,
                                *jx), np.float32)
    with torch.no_grad():
        out = q8(*tx).float().permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    if dtype == "float32":
        # equal codes, exact int32 sums: fp32 rounding only
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    elif block != "resnet":
        # equal codes, exact sums, the same dequantize: the bf16 cast only
        _ulp_close(out, ref)
    else:
        # XLA and PyTorch round the lowp GN's bf16 affine and SiLU (and the
        # bf16 time-embedding Dense) at other points: outputs one bf16 step
        # apart (test_lowp_group_norm_silu_matches_jax), and at a static
        # scale of 0.05 such a step flips about 4% of the conv input codes;
        # measured 1.2e-2 of max|ref| and of mean|ref|
        err = np.abs(out - ref)
        assert err.max() <= 4e-2 * np.abs(ref).max(), err.max()
        assert err.mean() <= 4e-2 * np.abs(ref).mean(), err.mean()


def test_lowp_group_norm_silu_matches_jax():
    from ldmseg_torch.models.layers import GroupNormSiLU
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 16, 16).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(16)).astype(np.float32)
    b = (0.1 * rng.randn(16)).astype(np.float32)
    jmod = jlayers.GroupNormSiLU(groups=4, eps=1e-5, lowp=True)
    ref = np.asarray(jmod.apply(
        {"params": {"scale": jnp.asarray(w, jnp.bfloat16),
                    "bias": jnp.asarray(b, jnp.bfloat16)}},
        jnp.asarray(x, jnp.bfloat16)), np.float32)
    gn = GroupNormSiLU(4, 16, 1e-5, lowp=True).to(torch.bfloat16)
    with torch.no_grad():
        gn.weight.copy_(_t(w))
        gn.bias.copy_(_t(b))
        out = gn(_t(x).permute(0, 3, 1, 2).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    # fp32 statistics on both sides; the bf16 affine and SiLU round at
    # other points in XLA than in PyTorch: one step of the affine, carried
    # through the SiLU (slope up to 1.1), is up to two steps of the output
    _ulp_close(out.float().permute(0, 2, 3, 1).numpy(), ref, steps=2)


def test_s8_conv_is_exact():
    rng = np.random.RandomState(1)
    x8 = torch.from_numpy(rng.randint(-127, 128, (2, 24, 5, 7)).astype(
        np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (16, 24, 3, 3)).astype(
        np.int8))
    w_mat = w.permute(0, 2, 3, 1).reshape(16, -1)
    for stride in (1, 2):
        y = quant.s8_conv2d(x8, w_mat, stride)
        ref = torch.nn.functional.conv2d(x8.double(), w.double(),
                                         stride=stride, padding=1)
        assert y.dtype == torch.int32
        assert torch.equal(y.permute(0, 3, 1, 2).double(), ref)


# ---------------------------------------------------------------------------
# the slice: int8 sample_panoptic
# ---------------------------------------------------------------------------
STEPS = 2


def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def test_int8_sample_panoptic_against_jax():
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    calib_noise = rng.randn(2, 4, 8, 4).astype(np.float32)
    heads = UNET_KW["attention_head_dim"]
    jcfg = dict(use_cross_attention=False, cond_channels=4, **UNET_KW)
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

    # the JAX trainer's calibrate_int8 and _prequant, composed
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

    # adopted weights without calibrated scales: the first int8 call
    # calibrates, or raises when int8_auto_calibrate is off (:1090-1114)
    for auto in (False, True):
        cfg = merge_dicts(CFG, {"sampling_kwargs": {
            "int8_inference": True, "int8_auto_calibrate": auto}})
        trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(**UNET_KW),
                                   device=CPU)
        trainer.load_jax_params(up, ip, sp)
        if not auto:
            with pytest.raises(RuntimeError, match="calibrate_int8"):
                trainer.sample_panoptic({"image": image}, init_noise=init,
                                        num_inference_steps=1)
    trainer.sample_panoptic({"image": image}, init_noise=init,
                            num_inference_steps=1)
    assert trainer._int8_act_scales is not None
    ours = trainer.calibrate_int8({"image": image}, noise=calib_noise)
    assert {jax_path(key) for key in ours} == set(scales)
    for key, value in ours.items():
        np.testing.assert_allclose(value, scales[jax_path(key)], rtol=2e-2)
    fb3, fb4 = K3.ln_attention_s8.fallbacks, K4.geglu_ln_s8.fallbacks
    logits, x0 = trainer.sample_panoptic({"image": image}, init_noise=init,
                                         num_inference_steps=STEPS)
    # d = 4 at the first level: the shape rule sends those K3 sites (one
    # down, two up) to the fallback, one UNet pass per step; K4 takes all
    assert K3.ln_attention_s8.fallbacks - fb3 == 3 * STEPS
    assert K4.geglu_ln_s8.fallbacks == fb4
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
