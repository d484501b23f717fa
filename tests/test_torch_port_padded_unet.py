"""The port's padded-attention flags against the JAX package on the CPU:
``use_fused_projs`` (K8 + K9), ``use_padded_attention`` without fused
norms (K11) and the repair of F1 (``use_fused_norms`` without
``use_padded_attention`` is K13 + K4, as in JAX).

The weight preparation bit for bit against ``prequantize_conv_tree(
absorbed_attention=True)`` + ``pack_inference_tiles(fuse_projs=True)``
and ``_abs_padded_prep``, the tiny int8 UNet against JAX's for the three
flag sets at a 6x6 latent where every transformer site falls back on both
sides (the same arithmetic, so fp32-close), the flags' rules and the
trainer's mapping, the K11 module's inference-only guard, and the JAX tree
loading into UNets built with the flags. The slice's ``sample_panoptic``
is in ``test_torch_port_padded_kernels.py``, which has the room. Inputs
are made with numpy from a seed and handed to both packages; each
tolerance is stated with its reason where it is used.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models import unet as junet  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import (  # noqa: E402
    BasicTransformerBlock, CrossAttention, LNAttentionS8, LNFeedForwardS8,
    PaddedAttentionS8, Transformer2D, UNet2DCondition, UNetConfig)
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops import geglu as G  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

from test_torch_port_int8 import (  # noqa: E402
    INT8_KW, TINY_KW, _eq, _t, _tree, jax_path)
from test_torch_port_sampling import _random_params  # noqa: E402

CPU = torch.device("cpu")
HEADS = TINY_KW["attention_head_dim"]
# the flag sets, each in the one spelling both packages read
FLAGS = {
    # the trainer's int8 UNet with fused projs: K8 + K9
    "fused_projs": dict(INT8_KW, use_fused_projs=True),
    # tools/perf/acc_check.py:62-67, variant B: K13 + K4
    "variant_b": dict(use_fused_attention=True, use_int8_conv=True,
                      int8_act_scale=0.05, use_int8_ff=True,
                      use_fused_ff=True, int8_attn_act_scale=0.1,
                      use_int8_attention=True, use_fused_norms=True),
    # (a)'s flags with padded attention: K11 + K12
    "padded": dict(use_int8_conv=True, int8_act_scale=0.05,
                   use_padded_attention=True, use_int8_ff=True,
                   use_fused_ff=True, int8_attn_act_scale=0.1),
}


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
    # the input of tests/test_torch_port_int8_unfused.py: no int8 code of
    # the UNet within an fp32 ulp of a rounding boundary
    rng = np.random.RandomState(8)
    x = rng.randn(2, 6, 6, 12).astype(np.float32)
    t = np.array([999, 19])
    with torch.no_grad():
        scales = quant.calibrate_act_scale_tree(
            float_unet, _t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    return params, float_unet, x, t, scales


def _jax_tree(params, flags, scales):
    """The JAX trainer's ``_prequant`` for ``flags``: the absorbed storage
    and, with fused norms and padded attention, the packed tiles (with
    ``fuse_projs`` when the flags set it)."""
    padded = flags.get("use_padded_attention", False)
    tree = jquant.prequantize_conv_tree(
        params, quantize_ff=True, absorbed_attention=padded,
        attention_heads=HEADS)
    if scales is not None:
        tree = jquant.apply_act_scales(
            tree, {jax_path(k): v for k, v in scales.items()})
    if padded and flags.get("use_fused_norms"):
        tree = jquant.pack_inference_tiles(
            tree, attention_heads=HEADS, int8_act_scale=0.05,
            int8_attn_act_scale=0.1,
            fuse_projs=flags.get("use_fused_projs", False))
    return tree


def _int8_unet(float_unet, flags, scales):
    int8_unet = UNet2DCondition(UNetConfig(**TINY_KW, **flags))
    quant.apply_act_scales(int8_unet, scales)
    quant.prepare_int8_unet(int8_unet, float_unet)
    return int8_unet


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("flags", ["fused_projs", "padded"])
def test_weight_preparation_matches_jax_bit_for_bit(tiny, flags, calibrated):
    params, float_unet, _, _, scales = tiny
    scales = scales if calibrated else None
    int8_unet = _int8_unet(float_unet, FLAGS[flags], scales)
    tree = _jax_tree(params, FLAGS[flags], scales)
    n = 0
    for name, m in int8_unet.named_modules():
        if isinstance(m, Transformer2D) and flags == "fused_projs":
            node = _tree(tree, jax_path(name))
            blk = m.transformer_blocks[0]
            a, f = blk.attn1.pack, blk.ff.pack
            for proj, w, w_f, bias, g in (
                    ("proj_in", a.wpi, a.wpi_f, a.bpi,
                     node["block0"]["attn1"]["to_out"]["kernel"]["t_g"]),
                    ("proj_out", f.wpo, f.wpo_f, f.bpo,
                     node["block0"]["ff"]["proj_out"]["kernel"]["t_g"])):
                # the wrapper's proj[0].astype(bf16) of the [1, 1, Cin,
                # Cout] float32 kernel; the bias in g row 3
                k = np.asarray(node[proj]["kernel"])[0, 0].T
                _eq(w.float().numpy(), np.asarray(jnp.asarray(
                    k, jnp.bfloat16), np.float32), f"{name} {proj}")
                _eq(w_f.numpy(), k, f"{name} {proj} fp32")
                _eq(bias.numpy(), np.asarray(g)[3], f"{name} {proj} bias")
                _eq(bias.numpy(), node[proj]["bias"], f"{name} {proj} b")
            # rows 0-2 (the LNs and the block's biases) unchanged
            for row, v in enumerate((a.ln_w, a.ln_b, a.out_b)):
                _eq(v.numpy(), np.asarray(node["block0"]["attn1"]["to_out"][
                    "kernel"]["t_g"])[row], f"{name} g{row}")
            n += 1
        elif isinstance(m, PaddedAttentionS8):
            at = _tree(tree, jax_path(name))
            kq, kk, kv, ko = (at[p]["kernel"]
                              for p in ("to_q", "to_k", "to_v", "to_out"))
            xs = kq.get("x_scale", np.float32(0.1))
            assert np.float32(m.pack.xs) == np.float32(xs), name
            sc = jnp.zeros((HEADS, 8, 128), jnp.float32)
            for i, leaf in enumerate((kq, kk, kv, ko)):
                sc = sc.at[:, 0, i].set(leaf["scale"])
            c = kq["q"].shape[0]
            d = c // HEADS
            _, _, _, _, mrow, tile = jattn._abs_padded_prep(
                kq["q"], kk["q"], kv["q"], ko["q"], sc, HEADS, xs, 0.1,
                d ** -0.5)
            p = m.pack
            for i, leaf in enumerate((kq, kk, kv)):
                _eq(p.w_qkv[i * c:(i + 1) * c].numpy(),
                    np.asarray(leaf["q"]).T, f"{name} codes {i}")
                _eq(p.w_scale[i].numpy(), leaf["scale"], name)
            _eq(p.wo_q.numpy(), np.asarray(ko["q"]).T, f"{name} to_out")
            mrow = np.asarray(mrow).reshape(8, HEADS, -1)[:3, :, :d]
            _eq(p.m_qkv.numpy(), mrow.reshape(-1), f"{name} m")
            tile = np.asarray(tile)
            _eq(p.ratio.numpy(), tile[1, :HEADS], f"{name} ratio")
            assert np.float32(p.score_scale) == tile[0, 0], name
            assert np.float32(p.out_scale) == tile[0, 1], name
            n += 1
    assert n == 7   # 2 down, 1 mid, 4 up


def test_unets_with_the_flags_load_the_jax_tree(tiny):
    params, float_unet, *_ = tiny
    for flags in (dict(use_padded_attention=True),
                  dict(use_fused_projs=True), FLAGS["padded"]):
        ucfg = UNetConfig(**TINY_KW, **flags)
        if flags.get("use_int8_conv"):
            # the int8 UNet holds no float conv weights: its float
            # parameters are a subset of the tree, filled by prepare
            unet = UNet2DCondition(ucfg)
            sd = convert.unet_state_dict_from_jax(params, ucfg)
            assert set(unet.state_dict()) <= set(sd)
            assert all(k in unet.state_dict() for k in sd if ".attn1." in k)
            continue
        UNet2DCondition(ucfg).load_state_dict(
            convert.unet_state_dict_from_jax(params, ucfg), strict=True)


# every transformer site's fallbacks in one forward (7 blocks) per flag set
EXPECT = {
    "fused_projs": {"K8": 7, "K9": 7},
    "variant_b": {"K13": 7, "K4": 7},
    "padded": {"K11": 7, "K12": 7},
}


def _fallbacks():
    return {"K3": S8.ln_attention_s8.fallbacks,
            "K4": G.geglu_ln_s8.fallbacks,
            "K8": S8.ln_attention_s8_pin.fallbacks,
            "K9": G.geglu_ln_s8_pout.fallbacks,
            "K11": S8.padded_attention_s8.fallbacks,
            "K12": G.fused_geglu_s8.fallbacks,
            "K13": S8.fused_self_attention_s8.fallbacks}


@pytest.mark.parametrize("flags", ["fused_projs", "variant_b", "padded"])
def test_tiny_int8_unet_matches_jax(tiny, flags):
    params, float_unet, x, t, _ = tiny
    int8_unet = _int8_unet(float_unet, FLAGS[flags], None)
    blocks = [m for m in int8_unet.modules()
              if isinstance(m, BasicTransformerBlock)]
    assert len(blocks) == 7
    for blk in blocks:
        if flags == "variant_b":
            # F1: fused norms without padded attention are K13 + K4
            assert not blk.fuse_attn and blk.fuse_ff
            assert isinstance(blk.attn1, CrossAttention)
            assert blk.attn1.int8 and blk.attn1.use_fused
            assert isinstance(blk.ff, LNFeedForwardS8)
        elif flags == "padded":
            assert isinstance(blk.attn1, PaddedAttentionS8)
            assert blk.ff.fused and not blk.fuse_ff
        else:
            assert isinstance(blk.attn1, LNAttentionS8) and blk.attn1.proj_in
            assert blk.ff.proj_out
    tree = _jax_tree(params, FLAGS[flags], None)
    junet8 = junet.UNet2DCondition(junet.UNetConfig(
        use_cross_attention=False, cond_channels=4, **TINY_KW,
        **FLAGS[flags]))
    ref = np.asarray(jax.jit(junet8.apply)(tree, jnp.asarray(x),
                                           jnp.asarray(t)))
    before = _fallbacks()
    with torch.no_grad():
        out = int8_unet(_t(x).permute(0, 3, 1, 2), torch.from_numpy(t))
    out = out.permute(0, 2, 3, 1).numpy()
    # 6x6: T = 36 and 9, no multiple of 8, so every transformer site takes
    # the fallback on both sides
    moved = {k: v - before[k] for k, v in _fallbacks().items()}
    assert moved == dict({k: 0 for k in moved}, **EXPECT[flags])
    # the same arithmetic in fp32 (equal codes, exact int32 sums), as in
    # tests/test_torch_port_int8_unfused.py
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_fused_projs_rules_and_the_trainer_mapping():
    base = dict(TINY_KW, use_int8_conv=True, use_fused_norms=True,
                use_padded_attention=True, use_int8_ff=True)
    # JAX asserts fused projs only with both fusions (unet.py:469-470)
    for flags in (dict(base, use_fused_projs=True),
                  dict(base, use_fused_ff=True, use_padded_attention=False,
                       use_fused_projs=True)):
        with pytest.raises(ValueError, match="use_fused_projs"):
            UNet2DCondition(UNetConfig(**flags))
    # and ignores them without fused norms (:547-548)
    unet = UNet2DCondition(UNetConfig(**dict(base, use_fused_norms=False,
                                             use_fused_ff=True,
                                             use_fused_projs=True)))
    assert not any(m.fused_projs for m in unet.modules()
                   if isinstance(m, Transformer2D))

    def trainer(sk, **ucfg):
        cfg = merge_dicts(DEFAULT_CONFIG, {
            "train_kwargs": {"self_condition": True},
            "sampling_kwargs": dict(int8_inference=True, **sk)})
        return TrainerDiffusion(cfg, unet_config=UNetConfig(
            in_channels=12, use_fused_attention=True, **ucfg), device=CPU)

    # the trainer sets use_padded_attention = fused_norms (:163-176)
    for fused_norms in (True, False):
        ucfg = trainer({"fused_norms": fused_norms})._unet_int8.config
        assert ucfg.use_padded_attention == ucfg.use_fused_norms == \
            fused_norms
    ucfg = trainer({}, use_fused_projs=True)._unet_int8.config
    assert ucfg.use_fused_projs and ucfg.use_padded_attention
    with pytest.raises(ValueError, match="use_fused_projs"):
        trainer({"fused_ff": False}, use_fused_projs=True)


def test_padded_attention_is_inference_only(tiny):
    _, float_unet, x, t, _ = tiny
    ucfg = UNetConfig(**TINY_KW, use_padded_attention=True)
    unet = UNet2DCondition(ucfg)
    unet.load_state_dict(float_unet.state_dict())
    xs = _t(x).permute(0, 3, 1, 2)
    with pytest.raises(RuntimeError, match="inference only"):
        unet(xs, torch.from_numpy(t))
    # unprepared: each forward quantizes the module's own weights, as JAX
    # does in the graph (K11's fallback at this latent)
    before = S8.padded_attention_s8.fallbacks
    with torch.no_grad():
        out = unet(xs, torch.from_numpy(t))
    assert S8.padded_attention_s8.fallbacks == before + 7
    assert bool(torch.isfinite(out).all())
