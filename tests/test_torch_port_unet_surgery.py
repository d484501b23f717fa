"""The port's UNet surgery and cross-attention against the JAX package.

``test_conditioning.py``'s ``CROSS_UNET`` sizes (block_out (8, 16, 16, 32),
one layer per block, 2 heads, 4 groups, cross_attention_dim 16) at an 8x16
latent, the JAX weights drawn with numpy and carried over by
``models/convert.py``: the UNet with a context, with ``encoder_hid_proj``,
with object queries, with ``separate_conv``, with ``separate_encoder`` and
its adaptors (drawn from the seed: JAX starts them at zero, where a wrong
adaptor would not show), with the upscaler head, each in fp32 within 1e-4 *
max(1, max|ref|); in bf16 within bf16's own error; the gradients of
``gradient_checkpointing`` with learnable queries against JAX's remat;
``Upscaler`` against JAX's; the diffusers import and export of
``attn2``/``norm2`` against JAX's ``unet_params_from_sd`` and
``unet_sd_from_params``; ``freeze_filter``'s image entries; and the
traits: the 6/6 split of 12 channels, an odd count refused, fused projs
without cross-attention.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa

FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
CROSS_KW = dict(in_channels=8, out_channels=4,
                block_out_channels=(8, 16, 16, 32), layers_per_block=1,
                cross_attention_dim=16, attention_head_dim=2,
                norm_num_groups=4, use_cross_attention=True)
# each with the context in attn2; two options a UNet (one XLA compile each)
VARIANTS = {
    "encoder_hid_dim, separate_conv": {"encoder_hid_dim": 12,
                                       "separate_conv": True},
    "object_queries, upscaler": {"num_object_queries": 4,
                                 "upscaler_classes": 6, "upscaler_dim": 8},
    "separate_encoder": {"separate_encoder": True, "add_adaptor": True},
}
HW = (8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_params(init, seed):
    """The Flax parameters ``init()`` would make, drawn with numpy: every
    leaf random, the adaptors' zero init and the norms' unit scales
    included, so that every mapping shows."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.randn(*leaf.shape).astype(np.float32) / fan_in**0.5
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "object_queries":
            return rng.randn(*leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def _close(out, ref, tol=1e-4):
    ref = np.asarray(ref, np.float32)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


def _ctx_dim(kw):
    return kw.get("encoder_hid_dim") or CROSS_KW["cross_attention_dim"]


def _jax_unet(**kw):
    return JUNet(JUNetConfig(**{**CROSS_KW, **kw}))


def _inputs(kw, seed=0, in_channels=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *HW, in_channels).astype(np.float32)
    ctx = rng.randn(2, 5, _ctx_dim(kw)).astype(np.float32)
    return x, np.array([999, 19], np.int32), ctx


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                            ).to(dtype)


def _port(params, **kw):
    unet = UNet2DCondition(UNetConfig(**{**CROSS_KW, **kw}))
    unet.load_state_dict(convert.unet_state_dict_from_jax(params,
                                                          unet.config),
                         strict=True)
    return unet


@pytest.fixture(scope="module")
def trees():
    out = {}
    for i, (name, kw) in enumerate(VARIANTS.items()):
        x, t, ctx = _inputs(kw)
        model = _jax_unet(**kw)
        out[name] = _random_params(lambda: model.init(
            jax.random.key(0), jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(ctx)), 10 + i)
    return out


def _case(name):
    """A variant's inputs; the image branch gets its own timestep (JAX's
    default 0 in the other tests)."""
    x, t, ctx = _inputs(VARIANTS[name], seed=1)
    t_img = (np.array([7, 300], np.int32) if name == "separate_encoder"
             else None)
    return x, t, ctx, t_img


@pytest.fixture(scope="module")
def jax_out(trees):
    """Each variant's JAX output in fp32 on :func:`_case`'s inputs."""
    out = {}
    for name, kw in VARIANTS.items():
        x, t, ctx, t_img = _case(name)
        out[name] = np.asarray(_jit(
            lambda p, a, b, c, d: _jax_unet(**kw).apply(p, a, b, c, d),
            trees[name], jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
            None if t_img is None else jnp.asarray(t_img)))
    return out


@pytest.mark.parametrize("name", list(VARIANTS))
def test_unet_with_the_surgery_matches_jax(trees, jax_out, name):
    kw = VARIANTS[name]
    params = trees[name]
    x, t, ctx, t_img = _case(name)
    ref = jax_out[name]
    unet = _port(params, **kw)
    with torch.no_grad():
        out = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                   None if t_img is None else torch.from_numpy(t_img))
    out = out.permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    _close(out, ref)
    if name == "separate_encoder":
        # the adaptors carry the image residuals: zeroing them moves it
        for conv in (c for level in unet.adaptors for c in level):
            conv.weight.data.zero_()
            conv.bias.data.zero_()
        with torch.no_grad():
            other = unet(_nchw(x), torch.from_numpy(t),
                         torch.from_numpy(ctx), torch.from_numpy(t_img)
                         ).permute(0, 2, 3, 1).numpy()
        assert np.abs(other - ref).max() > 1e-3 * np.abs(ref).max()
    if "upscaler" in name:
        assert out.shape == (2, 2 * HW[0], 2 * HW[1], 6)


def test_the_context_reaches_attn2(trees):
    kw = VARIANTS["separate_encoder"]
    unet = _port(trees["separate_encoder"], **kw)
    x, t, ctx = _inputs(kw, seed=2)
    with torch.no_grad():
        a = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
        b = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx) + 1)
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("name", ["separate_encoder"])
def test_unet_with_the_surgery_in_bf16(trees, jax_out, name):
    """bf16 through the whole UNet: XLA and PyTorch round at other places,
    so the outputs differ by about bf16's own error: within 4e-2 of
    max|ref|, and no further from JAX's fp32 output than 1.5x JAX's bf16
    output is (the yardstick of the packed UNet's bf16 test)."""
    kw = VARIANTS[name]
    params = trees[name]
    x, t, ctx, t_img = _case(name)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                params)
    ref16 = np.asarray(_jit(
        lambda p, a, b, c, d: _jax_unet(**kw).apply(p, a, b, c, d),
        bf, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
        jnp.asarray(ctx, jnp.bfloat16), jnp.asarray(t_img)
        ).astype(jnp.float32))
    ref32 = jax_out[name]
    unet = _port(params, **kw).to(torch.bfloat16)
    with torch.no_grad():
        out = unet(_nchw(x, torch.bfloat16), torch.from_numpy(t),
                   torch.from_numpy(ctx).to(torch.bfloat16),
                   torch.from_numpy(t_img))
    assert out.dtype == torch.bfloat16
    out = out.float().permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(ref16).max())
    assert float(np.abs(out - ref16).max()) <= 4e-2 * scale
    assert (float(np.abs(out - ref32).max())
            <= 1.5 * float(np.abs(ref16 - ref32).max()) + 1e-6 * scale)


def test_remat_with_learnable_queries(trees, jax_out):
    """``gradient_checkpointing``: the context (the object queries) goes
    into ``torch.utils.checkpoint`` with the blocks' weights: the forward
    equals JAX's (remat changes no value), and every gradient, the
    queries' too, that of the port without remat (held to JAX's in the
    train step of ``test_torch_port_conditioning``)."""
    name = "object_queries, upscaler"
    kw = VARIANTS[name]
    params = trees[name]
    x, t, ctx, _ = _case(name)
    ref = jax_out[name]
    w = _nchw(np.random.RandomState(6).randn(2, 2 * HW[0], 2 * HW[1], 6)
              .astype(np.float32))
    grads = []
    for remat in (True, False):
        unet = _port(params, **kw, gradient_checkpointing=remat)
        # the queries replace the context: it is ignored
        out = unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
        if remat:
            _close(out.detach().permute(0, 2, 3, 1).numpy(), ref)
        (out * w).sum().backward()
        grads.append({n: p.grad for n, p in unet.named_parameters()})
    assert grads[0]["object_queries.weight"].abs().max() > 0
    for n, g in grads[1].items():
        torch.testing.assert_close(grads[0][n], g, rtol=1e-5, atol=1e-6)


def test_the_six_six_split_of_twelve_channels():
    """The trait: with self-conditioning the 12 input channels split 6/6,
    so the seg half takes two of the RGB latent's channels (JAX's
    ``jnp.split(sample, 2)`` as it stands); an odd count is refused, as
    JAX's split refuses it."""
    unet = UNet2DCondition(UNetConfig(**{**CROSS_KW, "in_channels": 12,
                                         "separate_conv": True}))
    assert unet.conv_in_seg.weight.shape[1] == 6
    assert unet.conv_in.weight.shape[1] == 6
    seen = {}

    def hook(module, inputs, out):
        seen["seg"] = inputs[0]
    unet.conv_in_seg.register_forward_hook(hook)
    x = torch.randn(1, 12, *HW)
    with torch.no_grad():
        unet(x, 10, torch.randn(1, 5, 16))
    assert torch.equal(seen["seg"], x[:, :6])
    for flag in ("separate_conv", "separate_encoder"):
        with pytest.raises(ValueError, match="even"):
            UNet2DCondition(UNetConfig(**{**CROSS_KW, "in_channels": 9,
                                          flag: True}))
    with pytest.raises(ValueError, match="equal division"):
        jnp.split(jnp.zeros((1, 9)), 2, axis=-1)


def test_fused_projs_take_no_cross_attention():
    """JAX's rule (unet.py:469-470, :547-548): the fused projs' Transformer2D
    path needs a block without cross-attention, so with it the 1x1 convs
    stay outside the kernels (K3 and K4 run, not K8 and K9)."""
    from ldmseg_torch.models.unet import BasicTransformerBlock, Transformer2D
    with pytest.raises(ValueError, match="cross-attention"):
        BasicTransformerBlock(16, 2, fused_norms=True, padded_attention=True,
                              int8_ff=True, fused_ff=True, fused_projs=True,
                              context_dim=16)
    t2d = Transformer2D(16, 2, 4, fused_norms=True, padded_attention=True,
                        fused_projs=True, context_dim=16,
                        int8=dict(int8_ff=True, fused_ff=True))
    assert not t2d.fused_projs
    assert hasattr(t2d.transformer_blocks[0], "attn2")


def test_upscaler_matches_jax():
    from ldmseg_tpu.models.upscaler import Upscaler as JUpscaler
    from ldmseg_torch.models.upscaler import Upscaler
    for fuse, ups in ((False, 1), (True, 2)):
        kw = dict(latent_channels=4, int_channels=16, upscaler_channels=8,
                  out_channels=6, num_upscalers=ups, fuse_rgb=fuse,
                  norm_num_groups=4)
        jm = JUpscaler(**kw)
        rng = np.random.RandomState(7)
        z = rng.randn(2, *HW, 4).astype(np.float32)
        zr = rng.randn(2, *HW, 4).astype(np.float32)
        zin = np.concatenate([z, zr], -1) if fuse else z
        params = _random_params(lambda: jm.init(
            jax.random.key(0), jnp.asarray(zin)), 30 + ups)
        port = Upscaler(**kw)
        port.load_state_dict(convert.upscaler_state_dict_from_jax(
            params, ups), strict=True)
        assert port.interpolation_factor == 8 // 2 ** ups
        for interp in (False, True):
            ref = np.asarray(_jit(
                lambda p, a, b: jm.apply(p, a, interp, b),
                params, jnp.asarray(z), jnp.asarray(zr)))
            with torch.no_grad():
                out = port(_nchw(z), interp, _nchw(zr))
            out = out.permute(0, 2, 3, 1).numpy()
            assert out.shape == ref.shape
            _close(out, ref)


def test_diffusers_cross_attention_round_trip(trees):
    """``attn2``/``norm2`` read and written by ``use_cross_attention``: the
    port's export is JAX's ``unet_sd_from_params`` key for key, in order,
    value for value, and its import of that dict loads the UNet strictly
    and equals JAX's ``unet_params_from_sd`` through the converter."""
    from ldmseg_tpu.models.torch_export import unet_sd_from_params
    from ldmseg_tpu.models.torch_import import unet_params_from_sd
    from ldmseg_torch.models.torch_export import _ordered, unet_keys
    from ldmseg_torch.models.torch_import import unet_state_dict
    params = trees["separate_encoder"]
    kw = VARIANTS["separate_encoder"]
    theirs = unet_sd_from_params(params, JUNetConfig(**CROSS_KW, **kw))
    assert any(".attn2." in k for k in theirs)
    unet = _port(params, **kw)
    ours = _ordered(unet.state_dict(), unet_keys(unet.state_dict(),
                                                 unet.config))
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
    back = unet_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in theirs.items()}, unet.config)
    # the reference's format holds no surgery: a plain SD UNet reads it
    # (conv_in the seg half's 4 channels)
    plain_cross = UNetConfig(**{**CROSS_KW, "in_channels": 4})
    UNet2DCondition(plain_cross).load_state_dict(back, strict=True)
    jtree = unet_params_from_sd(theirs, JUNetConfig(**CROSS_KW))
    ref = convert.unet_state_dict_from_jax(jtree, unet.config)
    assert set(ref) == set(back)
    for k in ref:
        assert torch.equal(ref[k], back[k]), k
    # without cross-attention the dict's attn2/norm2 are left out
    plain = UNetConfig(**{**CROSS_KW, "use_cross_attention": False})
    assert not any(".attn2." in k or "blocks.0.norm2." in k
                   for k in unet_state_dict(back, plain))


def test_freeze_filter_selects_the_image_branch():
    from ldmseg_torch.train.optim import freeze_filter
    unet = UNet2DCondition(UNetConfig(**VARIANTS["separate_encoder"],
                                      **CROSS_KW))
    names = [n for n, _ in unet.named_parameters()]
    for layer, prefix in (("conv_in", "conv_in_img."),
                          ("down_blocks", "down_blocks_img.")):
        flt = freeze_filter((layer,))
        frozen = {n for n in names if flt(n)}
        assert frozen == {n for n in names if n.startswith(prefix)}
        assert frozen
    assert not freeze_filter(("conv_in",))("conv_in.weight")


def test_adaptors_start_at_zero_and_queries_normal():
    from ldmseg_torch.models.layers import init_random_
    unet = UNet2DCondition(UNetConfig(**{**CROSS_KW, "separate_encoder": True,
                                         "add_adaptor": True,
                                         "num_object_queries": 64}))
    init_random_(unet, torch.Generator().manual_seed(0))
    assert all(float(c.weight.detach().abs().max()) == 0.0
               and float(c.bias.detach().abs().max()) == 0.0
               for level in unet.adaptors for c in level)
    q = unet.object_queries.weight.detach()
    assert 0.8 < float(q.std()) < 1.2
    assert float(unet.conv_in_img.weight.detach().abs().max()) > 0
