"""The port's models and weight converters against the JAX package.

A small UNet (block_out (32, 64), attention in the first level, one layer
per block, 2 heads, 8 groups, 12 input channels, no cross-attention, fused
attention), a small SD image-VAE encoder and the SegVAE decode, each with
the JAX weights converted by ``ldmseg_torch.models.convert``. Outputs agree
within 1e-4 * max(1, max|ref|) in fp32. The converters must also match
``ldmseg_tpu.models.torch_export`` key for key and value for value.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models import torch_export  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.image_vae import ImageVAE  # noqa: E402
from ldmseg_torch.models.seg_vae import SegVAE  # noqa: E402
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa: E402

UNET_KW = dict(in_channels=12, out_channels=4, block_out_channels=(32, 64),
               attn_down=(True, False), layers_per_block=1,
               attention_head_dim=2, norm_num_groups=8,
               use_fused_attention=True)
IVAE_KW = dict(block_out_channels=(8, 8, 16, 16), groups=8)
SVAE_KW = dict(in_channels=10, int_channels=16, out_channels=24,
               block_out_channels=(8, 8, 16, 16), upscale_channels=16,
               norm_num_groups=8)


def _random_params(init, seed):
    """The Flax parameters ``init()`` would make, drawn with numpy: tracing
    the shapes is far cheaper on the CPU than running ``init``. Kernels are
    LeCun-normal; norm scales and biases are randomised too, so that every
    leaf's mapping is exercised."""
    shapes = jax.eval_shape(init)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.randn(*leaf.shape).astype(np.float32) / fan_in**0.5
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    bound = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def unet():
    model = JUNet(JUNetConfig(use_cross_attention=False, **UNET_KW))
    x = np.random.RandomState(0).randn(2, 8, 16, 12).astype(np.float32)
    params = _random_params(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 8, 16, 12)),
        jnp.zeros((1,), jnp.int32)), 0)
    return model, params, x


@pytest.fixture(scope="module")
def image_vae():
    model = JImageVAE(decoder_enabled=False, **IVAE_KW)
    x = np.random.RandomState(1).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32)
    params = _random_params(lambda: model.init(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)),
        method=JImageVAE.encode), 1)
    return model, params, x


@pytest.fixture(scope="module", params=[1, 2], ids=lambda n: f"up{n}")
def seg_vae(request):
    kw = dict(SVAE_KW, num_upscalers=request.param)
    model = JSegVAE(**kw)
    params = _random_params(lambda: model.init(
        {"params": jax.random.key(2), "sample": jax.random.key(3)},
        jnp.zeros((1, 32, 32, 10)), sample_posterior=False), 2)
    z = np.random.RandomState(2).randn(2, 4, 8, 4).astype(np.float32)
    return model, params, z, kw


def test_unet_matches_jax(unet):
    model, params, x = unet
    t = np.array([999, 19], np.int32)
    ref = jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t))
    port = UNet2DCondition(UNetConfig(**UNET_KW))
    port.load_state_dict(
        convert.unet_state_dict_from_jax(params, port.config), strict=True)
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(t))
    _close(_nhwc(out), ref)


def test_image_vae_encoder_matches_jax(image_vae):
    model, params, x = image_vae
    @jax.jit
    def encode(p, x):
        post = model.apply(p, x, method=JImageVAE.encode)
        return post.mode(), post.logvar

    mean, logvar = encode(params, jnp.asarray(x))
    port = ImageVAE(**IVAE_KW)
    port.load_state_dict(convert.image_vae_state_dict_from_jax(params),
                         strict=True)
    with torch.no_grad():
        out = port.encode(_nchw(x))
    _close(_nhwc(out.mode()), mean)
    _close(_nhwc(out.logvar), logvar)


def test_seg_vae_decode_matches_jax(seg_vae):
    model, params, z, kw = seg_vae
    ref = jax.jit(functools.partial(model.apply, method=JSegVAE.decode),
                  static_argnums=2)(params, jnp.asarray(z), True)
    port = SegVAE(**kw)
    port.load_state_dict(convert.seg_vae_state_dict_from_jax(params, kw),
                         strict=True)
    with torch.no_grad():
        out = port.decode(_nchw(z), True)
    assert out.shape[-2:] == (32, 64)
    _close(_nhwc(out), ref)


def _same_state(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_unet_converter_matches_torch_export(unet):
    _, params, _ = unet
    cfg = UNetConfig(**UNET_KW)
    ours = convert.unet_state_dict_from_jax(params, cfg)
    _same_state(ours, torch_export.unet_sd_from_params(
        params, JUNetConfig(use_cross_attention=False, **UNET_KW)))
    UNet2DCondition(cfg).load_state_dict(ours, strict=True)


def test_image_vae_converter_matches_torch_export(image_vae):
    _, params, _ = image_vae
    ours = convert.image_vae_state_dict_from_jax(params)
    _same_state(ours, torch_export.image_vae_sd_from_params(
        params, decoder_enabled=False))
    ImageVAE(**IVAE_KW).load_state_dict(ours, strict=True)


def test_seg_vae_converter_matches_torch_export(seg_vae):
    # encoder and decoder: every key torch_export emits
    _, params, _, kw = seg_vae
    ours = convert.seg_vae_state_dict_from_jax(params, kw)
    theirs = torch_export.seg_vae_sd_from_params(
        params, kw["block_out_channels"], kw["num_upscalers"])
    assert any(k.startswith("encoder.") for k in theirs)
    _same_state(ours, theirs)
    SegVAE(**kw).load_state_dict(ours, strict=True)
