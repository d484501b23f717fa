"""The int8 VAEs and the image-VAE decoder against the JAX package on the
CPU, on the same weights (``models/convert.py``) and inputs.

* ``s8_conv2d`` with a stride and any padding, the image VAE's asymmetric
  ``((0, 1), (0, 1))`` among them: int32 sums bit-equal to JAX's
  ``_s8_conv``; ``QuantConv2d`` with that padding, prepared and not,
  against ``QuantConv`` on its float and its prequantized kernel.
* int8 ``ConvTranspose2x`` against JAX's on the float kernel (one scale
  per (tap, channel) column, ``int8_dot``'s form, which the JAX trainer
  takes: it prequantizes no VAE).
* ``prepare_int8_vae``'s codes and scales bit-equal to
  ``prequantize_conv_tree``'s for the convs of the int8 image encoder and
  the int8 seg decoder, and to ``int8_dot``'s for the seg decoder's
  upscalers.
* The int8 image encoder (JAX's test shapes, ``block_out_channels=(32,
  64)``, with fused attention), the image-VAE decoder and ``forward``, and
  the int8 seg decoder (JAX's shapes) against JAX's modules in fp32; the
  trainer's int8 seg decode (``vae_model_kwargs.use_int8``) against the
  JAX trainer's (its ``SegVAE(use_int8=True)`` on the float tree).

Tolerances: the float parts (the decoder, ``forward``) within 1e-4 of
max|ref|. Where activations are quantized, the two sides' fp32 sums run in
other orders, so a value within an ulp of a code's .5 boundary may round
to the neighbouring code, which moves an output by one code's share
(``act_scale · w_scale`` times a weight): the int8 modules are held within
``INT8_TOL`` of max|ref| on the max and ``INT8_MEAN_TOL`` of mean|ref| on
the mean.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.layers import ConvTranspose2x as JConvT  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.image_vae import ImageVAE  # noqa: E402
from ldmseg_torch.models.layers import ConvTranspose2x  # noqa: E402
from ldmseg_torch.models.seg_vae import SegVAE  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402

from test_torch_port_models import _random_params  # noqa: E402

FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
INT8_TOL, INT8_MEAN_TOL = 2e-2, 1e-4
FLOAT_TOL = 1e-4
# JAX's own test shapes (tests/test_int8_inference.py:128-143, :305-330)
IVAE_KW = dict(block_out_channels=(32, 64))
SVAE_KW = dict(in_channels=16, out_channels=32, num_upscalers=2,
               int_channels=64, upscale_channels=64, norm_num_groups=8,
               block_out_channels=(8, 16, 32, 64))
DEC_KW = dict(block_out_channels=(8, 8, 16, 16), groups=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(
        *args)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def _close(out, ref, tol=FLOAT_TOL):
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), err


def _int8_close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    diff = np.abs(out - ref)
    assert diff.max() <= INT8_TOL * np.abs(ref).max(), diff.max()
    assert diff.mean() <= INT8_MEAN_TOL * np.abs(ref).mean(), diff.mean()


def _prequant_leaf(leaf):
    q, s = jquant.quantize_weight(leaf["kernel"])
    return dict(leaf, kernel={"q": q, "scale": s})


def _int8_dot_codes(kernel):
    """The codes and column scales JAX's ``ConvTranspose2x`` gets from
    ``int8_dot`` on a float ``[2, 2, C, O]`` kernel (layers.py:291-295,
    quant.py:370-373), as ``[C, 4·O]`` and ``[4·O]``."""
    k = jnp.asarray(kernel)
    w2 = k[::-1, ::-1].transpose(2, 0, 1, 3).reshape(k.shape[2], -1)
    w2 = w2.astype(jnp.float32)
    ws = jnp.maximum(jnp.max(jnp.abs(w2), axis=0), 1e-8) / 127.0
    return np.asarray(jnp.round(w2 / ws).astype(jnp.int8)), np.asarray(ws)


# ---------------------------------------------------------------------------
# the s8 convolution, QuantConv2d and ConvTranspose2x
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("stride,padding", [
    (2, ((0, 1), (0, 1))), (1, 1), (2, 1), (1, ((1, 0), (0, 2))), (2, 0)])
def test_s8_conv_sums_equal_jax(stride, padding):
    rng = np.random.RandomState(stride)
    x8 = rng.randint(-127, 128, (2, 9, 11, 24)).astype(np.int8)
    w8 = rng.randint(-127, 128, (3, 3, 24, 16)).astype(np.int8)
    ref = np.asarray(jquant._s8_conv(jnp.asarray(x8), jnp.asarray(w8),
                                     (stride, stride),
                                     list(quant.pad_pairs(padding))))
    w_mat = torch.from_numpy(w8).permute(3, 0, 1, 2).reshape(16, -1)
    out = quant.s8_conv2d(_nchw(x8), w_mat, stride, padding)
    assert out.dtype == torch.int32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("act_scale", [None, 0.05])
def test_quant_conv_with_the_downsample_padding_matches_jax(act_scale):
    x = np.random.RandomState(3).randn(2, 12, 10, 16).astype(np.float32)
    pad = ((0, 1), (0, 1))
    jmod = jquant.QuantConv(8, (3, 3), strides=(2, 2), padding=pad,
                            act_scale=act_scale)
    params = _random_params(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, 12, 10, 16))), 4)
    ref = np.asarray(_jit(jmod.apply, params, jnp.asarray(x)))
    ref_pq = np.asarray(_jit(jmod.apply, {"params": _prequant_leaf(
        params["params"])}, jnp.asarray(x)))
    _int8_close(ref_pq, ref)  # XLA's two forms: a code apart
    port = quant.QuantConv2d(16, 8, stride=2, act_scale=act_scale,
                             padding=pad)
    sd = {}
    convert._conv(sd, "c", params["params"])
    port.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    with torch.no_grad():
        unprepared = port(_nchw(x))
        quant.prepare_int8_vae(port)
        prepared = port(_nchw(x))
    assert torch.equal(unprepared, prepared)
    _int8_close(_nhwc(prepared), ref)
    # the straight-through path pads before the float conv's gradient
    xg = _nchw(x).requires_grad_(True)
    port.w_q = None
    port(xg).sum().backward()
    assert xg.grad.shape == xg.shape and bool(torch.isfinite(xg.grad).all())


@pytest.mark.parametrize("act_scale", [None, 0.05])
def test_int8_conv_transpose_matches_jax(act_scale):
    x = np.random.RandomState(5).randn(2, 5, 6, 16).astype(np.float32)
    jmod = JConvT(12, use_int8=True, act_scale=act_scale)
    params = _random_params(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, 5, 6, 16))), 6)
    # the float kernel: int8_dot's one scale per (tap, channel) column
    ref = np.asarray(_jit(jmod.apply, params, jnp.asarray(x)))
    port = ConvTranspose2x(16, 12, use_int8=True, act_scale=act_scale)
    sd = {}
    convert._conv_transpose(sd, "c", params["params"])
    port.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    with torch.no_grad():
        unprepared = port(_nchw(x))
        quant.prepare_int8_vae(port)
        prepared = port(_nchw(x))
    assert torch.equal(unprepared, prepared)
    assert prepared.shape == (2, 12, 10, 12)
    q, ws = _int8_dot_codes(params["params"]["kernel"])
    np.testing.assert_array_equal(port.w_q.numpy().T, q)
    np.testing.assert_array_equal(port.w_scale.numpy(), ws)
    _int8_close(_nhwc(prepared), ref)


# ---------------------------------------------------------------------------
# the int8 image encoder
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def image_encoder():
    x = np.random.RandomState(1).randn(2, 32, 64, 3).astype(np.float32)
    kw = dict(IVAE_KW, decoder_enabled=False, use_fused_attention=True)
    jb = JImageVAE(**kw)
    ji = JImageVAE(**kw, use_int8=True, int8_act_scale=0.05)
    params = _random_params(lambda: jb.init(
        jax.random.key(0), jnp.zeros((1, 32, 64, 3)),
        method=JImageVAE.encode), 7)

    def encode(model, p, x):
        return model.apply(p, x, method=JImageVAE.encode).mode()
    ref_f = np.asarray(_jit(lambda p, x: encode(jb, p, x), params,
                            jnp.asarray(x)))
    ref_8 = np.asarray(_jit(lambda p, x: encode(ji, p, x), params,
                            jnp.asarray(x)))
    port = ImageVAE(**IVAE_KW, use_fused_attention=True, use_int8=True,
                    int8_act_scale=0.05)
    port.load_state_dict(convert.image_vae_state_dict_from_jax(params),
                         strict=True)
    quant.prepare_int8_vae(port)
    return params, x, ref_f, ref_8, port


def test_int8_image_encoder_matches_jax(image_encoder):
    _, x, ref_f, ref_8, port = image_encoder
    with torch.no_grad():
        out = _nhwc(port.encode(_nchw(x)).mode())
    assert out.shape == (2, 16, 32, 4) and np.isfinite(out).all()
    _int8_close(out, ref_8)
    # the quantization changed something, and tracks the float encoder as
    # JAX's gate asks (correlation > 0.99)
    assert np.abs(ref_8 - ref_f).max() > 10 * np.abs(out - ref_8).max()
    assert np.corrcoef(out.ravel(), ref_f.ravel())[0, 1] > 0.99


def test_prepared_image_encoder_codes_equal_prequantize(image_encoder):
    params, _, _, _, port = image_encoder
    tree = jquant.prequantize_conv_tree(params)["params"]["encoder"]
    seen = 0
    for name, m in port.encoder.named_modules():
        if not isinstance(m, quant.QuantConv2d):
            continue
        parts = name.split(".")
        if parts[0] == "down_blocks":
            blk = tree[f"down{parts[1]}"]
            leaf = (blk["downsample"] if parts[2] == "downsamplers"
                    else blk[f"resnet{parts[3]}"][parts[4]])
        else:  # mid_block.resnets.<j>.conv<k>
            leaf = tree[f"mid_resnet{parts[2]}"][parts[3]]
        q = np.asarray(leaf["kernel"]["q"])          # [3, 3, Cin, Cout]
        np.testing.assert_array_equal(
            m.weight_codes().numpy(), q.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(m.w_scale.numpy(),
                                      np.asarray(leaf["kernel"]["scale"]))
        seen += 1
    # two resnets of two convs in each of two blocks, one downsample, the
    # mid block's two resnets
    assert seen == 2 * 2 * 2 + 1 + 2 * 2


# ---------------------------------------------------------------------------
# the image-VAE decoder and forward
# ---------------------------------------------------------------------------
def test_image_vae_decoder_and_forward_match_jax():
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.randn(2, 4, 4, 4).astype(np.float32)
    jmod = JImageVAE(decoder_enabled=True, **DEC_KW)
    params = _random_params(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3))), 9)
    dec = np.asarray(_jit(lambda p, z: jmod.apply(p, z,
                                                  method=JImageVAE.decode),
                          params, jnp.asarray(z)))
    rec = np.asarray(_jit(lambda p, x: jmod.apply(p, x)[0], params,
                          jnp.asarray(x)))
    port = ImageVAE(decoder_enabled=True, **DEC_KW)
    sd = convert.image_vae_state_dict_from_jax(params)
    assert any(k.startswith("decoder.up_blocks.3.resnets.2") for k in sd)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out_dec = _nhwc(port.decode(_nchw(z)))
        out_rec, post = port(_nchw(x))
    assert out_dec.shape == (2, 32, 32, 3)
    _close(out_dec, dec)
    _close(_nhwc(out_rec), rec)
    # a sample from the posterior with the given noise
    noise = rng.randn(2, 4, 4, 4).astype(np.float32)
    with torch.no_grad():
        sampled, _ = port(_nchw(x), sample_posterior=True,
                          noise=_nchw(noise))
        want = port.decode(post.mean + torch.exp(0.5 * post.logvar)
                           * _nchw(noise))
    assert torch.equal(sampled, want)
    with pytest.raises(RuntimeError, match="decoder_enabled"):
        ImageVAE(**DEC_KW).decode(_nchw(z))


# ---------------------------------------------------------------------------
# the int8 seg decoder
# ---------------------------------------------------------------------------
def test_int8_seg_decoder_matches_jax():
    z = np.random.RandomState(2).randn(2, 8, 8, 4).astype(np.float32) * 5.0
    jb = JSegVAE(**SVAE_KW)
    ji = JSegVAE(**SVAE_KW, use_int8=True)
    params = _random_params(lambda: jb.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.zeros((1, 64, 64, 16)), sample_posterior=False), 10)

    def decode(model, p, z):
        return model.apply(p, z, True, method=JSegVAE.decode)
    ref_f = np.asarray(_jit(lambda p, z: decode(jb, p, z), params,
                            jnp.asarray(z)))
    # the float tree, as the JAX trainer decodes
    ref_8 = np.asarray(_jit(lambda p, z: decode(ji, p, z), params,
                            jnp.asarray(z)))
    pq = jquant.prequantize_conv_tree(params)
    port = SegVAE(**SVAE_KW, use_int8=True)
    port.load_state_dict(convert.seg_vae_state_dict_from_jax(
        params, SVAE_KW), strict=True)
    quant.prepare_int8_vae(port)
    # the prepared convs' codes are prequantize_conv_tree's, the
    # upscalers' int8_dot's
    dec = pq["params"]["decoder"]
    convs = {"in_conv": port.decoder[0], "out_conv": port.decoder[-1]}
    for name, m in convs.items():
        np.testing.assert_array_equal(
            m.weight_codes().numpy(),
            np.asarray(dec[name]["kernel"]["q"]).transpose(3, 2, 0, 1))
    for i, idx in enumerate((2, 5)):
        m = port.decoder[idx]
        q, ws = _int8_dot_codes(
            params["params"]["decoder"][f"up{i}_convt"]["kernel"])
        np.testing.assert_array_equal(m.w_q.numpy().T, q)
        np.testing.assert_array_equal(m.w_scale.numpy(), ws)
    with torch.no_grad():
        out = _nhwc(port.decode(_nchw(z), True))
    assert out.shape == ref_8.shape == (2, 64, 64, 32)
    _int8_close(out, ref_8)
    assert np.abs(ref_8 - ref_f).max() > 10 * np.abs(out - ref_8).max()


def test_trainer_int8_seg_decode_matches_the_jax_trainer():
    """``vae_model_kwargs.use_int8``: the trainer builds the int8 seg VAE,
    prepares it with the weights, and decodes as the JAX trainer does
    (``trainer_ldm.py:883-887``: ``SegVAE(**vae_model_kwargs)`` on the
    float frozen tree, the latents over the scaling factor)."""
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import merge_dicts
    from test_torch_port_sampling import CFG, UNET_KW
    from ldmseg_torch.models.unet import UNetConfig

    cfg = merge_dicts(CFG, {"vae_model_kwargs": {"use_int8": True}})
    vk = {k: v for k, v in cfg["vae_model_kwargs"].items()
          if k != "pretrained_path"}
    vk["block_out_channels"] = tuple(vk["block_out_channels"])
    jmod = JSegVAE(**vk)
    assert jmod.use_int8
    params = _random_params(lambda: jmod.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.zeros((1, 32, 64, vk["in_channels"])), sample_posterior=False),
        11)
    x0 = np.random.RandomState(4).randn(2, 4, 8, 4).astype(np.float32)
    scale = vk.get("scaling_factor", 0.2)
    ref = np.asarray(_jit(lambda p, z: jmod.apply(
        p, z * (1.0 / scale), True, method=JSegVAE.decode), params,
        jnp.asarray(x0)))
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(**UNET_KW),
                               device=torch.device("cpu"))
    trainer.load_state_dicts(vae_seg=convert.seg_vae_state_dict_from_jax(
        params, trainer.vae_seg_kwargs))
    ups = [m for m in trainer.vae_seg.modules()
           if isinstance(m, ConvTranspose2x)]
    assert len(ups) == 2 and all(m.use_int8 and m.w_q is not None
                                 for m in ups)
    with torch.no_grad():
        z = _nchw(x0) * (1.0 / trainer.seg_scale)
        out = _nhwc(trainer.vae_seg.decode(z.to(trainer.compute_dtype),
                                           True))
    assert out.shape == ref.shape == (2, 32, 64, vk["out_channels"])
    _int8_close(out, ref)
