"""Spatial parallelism of the frozen VAEs (``ldmseg_torch/parallel/sp.py``)
against the JAX package's ``parallel/sp.py`` on the conftest's virtual CPU
devices. On 2 gloo ranks (a ``(1, 2)`` mesh) each layer and VAE stage runs
on its rows of H through ``sp.run_stage`` (the halos exchanged, the
GroupNorm sums all-reduced, the output gathered); JAX runs the same layer
on ``spatial_constraint`` of its input on a ``(1, 2)`` mesh:

  * the stride-2 convolution with symmetric padding (the seg VAE
    encoder's), the ``(0, 1)``-padded stride-2 convolution (the image VAE's
    downsample), nearest 2x then a 3x3 convolution (its upsample), the
    bilinear x2 and x4 of the seg VAE's decode, ``Resize``'s /8 (the
    ``resize_input`` encoder's), the sharded GroupNorm;
  * the ``SegVAE`` encode and decode, and the ``ImageVAE`` encode in fp32
    and in bf16 (the trainer's RGB latents, the mode x 0.18215);
  * a stage whose shards the total stride (8) does not divide runs whole
    on every rank (``run_stage.replicated``); an H the axis does not divide
    is not sharded at all (JAX's no-op).

JAX's own bounds (``test_spatial_parallel.py:76, 100, 150-152``): 2e-5 in
fp32, 1e-2 (relative and absolute) on the bf16 RGB latents.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from flax import linen as fnn  # noqa: E402

from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import nearest_upsample_2x  # noqa: E402
from ldmseg_tpu.ops.resize import bilinear_upsample_2x  # noqa: E402
from ldmseg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ldmseg_tpu.parallel.sp import spatial_constraint  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.seg_vae import DiagonalGaussian  # noqa: E402
from ldmseg_torch.parallel import sp  # noqa: E402
from ldmseg_torch.parallel.launch import run_ranks  # noqa: E402
from ldmseg_torch.parallel.mesh import Mesh  # noqa: E402

import torch_dp_workers as W  # noqa: E402
from test_torch_port_sampling import CFG, _random_params  # noqa: E402

FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
SEG_KW = {k: v for k, v in CFG["vae_model_kwargs"].items()
          if k != "pretrained_path"}
SEG_KW["block_out_channels"] = tuple(SEG_KW["block_out_channels"])
IMG_KW = dict(CFG["image_vae_kwargs"],
              block_out_channels=tuple(
                  CFG["image_vae_kwargs"]["block_out_channels"]))


class _NearestConv(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Conv(8, (3, 3), padding=1, name="conv")(
            nearest_upsample_2x(x))


# kind: (JAX module or function, input NHWC shape)
LAYERS = {
    "conv_s2": (fnn.Conv(8, (3, 3), strides=(2, 2), padding=1),
                (2, 32, 16, 8)),
    "down_pad": (fnn.Conv(8, (3, 3), strides=(2, 2),
                          padding=((0, 1), (0, 1))), (2, 32, 16, 8)),
    "nearest_conv": (_NearestConv(), (2, 16, 8, 8)),
    "group_norm": (fnn.GroupNorm(num_groups=4, epsilon=1e-6),
                   (2, 32, 16, 8)),
    "bilinear_2": (bilinear_upsample_2x, (2, 16, 8, 8)),
    "bilinear_4": (lambda x: jax.image.resize(
        x, (x.shape[0], 4 * x.shape[1], 4 * x.shape[2], x.shape[3]),
        "linear"), (2, 16, 8, 8)),
    "resize": (lambda x: jax.image.resize(
        x, (x.shape[0], x.shape[1] // 8, x.shape[2] // 8, x.shape[3]),
        "linear"), (2, 32, 16, 8)),
}


def _mesh():
    return jmake_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])


def _jax_sharded(fn, *args):
    """``fn`` on ``spatial_constraint`` of the last argument (NHWC) on a
    ``(1, 2)`` mesh, compiled at XLA's lowest optimisation level."""
    mesh = _mesh()

    def run(*a):
        return fn(*a[:-1], spatial_constraint(a[-1], mesh))
    out = jax.jit(run).lower(*args).compile(compiler_options=FAST_XLA)(*args)
    return jax.tree_util.tree_map(np.asarray, out)


def _nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def _layer_case(kind, rng):
    """The port's case and JAX's output of one layer."""
    mod, shape = LAYERS[kind]
    x = rng.randn(*shape).astype(np.float32)
    sd = {}
    if isinstance(mod, fnn.Module):
        params = _random_params(lambda: mod.init(jax.random.key(0), x),
                                len(kind))
        ref = _jax_sharded(mod.apply, params, jnp.asarray(x))
        leaf = params["params"]
        leaf = leaf.get("conv", leaf)
        if "kernel" in leaf:
            state = {"weight": torch.from_numpy(np.asarray(
                leaf["kernel"]).transpose(3, 2, 0, 1).copy()),
                "bias": torch.from_numpy(np.asarray(leaf["bias"]))}
        else:
            state = {"weight": torch.from_numpy(np.asarray(leaf["scale"])),
                     "bias": torch.from_numpy(np.asarray(leaf["bias"]))}
        if kind in ("down_pad", "nearest_conv"):
            state = {f"conv.{k}": v for k, v in state.items()}
        sd["state"] = state
    else:
        ref = _jax_sharded(mod, jnp.asarray(x))
        if kind.startswith("bilinear"):
            sd["kw"] = dict(SEG_KW, num_upscalers=2 if kind == "bilinear_2"
                            else 1)
    return (kind, sd, _nchw(x)), ref


def _vae_cases(rng):
    """The port's VAE cases and JAX's outputs (posterior moments or
    logits, NHWC)."""
    svae = JSegVAE(**SEG_KW)
    sp_ = _random_params(lambda: svae.init(
        {"params": jax.random.key(2), "sample": jax.random.key(2)},
        jnp.zeros((1, 32, 64, 10)), sample_posterior=False), 2)
    ivae = JImageVAE(decoder_enabled=False, **IMG_KW)
    ip = _random_params(lambda: ivae.init(
        jax.random.key(1), jnp.zeros((1, 32, 64, 3)),
        method=JImageVAE.encode), 1)
    seg_sd = convert.seg_vae_state_dict_from_jax(sp_, SEG_KW)
    img_sd = convert.image_vae_state_dict_from_jax(ip)
    bits = rng.randn(2, 32, 64, 10).astype(np.float32)
    bits40 = rng.randn(2, 40, 64, 10).astype(np.float32)
    z = rng.randn(2, 4, 8, 4).astype(np.float32)
    rgb = np.clip(rng.randn(2, 32, 64, 3), -1, 1).astype(np.float32)

    def moments(post):
        return (post.mean, post.logvar)
    refs, cases = {}, []
    seg = {"kw": SEG_KW, "state": seg_sd}
    for kind, x in (("seg_encode", bits), ("replicated", bits40)):
        refs[kind] = _jax_sharded(lambda p, xx: moments(svae.apply(
            p, xx, method=JSegVAE.encode)), sp_, jnp.asarray(x))
        cases.append((kind, seg, _nchw(x)))
    refs["seg_decode"] = _jax_sharded(lambda p, zz: svae.apply(
        p, zz, True, method=JSegVAE.decode), sp_, jnp.asarray(z))
    cases.append(("seg_decode", seg, _nchw(z)))
    img = {"kw": dict(IMG_KW, use_fused_attention=True), "state": img_sd}
    refs["image_encode"] = _jax_sharded(lambda p, xx: moments(ivae.apply(
        p, xx, method=JImageVAE.encode)), ip, jnp.asarray(rgb))
    cases.append(("image_encode", img, _nchw(rgb)))
    ip16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), ip)
    refs["image_encode_bf16"] = _jax_sharded(lambda p, xx: moments(
        ivae.apply(p, xx, method=JImageVAE.encode)), ip16,
        jnp.asarray(rgb, jnp.bfloat16))
    cases.append(("image_encode", dict(img, dtype=torch.bfloat16),
                  _nchw(rgb)))
    return cases, refs


@pytest.fixture(scope="module")
def sp_runs():
    rng = np.random.RandomState(0)
    cases, refs = [], {}
    for kind in LAYERS:
        case, refs[kind] = _layer_case(kind, rng)
        cases.append(case)
    vae_cases, vae_refs = _vae_cases(rng)
    names = list(LAYERS) + ["seg_encode", "replicated", "seg_decode",
                            "image_encode", "image_encode_bf16"]
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, W.sp_layers, 2,
                              args=(cases + vae_cases,), device="cpu",
                              timeout_s=240)
        ranks = spawned.result()
    refs.update(vae_refs)
    return {n: (refs[n], [r[i] for r in ranks]) for i, n in
            enumerate(names)}


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("kind", list(LAYERS))
def test_haloed_layer_matches_jax(sp_runs, kind):
    ref, ranks = sp_runs[kind]
    for r in ranks:
        assert r["sharded"] == 1 and r["replicated"] == 0
        np.testing.assert_allclose(_nhwc(r["out"]), ref, rtol=2e-5,
                                   atol=2e-5)


def _check_moments(out, ref, tol):
    post = DiagonalGaussian.from_moments(out)
    for ours, theirs in zip((post.mean, post.logvar), ref):
        np.testing.assert_allclose(_nhwc(ours), theirs, rtol=tol, atol=tol)


@pytest.mark.parametrize("stage", ["seg_encode", "seg_decode",
                                   "image_encode", "image_encode_bf16"])
def test_vae_stage_matches_jax(sp_runs, stage):
    ref, ranks = sp_runs[stage]
    for r in ranks:
        assert r["sharded"] == 1 and r["replicated"] == 0
        assert torch.equal(r["out"], ranks[0]["out"])  # the ranks agree
        if stage == "seg_decode":
            np.testing.assert_allclose(_nhwc(r["out"]), ref, rtol=2e-5,
                                       atol=2e-5)
        elif stage == "image_encode_bf16":
            # the trainer's RGB latents, the posterior's mode x 0.18215,
            # at JAX's bound for them (test_spatial_parallel.py:150-152)
            mean = DiagonalGaussian.from_moments(r["out"]).mean
            np.testing.assert_allclose(
                _nhwc(mean) * 0.18215,
                np.asarray(ref[0], np.float32) * 0.18215, rtol=1e-2,
                atol=1e-2)
        else:
            _check_moments(r["out"], ref, 2e-5)


def test_unaligned_shards_run_the_stage_whole(sp_runs):
    # H 40 over 2 ranks: shards of 20 rows, which the stride 8 does not
    # divide: every rank encodes the whole image, counted
    ref, ranks = sp_runs["replicated"]
    for r in ranks:
        assert r["replicated"] == 1 and r["sharded"] == 0
        _check_moments(r["out"], ref, 2e-5)


def test_constraints_and_their_no_ops():
    x = torch.arange(2 * 6 * 4 * 3.0).reshape(2, 6, 4, 3)
    mesh = Mesh(model=2, model_rank=1)
    assert sp.has_spatial_axis(mesh) and not sp.has_spatial_axis(Mesh())
    assert torch.equal(sp.spatial_constraint(x, mesh), x[:, 3:])
    assert torch.equal(sp.spatial_constraint(x, mesh, dim=2), x[:, :, 2:])
    # no model axis, an H the axis does not divide, a low rank: x itself
    assert sp.spatial_constraint(x, Mesh()) is x
    assert sp.spatial_constraint(x[:, :5], mesh).shape == (2, 5, 4, 3)
    assert sp.spatial_constraint(x[0, 0], mesh).shape == (4, 3)
    assert sp.batch_constraint(x, Mesh()) is x
    before = sp.run_stage.replicated
    # no model axis: the stage runs as it is, nothing counted
    assert torch.equal(sp.run_stage(lambda t: t * 2, x, Mesh()), x * 2)
    assert sp.run_stage.replicated == before and sp.active() is None


def _spatial_kinds():
    from ldmseg_torch.models import image_vae, layers, seg_vae
    from ldmseg_torch.ops.quant import QuantConv2d
    return {
        "group_norm": (lambda: layers.GroupNorm(4, 8, 1e-6), (2, 8, 8, 6)),
        "group_norm_silu": (lambda: layers.GroupNormSiLU(4, 8, 1e-6),
                            (2, 8, 8, 6)),
        "down_pad": (lambda: image_vae._Downsample(8), (2, 8, 8, 6)),
        "attention": (lambda: layers.AttentionBlock2D(8, 4),
                      (2, 8, 4, 6)),
        "resize": (lambda: seg_vae.Resize(4), (2, 8, 8, 8)),
        # the int8 VAEs' layers (serving on the model axis)
        "group_norm_silu_lowp": (lambda: layers.GroupNormSiLU(
            4, 8, 1e-6, lowp=True), (2, 8, 8, 6)),
        "s8_conv": (lambda: _prepared(QuantConv2d(8, 8)), (2, 8, 8, 6)),
        "s8_down_pad": (lambda: _prepared(image_vae._Downsample(
            8, use_int8=True)), (2, 8, 8, 6)),
        "s8_upscaler": (lambda: _prepared(layers.ConvTranspose2x(
            8, 4, use_int8=True)), (2, 8, 8, 6)),
    }


def _prepared(m):
    from ldmseg_torch.ops.quant import prepare_int8_vae
    return prepare_int8_vae(m)


@pytest.mark.parametrize("kind", list(_spatial_kinds()))
def test_apply_sp_swaps_the_class_and_runs_as_before_outside_a_stage(kind):
    make, shape = _spatial_kinds()[kind]
    torch.manual_seed(0)
    m = make()
    base = type(m)
    x = torch.randn(shape)
    want = m(x)
    assert sp.apply_sp(m) is m
    assert type(m) is not base and isinstance(m, base)
    assert torch.equal(m(x), want)


@pytest.mark.parametrize("kind", ["use_pallas", "quantize", "int8"])
def test_apply_sp_refuses_what_it_does_not_take(kind):
    from ldmseg_torch.models import image_vae, layers
    m = (image_vae._Downsample(8, use_int8=True) if kind == "int8"
         else layers.GroupNormSiLU(4, 8, 1e-6, **{kind: True}))
    if kind == "int8":
        # taken since serving came to the model axis: the s8 conv with its
        # halo (test_torch_port_model_axis_context)
        sp.apply_sp(m)
        assert isinstance(m, sp.SpatialDownsample)
        assert isinstance(m.conv, sp.SpatialQuantConv2d)
        return
    with pytest.raises(NotImplementedError, match="spatial parallelism"):
        sp.apply_sp(m)
