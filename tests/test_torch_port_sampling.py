"""The port's DDIM schedule, sampler, post-processing and the whole
``sample_panoptic`` slice against the JAX package on the CPU, in fp32.

The JAX side of the end-to-end case is not the JAX trainer (its tests are
slow-marked for their compile cost): it composes the same functions the
trainer's ``sample_panoptic`` runs, at the tiny sizes of
``__graft_entry__.dryrun_multichip``, with 2 DDIM steps and
self-conditioning. Both sides get the same weights and the same numpy init
noise. Logits agree within 1e-3 * max(1, max|ref|).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.ops.panoptic import (  # noqa: E402
    panoptic_post_process as jpost)
from ldmseg_torch.diffusion import ddim  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.ops.panoptic import panoptic_post_process  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

CPU = torch.device("cpu")
NOISE_KW = DEFAULT_CONFIG["noise_scheduler_kwargs"]


@pytest.mark.parametrize("beta_schedule", [
    "scaled_linear", "linear", "squaredcos_cap_v2", "sigmoid"])
def test_ddim_tables_match_jax(beta_schedule):
    kw = dict(NOISE_KW, beta_schedule=beta_schedule)
    ours = ddim.make_ddim_schedule(**kw, device=CPU)
    ref = jddim.make_ddim_schedule(**kw)
    np.testing.assert_array_equal(ours.betas.numpy(), np.asarray(ref.betas))
    np.testing.assert_array_equal(ours.alphas_cumprod.numpy(),
                                  np.asarray(ref.alphas_cumprod))
    assert float(ours.final_alpha_cumprod) == float(ref.final_alpha_cumprod)
    assert float(ours.final_alpha_cumprod) == float(ref.alphas_cumprod[0])


@pytest.mark.parametrize("steps", [50, 2, 7])
def test_inference_timesteps_match_jax(steps):
    ours = ddim.inference_timesteps(1000, steps)
    np.testing.assert_array_equal(ours, jddim.inference_timesteps(1000,
                                                                  steps))
    if steps == 50:
        assert ours[0] == 999 and ours[-1] == 19 and len(ours) == 50


@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("t", [999, 19])
def test_ddim_step_matches_jax(prediction_type, t):
    kw = dict(NOISE_KW, prediction_type=prediction_type)
    rng = np.random.RandomState(t)
    out = rng.randn(2, 4, 8, 4).astype(np.float32)
    x = rng.randn(2, 4, 8, 4).astype(np.float32)
    ref = jddim.ddim_step(jddim.make_ddim_schedule(**kw), jnp.asarray(out),
                          jnp.asarray(t), jnp.asarray(x), 50)
    ours = ddim.ddim_step(ddim.make_ddim_schedule(**kw, device=CPU),
                          torch.from_numpy(out), t, torch.from_numpy(x), 50)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_add_remove_noise_match_jax():
    rng = np.random.RandomState(3)
    x0 = rng.randn(3, 4, 5, 4).astype(np.float32)
    noise = rng.randn(3, 4, 5, 4).astype(np.float32)
    t = np.array([0, 500, 999])
    js = jddim.make_ddim_schedule(**NOISE_KW)
    ts = ddim.make_ddim_schedule(**NOISE_KW, device=CPU)
    noisy = ddim.add_noise(ts, torch.from_numpy(x0), torch.from_numpy(noise),
                           torch.from_numpy(t))
    jnoisy = jddim.add_noise(js, jnp.asarray(x0), jnp.asarray(noise),
                             jnp.asarray(t))
    np.testing.assert_allclose(noisy.numpy(), np.asarray(jnoisy), rtol=0,
                               atol=1e-6)
    back = ddim.remove_noise(ts, noisy, torch.from_numpy(noise),
                             torch.from_numpy(t))
    jback = jddim.remove_noise(js, jnoisy, jnp.asarray(noise),
                               jnp.asarray(t))
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the whole slice at the dryrun's tiny widths
# ---------------------------------------------------------------------------
CFG = merge_dicts(DEFAULT_CONFIG, {
    "vae_model_kwargs": {
        "in_channels": 10, "int_channels": 16, "out_channels": 24,
        "block_out_channels": [8, 8, 16, 16], "num_upscalers": 2,
        "upscale_channels": 16, "norm_num_groups": 8},
    "image_vae_kwargs": {"block_out_channels": [8, 8, 16, 16], "groups": 8},
    "train_kwargs": {"self_condition": True, "weight_dtype": "float32"},
    "ignore_label": 0,
})
UNET_KW = dict(in_channels=12, out_channels=4, block_out_channels=(8, 16),
               attn_down=(True, False), layers_per_block=1,
               attention_head_dim=2, norm_num_groups=4,
               use_fused_attention=True)
POST_KW = dict(mask_th=0.5, count_th=16, overlap_th=0.5, ignore_label=0)


def _sharpen(x, ref):
    """Random weights give flat logits. Scaled, and shifted so that about
    one class per pixel has a positive logit (the sigmoid-overlap test),
    segments pass the thresholds; argmax and softmax are unchanged by the
    shift. ``ref`` fixes the same shift for both sides."""
    return x * 8.0 - float(np.quantile(ref * 8.0, 0.96))
STEPS = 2


def _random_params(init, seed):
    """The Flax parameters ``init()`` would make, drawn with numpy (tracing
    the shapes is far cheaper on the CPU than running ``init``)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.randn(*leaf.shape).astype(np.float32) / fan_in**0.5
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init))


def _jax_unnormalize_to01(x):
    mean = jnp.asarray([0.485, 0.456, 0.406], x.dtype)
    std = jnp.asarray([0.229, 0.224, 0.225], x.dtype)
    return jnp.clip(x * std + mean, 0.0, 1.0)


@pytest.fixture(scope="module")
def sampled():
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)

    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **UNET_KW))
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

    @jax.jit
    def jax_sample(image, init):
        rgb = 2.0 * _jax_unnormalize_to01(image) - 1.0
        lat = ivae.apply(ip, rgb, method=JImageVAE.encode).mode() * 0.18215

        def model_fn(latents, condition, t):
            x = jnp.concatenate([latents, lat, condition], axis=-1)
            return unet.apply(up, x, t)

        x0 = jddim_sample(sched, model_fn, init, num_inference_steps=STEPS,
                          self_condition=True)
        return svae.apply(sp, x0 * (1.0 / 0.2), True, method=JSegVAE.decode)

    ref = np.array(jax_sample(jnp.asarray(image), jnp.asarray(init)))

    trainer = TrainerDiffusion(CFG, unet_config=UNetConfig(**UNET_KW),
                               device=CPU)
    trainer.load_jax_params(up, ip, sp)
    logits, x0 = trainer.sample_panoptic({"image": image}, init_noise=init,
                                         num_inference_steps=STEPS)
    return ref, logits, x0


def test_sample_panoptic_matches_jax(sampled):
    ref, logits, x0 = sampled
    assert logits.shape == ref.shape == (2, 32, 64, 24)
    assert x0.shape == (2, 4, 8, 4) and logits.dtype == torch.float32
    bound = 1e-3 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(logits.numpy() - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


def test_panoptic_post_process_matches_jax_on_same_logits(sampled):
    ref = _sharpen(sampled[0], sampled[0])
    valid = np.ones(ref.shape[:3], bool)
    valid[:, :, -3:] = False
    kept = 0
    for mask in (None, valid):
        jc, jk = jpost(jnp.asarray(ref), **POST_KW,
                       valid_mask=None if mask is None else jnp.asarray(mask))
        tc, tk = panoptic_post_process(
            torch.from_numpy(ref), **POST_KW,
            valid_mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert tc.dtype == torch.int32 and tk.dtype == torch.bool
        kept += int(tk.sum())
    assert kept > 0, "no segment survives: the case tests nothing"


def test_cleaned_maps_from_own_logits_agree(sampled):
    # a pixel at a threshold may flip between the two sides' logits
    ref, logits, _ = sampled
    jc, jk = jpost(jnp.asarray(_sharpen(ref, ref)), **POST_KW)
    tc, _ = panoptic_post_process(_sharpen(logits, ref), **POST_KW)
    assert np.asarray(jk).any()
    assert np.mean(tc.numpy() == np.asarray(jc)) >= 0.999
