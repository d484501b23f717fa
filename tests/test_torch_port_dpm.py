"""DPM-Solver++(2M) (``ldmseg_torch/diffusion/dpm.py``) against the JAX
package's ``dpmpp_2m_sample`` on the CPU.

- The coefficient table against the one JAX's scan reads (its ``xs``,
  captured at the ``lax.scan`` call): the timesteps equal, c_x within 2
  fp32 ulps, c_d and w within 1e-5 relative (both sides compute them in
  fp32 in the same order, but 1 - e^{-h} and the log of e^{-h} magnify an
  ulp of e^{-h} near 1), α and σ within an ulp of the square roots of
  JAX's ᾱ_t; the first and last steps first order.
- The sampler (the eager loop, which the CPU runs) against JAX's on the
  same numpy noise with a seeded linear ``model_fn`` for each prediction
  type, with and without self-conditioning and ``tmin``, and on a tiny
  UNet on the same weights: fp32 within 1e-5 of max|ref|.
- ``TrainerDiffusion.sample_panoptic`` with ``sampling_kwargs.sampler:
  dpmpp_2m`` and the JAX bench's image VAE (int8 with ``int8_act_scale``
  0.05 and fused attention) against a composition of the functions the JAX
  trainer's ``sample_panoptic`` runs (its tests are slow-marked for their
  compile cost), with the int8 encoder and DPM at 3 steps: the RGB latents
  within the int8 tolerance of ``tests/test_torch_port_vae_int8.py``, the
  logits within 1e-3 of max|ref| when both sides start from the JAX
  latents, and the port's own run within 2e-2 of max|ref|.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion import dpm as jdpm  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.diffusion import ddim, dpm  # noqa: E402
from ldmseg_torch.models.convert import unet_state_dict_from_jax  # noqa
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_sampler_graph import (  # noqa: E402
    NOISE_KW, UNET_KW, _models, _unet_params)
from test_torch_port_sampling import (  # noqa: E402
    CFG, _jax_unnormalize_to01, _random_params)
from test_torch_port_sampling import UNET_KW as TINY_UNET  # noqa: E402

CPU = torch.device("cpu")
IMAGE_VAE_KW = {"use_int8": True, "int8_act_scale": 0.05,
                "use_fused_attention": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_table(monkeypatch, sched, steps, tmin):
    """The ``xs`` JAX's scan reads: (ts, ᾱ_t, c_x, c_d, w)."""
    seen = {}
    scan = jax.lax.scan

    def spy(body, init, xs, *a, **k):
        seen["xs"] = [np.asarray(x) for x in xs]
        return scan(body, init, xs, *a, **k)
    monkeypatch.setattr(jax.lax, "scan", spy)
    jdpm.dpmpp_2m_sample(sched, lambda x, c, t: x, jnp.zeros((1, 2, 2, 4)),
                         num_inference_steps=steps, tmin=tmin)
    monkeypatch.undo()
    return seen["xs"]


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("steps,tmin", [(20, 0), (50, 0), (7, 300)])
def test_coefficient_table_matches_jax(monkeypatch, steps, tmin):
    ts, ac, c_x, c_d, w = _jax_table(
        monkeypatch, jddim.make_ddim_schedule(**NOISE_KW), steps, tmin)
    table = dpm.dpm_table(ddim.make_ddim_schedule(**NOISE_KW, device=CPU),
                          steps, tmin)
    coef = table.coef.numpy()
    np.testing.assert_array_equal(table.timesteps.numpy(), ts)
    np.testing.assert_array_equal(table.host_timesteps, ts)
    assert coef.dtype == np.float32 and coef.shape == (len(ts), 5)
    # square roots of fp32 values: an ulp apart at most between libraries
    assert _ulps(coef[:, dpm.ALPHA], np.sqrt(ac)).max() <= 1
    assert _ulps(coef[:, dpm.SIGMA], np.sqrt(np.float32(1) - ac)).max() <= 1
    assert _ulps(coef[:, dpm.C_X], c_x).max() <= 2
    # 1 - e^{-h} and log(e^{-h}) near e^{-h} = 1 magnify an ulp of e^{-h}
    # by 1/h: relative, not ulp, agreement there
    for col, ref in ((dpm.C_D, c_d), (dpm.W, w)):
        np.testing.assert_allclose(coef[:, col], ref, rtol=1e-5, atol=0)
    assert coef[0, dpm.W] == coef[-1, dpm.W] == 0.0
    assert np.all(coef[1:-1, dpm.W] > 0)


@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "sample", "v_prediction"])
@pytest.mark.parametrize("self_condition,tmin", [(False, 0), (True, 0),
                                                 (True, 450)])
def test_dpm_sampler_matches_jax(prediction_type, self_condition, tmin):
    kw = dict(NOISE_KW, prediction_type=prediction_type)
    init = np.random.RandomState(tmin + 3).randn(2, 4, 6, 4).astype(
        np.float32)
    jmodel, tmodel = _models(5)
    ref = np.asarray(jdpm.dpmpp_2m_sample(
        jddim.make_ddim_schedule(**kw), jmodel, jnp.asarray(init),
        num_inference_steps=12, self_condition=self_condition, tmin=tmin))
    out = dpm.dpmpp_2m_sample(
        ddim.make_ddim_schedule(**kw, device=CPU), tmodel,
        torch.from_numpy(init).permute(0, 3, 1, 2), num_inference_steps=12,
        self_condition=self_condition, tmin=tmin)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("self_condition", [False, True])
def test_dpm_sampler_on_a_tiny_unet_matches_jax(self_condition):
    cond = 4 if self_condition else 0
    junet = JUNet(JUNetConfig(in_channels=8 + cond, cond_channels=cond,
                              use_cross_attention=False, **UNET_KW))
    params = _unet_params(junet, 4, 8 + cond)
    unet = UNet2DCondition(UNetConfig(in_channels=8 + cond, **UNET_KW))
    unet.load_state_dict(unet_state_dict_from_jax(params, unet.config))
    rng = np.random.RandomState(6)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    rgb = rng.randn(2, 4, 8, 4).astype(np.float32)
    sched = jddim.make_ddim_schedule(**NOISE_KW)

    def jmodel(latents, condition, t):
        parts = [latents, jnp.asarray(rgb)] + (
            [condition] if condition is not None else [])
        return junet.apply(params, jnp.concatenate(parts, -1),
                           jnp.broadcast_to(t, (2,)))
    ref = np.asarray(jax.jit(lambda z: jdpm.dpmpp_2m_sample(
        sched, jmodel, z, num_inference_steps=4,
        self_condition=self_condition))(jnp.asarray(init)))
    trgb = torch.from_numpy(rgb).permute(0, 3, 1, 2)

    def tmodel(latents, condition, t):
        assert t.dim() == 0 and t.dtype == torch.long
        parts = [latents, trgb] + ([condition] if condition is not None
                                   else [])
        return unet(torch.cat(parts, 1), t)
    with torch.inference_mode():
        x0 = dpm.dpmpp_2m_sample(
            ddim.make_ddim_schedule(**NOISE_KW, device=CPU), tmodel,
            torch.from_numpy(init).permute(0, 3, 1, 2),
            num_inference_steps=4, self_condition=self_condition)
    np.testing.assert_allclose(x0.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_dpm_refuses_a_graph_on_the_cpu():
    with pytest.raises(ValueError, match="needs CUDA latents"):
        dpm.dpmpp_2m_sample(ddim.make_ddim_schedule(**NOISE_KW, device=CPU),
                            lambda x, c, t: x, torch.zeros(1, 4, 2, 2),
                            graph=True)


# ---------------------------------------------------------------------------
# the serving configuration: sample_panoptic with DPM and the int8 image VAE
# ---------------------------------------------------------------------------
STEPS = 3


def test_sample_panoptic_with_dpm_and_the_int8_image_vae_against_jax():
    rng = np.random.RandomState(0)
    image = rng.randn(2, 32, 64, 3).astype(np.float32)
    init = rng.randn(2, 4, 8, 4).astype(np.float32)
    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **TINY_UNET))
    ivk = dict(CFG["image_vae_kwargs"], **IMAGE_VAE_KW)
    ivk["block_out_channels"] = tuple(ivk["block_out_channels"])
    ivae = JImageVAE(decoder_enabled=False, **ivk)
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
    def jax_latents(image):
        rgb = 2.0 * _jax_unnormalize_to01(image) - 1.0
        return ivae.apply(ip, rgb, method=JImageVAE.encode).mode() * 0.18215

    @jax.jit
    def jax_sample(lat, init):
        def model_fn(latents, condition, t):
            x = jnp.concatenate([latents, lat, condition], axis=-1)
            return unet.apply(up, x, t)
        x0 = jdpm.dpmpp_2m_sample(sched, model_fn, init,
                                  num_inference_steps=STEPS,
                                  self_condition=True)
        return svae.apply(sp, x0 * (1.0 / 0.2), True, method=JSegVAE.decode)

    lat = jax_latents(jnp.asarray(image))
    ref = np.asarray(jax_sample(lat, jnp.asarray(init)))

    cfg = merge_dicts(CFG, {"image_vae_kwargs": IMAGE_VAE_KW,
                            "sampling_kwargs": {"sampler": "dpmpp_2m"}})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(**TINY_UNET),
                               device=CPU)
    assert trainer.sampler == "dpmpp_2m"
    trainer.load_jax_params(up, ip, sp)
    # the int8 encoder is prepared once, with the weights
    assert trainer.vae_img.encoder.down_blocks[0].resnets[0].conv1.w_q \
        is not None
    ours_lat = trainer._encode_rgb(image)
    lat_np = np.asarray(lat).transpose(0, 3, 1, 2)
    diff = np.abs(ours_lat.numpy() - lat_np)
    assert diff.max() <= 2e-2 * np.abs(lat_np).max(), diff.max()
    # the whole slice from the JAX latents: DPM, the seg decode
    with torch.inference_mode():
        logits, x0 = trainer._sample_decode(
            trainer.inference_unet(), torch.from_numpy(lat_np), None,
            init_noise=init, num_inference_steps=STEPS)
    logits = logits.permute(0, 2, 3, 1).numpy()
    bound = max(1.0, float(np.abs(ref).max()))
    assert np.abs(logits - ref).max() <= 1e-3 * bound
    # and the port's own pipeline, its encode included
    out, x0 = trainer.sample_panoptic({"image": image}, init_noise=init,
                                      num_inference_steps=STEPS)
    assert out.shape == ref.shape == (2, 32, 64, 24)
    assert x0.shape == (2, 4, 8, 4) and bool(torch.isfinite(out).all())
    assert np.abs(out.numpy() - ref).max() <= 2e-2 * bound
