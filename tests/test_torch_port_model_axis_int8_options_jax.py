"""The one-rank port against the JAX package with the int8 options that
``test_torch_port_model_axis_int8_options*.py`` run on the model axis, on
the tiny trainer's UNet of ``test_torch_port_sampling.py`` with JAX's
random weights, on JAX's calibrated scales (shared scales: a code next to
a .5 flips where two calibrations sit ulps apart):

  * ``use_fused_projs``: the port's trainer against JAX's UNet on
    ``pack_inference_tiles(fuse_projs=True)`` (the JAX trainer packs
    without ``fuse_projs``, so its K8 and K9 would drop the proj biases),
    one UNet forward and a 2-step sample composed with JAX's DDIM sampler;
  * ``int8_fuse_gn``: in ``test_torch_port_model_axis_int8_options_gn_
    jax.py``, on this file's weights.

JAX's int8 blocks run on the CPU as the JAX package's own int8 tests run
them (its wrappers' float branches, where the port runs the kernels'
plain versions), so each result is held to the yardstick of
``test_torch_port_model_axis_serving.py``: within 0.55 of the
quantization's effect (JAX's int8 result against the float one) from
JAX's int8 result. ``pytest -s`` prints each distance as a share of the
effect.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models import unet as junet  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.ops import quant as jquant  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops import geglu as G  # noqa: E402
from ldmseg_torch.ops import groupnorm_silu as GN  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_int8 import INT8_KW, jax_path  # noqa: E402
from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)

B, STEPS = 2, 2
HEADS = UNET_KW["attention_head_dim"]
INT8 = {"sampling_kwargs": {"int8_inference": True},
        "train_kwargs": {"batch_size": B}}


def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.fixture(scope="module")
def weights():
    jcfg = dict(use_cross_attention=False, cond_channels=4, **UNET_KW)
    unet = junet.UNet2DCondition(junet.UNetConfig(**jcfg))
    ivae = JImageVAE(decoder_enabled=False, **CFG["image_vae_kwargs"])
    from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE
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
    rng = np.random.RandomState(27)
    return {"jcfg": jcfg, "unet": unet, "ivae": ivae, "up": up, "ip": ip,
            "sp": sp, "image": rng.randn(B, 32, 64, 3).astype(np.float32),
            "init": rng.randn(B, 4, 8, 4).astype(np.float32),
            "calib_noise": rng.randn(B, 4, 8, 4).astype(np.float32),
            # one UNet forward's input as test_torch_port_model_axis_
            # attention_int8.py makes it (NHWC), at the calibration's t
            "x": np.random.RandomState(5).randn(B, 4, 8, 12).astype(
                np.float32),
            "t": np.full((B,), 500, np.int32)}


def _port(w, over, kw, scales=None):
    """The port's trainer on JAX's weights with ``kw`` on the UNet: the x0
    of a 2-step ``sample_panoptic`` from ``w["init"]`` and one UNet
    forward of ``w["x"]`` at ``w["t"]`` (int8: on JAX's ``scales``, keyed
    by the JAX paths; NHWC), and the fallbacks of K3, K4, K6, K8 and K9 it
    took."""
    counters = (S8.ln_attention_s8, G.geglu_ln_s8,
                GN.group_norm_silu_quant, S8.ln_attention_s8_pin,
                G.geglu_ln_s8_pout)
    before = [f.fallbacks for f in counters]
    tr = TrainerDiffusion(merge_dicts(CFG, over), unet_config=UNetConfig(
        **UNET_KW, **kw), device="cpu")
    tr.load_jax_params(w["up"], w["ip"], w["sp"])
    if scales is not None:
        ours = tr.calibrate_int8({"image": w["image"]},
                                 noise=w["calib_noise"])
        assert {jax_path(k) for k in ours} == set(scales)
        tr._int8_act_scales = {k: np.float32(scales[jax_path(k)])
                               for k in ours}
    unet = tr.int8_unet() if scales is not None else tr.inference_unet()
    with torch.no_grad():
        y = unet(torch.from_numpy(w["x"]).permute(0, 3, 1, 2),
                 torch.from_numpy(w["t"]).long()).permute(0, 2, 3, 1)
    _, x0 = tr.sample_panoptic({"image": w["image"]}, init_noise=w["init"],
                               num_inference_steps=STEPS)
    return (y.numpy(), x0.numpy(),
            [f.fallbacks - n for f, n in zip(counters, before)])


def _held(what, port, ref8, ref_float, share=0.55):
    effect = _rel(ref8, ref_float)
    print(f"{what}: the quantization's effect {effect:.4g}, the port from "
          f"JAX {_rel(port, ref8) / effect:.4g} of it")
    assert effect > 1e-3, "the int8 path changed nothing"
    assert _rel(port, ref8) <= share * effect


def test_fused_projs_matches_jax_on_fuse_projs_tiles(weights):
    w = weights
    unet8 = junet.UNet2DCondition(junet.UNetConfig(**dict(
        w["jcfg"], **INT8_KW, use_fused_projs=True)))
    sched = jddim.make_ddim_schedule(**CFG["noise_scheduler_kwargs"])
    lat = w["ivae"].apply(
        w["ip"], 2.0 * _jax_unnormalize_to01(jnp.asarray(w["image"])) - 1.0,
        method=JImageVAE.encode).mode() * 0.18215
    # JAX's calibration (the trainer's: noise beside the RGB latents, zero
    # self-condition channels, t = 500), then the tiles with fuse_projs
    inp = jnp.concatenate([jnp.asarray(w["calib_noise"]), lat,
                           jnp.zeros((B, 4, 8, 4))], axis=-1)
    scales = jquant.calibrate_act_scale_tree(
        w["unet"].apply, w["up"], (inp, jnp.full((B,), 500, jnp.int32)))
    up8 = jquant.pack_inference_tiles(
        jquant.apply_act_scales(jquant.prequantize_conv_tree(
            w["up"], quantize_ff=True, absorbed_attention=True,
            attention_heads=HEADS), scales),
        attention_heads=HEADS, int8_act_scale=0.05, int8_attn_act_scale=0.1,
        fuse_projs=True)

    def jax_x0(model, params):
        def model_fn(latents, condition, t):
            x = jnp.concatenate([latents, lat, condition], axis=-1)
            return model.apply(params, x, t)
        return np.asarray(jax.jit(lambda z: jddim_sample(
            sched, model_fn, z, num_inference_steps=STEPS,
            self_condition=True))(jnp.asarray(w["init"])))

    def jax_y(model, params):
        return np.asarray(model.apply(params, jnp.asarray(w["x"]),
                                      jnp.asarray(w["t"])))

    y, x0, fallbacks = _port(w, INT8, {"use_fused_projs": True}, scales)
    # d = 4 at the first level: the rule sends those K8 sites (one down,
    # two up) to the fallback, a forward and a step; K9 takes all; no K3
    # or K4 is built
    assert fallbacks == [0, 0, 0, 3 * (STEPS + 1), 0]
    _held("use_fused_projs forward", y, jax_y(unet8, up8),
          jax_y(w["unet"], w["up"]))
    _held("use_fused_projs x0", x0, jax_x0(unet8, up8),
          jax_x0(w["unet"], w["up"]))
