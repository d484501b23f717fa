"""The port's int8 clip sampling against the JAX trainer's on the CPU.

``sample_panoptic_clip`` with ``int8_inference`` (the first pass and the
DDIM refine tail on the int8 UNet, the frames of the 5-D batch
calibrating the scales), on the weights, clip and noise of
``test_torch_port_clip``, with the scales the port calibrates handed to
JAX's quantization. JAX's CPU path takes its kernels' fallbacks where the
port runs their plain versions, so the port is held to yardsticks from the
same run, as ``test_torch_port_int8``'s ``sample_panoptic`` is: on the
int8 UNet, and with the serving configuration's int8 image VAE as well
(``tools/bench.py:bench_config``'s, whose encoder differs from JAX's by up
to 2e-2 of the latents' range, ``test_torch_port_dpm``), the port's x0
is nearer JAX's int8 x0 than JAX's float x0 is, and nearer it than to
JAX's float x0. (The port's distance from JAX's int8 x0 is about 0.55 of
the quantization's effect on the int8 UNet, 0.63 with the int8 VAE; the
single-frame test's yardstick of half that effect does not hold here.
``test_torch_port_clip_int8_trait`` shows why: the distance is the int8
UNet forward's, the port's kernels' arithmetic against JAX's CPU
fallbacks, already in the first pass; and JAX's own int8-VAE clip x0
moves by most of the effect when its frames change by a part in a
million.)
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import torch  # noqa: E402

from test_torch_port_clip import (  # noqa: E402
    INT8_CFG, INT8_UNET_CFG, STEPS, T, UNET_KW, _jax_clip, _jax_noise,
    _one_torch_thread, _port, models)
from test_torch_port_int8 import jax_path  # noqa: E402

__all__ = ["models", "_one_torch_thread"]


def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


@pytest.fixture(scope="module")
def float_x0(models):
    trainers, params, batch = models
    return _jax_clip(trainers["float"], params[0], batch,
                     jax.random.key(3))[1]


@pytest.mark.parametrize("name,cfg", [("int8", INT8_UNET_CFG),
                                      ("int8 vae", INT8_CFG)])
def test_int8_sample_panoptic_clip_against_jax(models, float_x0, name, cfg):
    from ldmseg_tpu.ops import quant as jquant
    trainers, params, batch = models
    tr = _port(cfg, params)
    frames = batch["image"].reshape((-1,) + batch["image"].shape[2:])
    calib = np.random.RandomState(5).randn(T, 8, 16, 4).astype(np.float32)
    scales = tr.calibrate_int8({"image": frames}, noise=calib)
    heads = UNET_KW["attention_head_dim"]
    up8 = jquant.pack_inference_tiles(
        jquant.apply_act_scales(jquant.prequantize_conv_tree(
            params[0], quantize_ff=True, absorbed_attention=True,
            attention_heads=heads),
            {jax_path(k): v for k, v in scales.items()}),
        attention_heads=heads, int8_act_scale=0.05, int8_attn_act_scale=0.1)
    _, x0_8 = _jax_clip(trainers[name](), up8, batch, jax.random.key(3))
    init, refine = _jax_noise(jax.random.key(3), True)
    logits, x0 = tr.sample_panoptic_clip(
        batch, init_noise=init, refine_noise=refine,
        num_inference_steps=STEPS)
    assert bool(torch.isfinite(logits).all()) and x0.shape == x0_8.shape
    quant_effect = _rel(x0_8, float_x0)
    assert quant_effect > 1e-3, "the int8 path changed nothing"
    err = _rel(x0.numpy(), x0_8)
    assert err <= quant_effect, (err, quant_effect)
    assert err < _rel(x0.numpy(), float_x0)


def test_int8_clip_calibrates_on_the_clip_frames(models):
    trainers, params, batch = models
    auto = _port(INT8_UNET_CFG, params)  # adopted weights: calibrates once
    assert auto._int8_act_scales is None
    init, refine = _jax_noise(jax.random.key(3), True)
    auto.sample_panoptic_clip(batch, init_noise=init, refine_noise=refine,
                              num_inference_steps=1)
    assert auto._int8_act_scales is not None
