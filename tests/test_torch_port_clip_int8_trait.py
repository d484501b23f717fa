"""Where the int8 clip call's distance from JAX's comes from.

``test_torch_port_clip_int8`` holds the port's int8 clip x0 within the
quantization's whole effect of JAX's int8 x0, not within half of it as the
single-frame ``sample_panoptic`` test does: the port sits at 0.55 of it on
the int8 UNet and 0.63 with the int8 image VAE. Taken apart one stage at
a time on the same weights, clip and noise, the first pass alone sits at
0.61 and 0.57, the pose warp of one x0 differs by at most 1.5e-5, the
refine tail from one blended x0 adds no more, and the calibration is
shared (JAX takes the port's scales). The distance is in the int8 UNet's
forward itself, at any batch shape:

- on the CPU JAX's int8 wrappers always take their fallbacks (float
  attention, the exact gelu, one amax a tensor), where the port runs its
  kernels' plain versions (the kernels' arithmetic, held to the Pallas
  kernels in interpret mode). Sent to the same fallbacks, the port's int8
  UNet equals JAX's to float rounding; with its kernels' arithmetic it
  sits at about 0.5-0.85 of the quantization's effect from JAX's per
  forward, varying with the draw;
- with the int8 image VAE, JAX's own int8 clip x0 moves by most of the
  quantization's effect when the frames change by one part in a million:
  no yardstick tighter than that response can hold against it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from test_torch_port_clip import (  # noqa: E402
    FAST_XLA, INT8_CFG, INT8_UNET_CFG, T, UNET_KW, _jax_clip, _port, models,
    _one_torch_thread)
from test_torch_port_int8 import jax_path  # noqa: E402

__all__ = ["models", "_one_torch_thread"]


def _rel(a, b):
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _calibrated(cfg, params, batch):
    """The port's trainer calibrated on the clip's frames, and JAX's int8
    tree quantized with those scales (test_torch_port_clip_int8's)."""
    from ldmseg_tpu.ops import quant as jquant
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
    return tr, up8


def _jax_forward(module, params, x, t):
    fn = jax.jit(module.apply)
    args = (params, jnp.asarray(x), jnp.asarray(t))
    return np.asarray(fn.lower(*args).compile(
        compiler_options=FAST_XLA)(*args))


def test_int8_unet_equals_jax_on_the_fallbacks_jax_takes_on_the_cpu(
        models, monkeypatch):
    import ldmseg_torch.ops.attention_s8 as S8
    import ldmseg_torch.ops.geglu as G
    trainers, params, batch = models
    tr, up8 = _calibrated(INT8_UNET_CFG, params, batch)
    j8 = trainers["int8"]()
    x = np.random.RandomState(0).randn(T, 8, 16, 12).astype(np.float32)
    t = np.full((T,), 500, np.int32)
    ref8 = _jax_forward(j8.unet_infer, up8, x, t)
    ref = _jax_forward(j8.unet, params[0], x, t)

    def port():
        with torch.no_grad():
            return tr.int8_unet()(
                torch.from_numpy(x.copy()).permute(0, 3, 1, 2),
                torch.from_numpy(t.astype(np.int64))).permute(
                    0, 2, 3, 1).numpy()
    effect = _rel(ref8, ref)
    kernels = _rel(port(), ref8)
    k3, k4 = S8.ln_attention_s8.fallbacks, G.geglu_ln_s8.fallbacks
    monkeypatch.setattr(S8, "absorbed_takes_kernel", lambda *a: False)
    monkeypatch.setattr(G, "takes_kernel", lambda *a: False)
    fallbacks = _rel(port(), ref8)
    # every K3 and K4 site of the forward took its fallback
    from ldmseg_torch.models.unet import Transformer2D
    sites = sum(isinstance(m, Transformer2D)
                for m in tr.int8_unet().modules())
    assert S8.ln_attention_s8.fallbacks - k3 == sites
    assert G.geglu_ln_s8.fallbacks - k4 == sites
    assert effect > 1e-2
    assert fallbacks <= 1e-5, fallbacks
    assert 0.3 * effect < kernels <= effect, (kernels, effect)


def test_jax_int8_vae_clip_moves_with_a_part_in_a_million_of_its_frames(
        models):
    trainers, params, batch = models
    _, up8 = _calibrated(INT8_CFG, params, batch)
    key = jax.random.key(3)
    j8 = trainers["int8 vae"]()
    x0 = _jax_clip(j8, up8, batch, key)[1]
    effect = _rel(x0, _jax_clip(trainers["float"], params[0], batch,
                                key)[1])
    nudged = dict(batch, image=(batch["image"].astype(np.float64)
                                * (1 + 1e-6)).astype(np.float32))
    moved = _rel(_jax_clip(j8, up8, nudged, key)[1], x0)
    assert moved > 0.5 * effect, (moved, effect)
