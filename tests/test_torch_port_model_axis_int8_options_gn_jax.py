"""The one-rank port with ``int8_fuse_gn`` (K6) against JAX's int8
trainer, on the weights of ``test_torch_port_model_axis_int8_options_jax.
py`` and JAX's calibrated scales: one int8 UNet forward and a 2-step
``sample_panoptic`` (the port on JAX's draws), JAX's K6 on the kernel's
arithmetic (``test_torch_port_groupnorm._jax_k6``: on the CPU its
wrapper's fallback rounds y to bf16 first). The frames are 48x48, a 6x6
latent (T = 36 and 9), where every K3 and K4 site takes its float
fallback on both sides, as in ``test_torch_port_padded_unet.py``: the
same arithmetic, so the check sees K6 and the s8 convs on its codes. JAX
compiles the forward and its trainer's sampler without excess precision
(K6's s8 conv rounds its output to bf16, a rounding XLA may skip inside a
fusion). Both results are held within 0.55 of the quantization's effect
(JAX's int8 result against the port's float one) from JAX's, the
yardstick of ``test_torch_port_model_axis_serving.py`` (read: 8e-6 and
4e-6). ``pytest -s`` prints each distance as a share of the effect.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
import jax.numpy as jnp  # noqa: E402

from ldmseg_tpu.models import unet as junet  # noqa: E402
from ldmseg_tpu.ops.pallas import groupnorm_silu as jgn  # noqa: E402
from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer  # noqa
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_groupnorm import _jax_k6  # noqa: E402
from test_torch_port_model_axis_int8_options_jax import (  # noqa: E402,F401
    B, INT8, STEPS, _held, _port, weights)
from test_torch_port_sampling import CFG  # noqa: E402

# the forward's JAX compilation: XLA may skip a rounding to bf16 inside a
# fusion (excess precision; K6's s8 conv rounds its output to bf16), which
# PyTorch does where the code says (test_torch_port_groupnorm.py)
EXACT_XLA = {"xla_allow_excess_precision": False}


def test_int8_fuse_gn_matches_jax_trainer(weights, tmp_path):
    rng = np.random.RandomState(48)
    w = dict(weights, image=rng.randn(B, 48, 48, 3).astype(np.float32),
             x=rng.randn(B, 6, 6, 12).astype(np.float32))
    cfg = merge_dicts(JAX_CONFIG, {k: CFG[k] for k in (
        "vae_model_kwargs", "image_vae_kwargs", "train_kwargs",
        "ignore_label")})
    jt = JTrainer(merge_dicts(cfg, INT8), unet_config=junet.UNetConfig(
        **w["jcfg"], int8_fuse_gn=True), results_folder=str(tmp_path))
    jt.init_state({"image": w["image"]}, unet_params=w["up"],
                  vae_img_params=w["ip"], vae_seg_params=w["sp"])
    calib_key, sample_key = jax.random.key(1), jax.random.key(2)
    scales = jt.calibrate_int8({"image": w["image"]}, key=calib_key)
    args = (jt._prequant(jt.state.eval_params()), jnp.asarray(w["x"]),
            jnp.asarray(w["t"]))
    def exact_decode(params, frozen, rgb, key, *rest, **kw):
        # the trainer's jitted sampler, compiled as the forward is
        fn = jax.jit(lambda p, f, r, k: jt._sample_decode_impl(
            p, f, r, k, *rest, **kw))
        return fn.lower(params, frozen, rgb, key).compile(
            compiler_options=EXACT_XLA)(params, frozen, rgb, key)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgn, "group_norm_silu_quant", _jax_k6)
        mp.setattr(jt, "_sample_decode", exact_decode)
        y_8 = np.asarray(jax.jit(jt.unet_infer.apply).lower(*args).compile(
            compiler_options=EXACT_XLA)(*args))
        x0_8 = np.asarray(jt.sample_panoptic(
            {"image": w["image"]}, sample_key,
            num_inference_steps=STEPS)[1])
    # the draws JAX's calibrate_int8 and sample_panoptic make from their
    # keys, handed to the port
    w = dict(w, calib_noise=np.asarray(jax.random.normal(
        calib_key, (B, 6, 6, 4))), init=np.asarray(jax.random.normal(
            sample_key, (B, 6, 6, 4))))
    y, x0, fallbacks = _port(w, INT8, {"int8_fuse_gn": True}, scales)
    y_f, x0_f, _ = _port(w, {"train_kwargs": {"batch_size": B}},
                         {"int8_fuse_gn": True})
    # every resnet norm takes K6's plain version; K3 and K4 (4 sites)
    # their fallbacks, a forward and 2 steps
    assert fallbacks == [4 * (STEPS + 1), 4 * (STEPS + 1), 0, 0, 0]
    _held("int8_fuse_gn forward", y, y_8, y_f)
    _held("int8_fuse_gn x0", x0, x0_8, x0_f)
