"""``use_packed_attention`` and ``use_absorbed_attention`` on the model
axis: two gloo ranks of the port on a ``(data=1, model=2)`` mesh
(``tests/torch_dp_workers.py:attention_axis``) with ``tensor_parallel``,
``spatial_parallel`` and ZeRO-1, against JAX's ``TrainerDiffusion`` on a
``(1, 2)`` ``make_mesh`` of the conftest's virtual CPU devices and against
one process of the port, the same weights, rows and draws. The UNet has 4
heads of 8 and 16 (d a multiple of 8: K14 and K16 take every site, each
rank 2 heads), so the ranks run K14 (K2 backward) and K16's partial mode
on their heads, through their plain versions here:

  * one stage-2 step with each flag, fp32 (the yardstick of
    ``test_torch_port_model_axis_train.py::
    test_composed_step_matches_jax_stage_c``, which holds the step in
    fp32): the loss to 1e-4 relative, every gathered gradient at JAX's TP
    bounds (rtol 5e-3, atol 5e-4), the gathered masters after the AdamW
    step within 1e-3 x lr (plus what the gradients' difference moves
    AdamW's first step);
  * a 2-step bf16 ``sample_panoptic`` with each flag against JAX's bf16
    composition on the mesh (the TP UNet, the VAEs under
    ``spatial_constraint``) and against the one-rank port: x0 within 2e-2
    of its largest value; the logits (the bf16 seg decoder's) within 1.25
    times the one-rank port's own distance from JAX's (0.023-0.024 of
    max|logits| at these widths, with or without a flag) and within that
    distance of the one-rank port's;
  * neither rank takes a fallback of K14 or K16.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.parallel import apply_tp as japply_tp  # noqa: E402
from ldmseg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ldmseg_tpu.parallel import shard_batch as jshard  # noqa: E402
from ldmseg_tpu.parallel.sp import (batch_constraint,  # noqa: E402
                                    spatial_constraint)
from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer  # noqa
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.parallel import tp  # noqa: E402
from ldmseg_torch.parallel.launch import run_ranks  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

import torch_dp_workers as W  # noqa: E402
from test_torch_port_dp_train import _capture  # noqa: E402
from test_torch_port_sampling import (CFG, _jax_unnormalize_to01,  # noqa
                                      _random_params)

FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
B, LR, LAT, STEPS = 2, 1e-3, (4, 8), 2
# 4 heads of 8 and 16 channels: the model axis of 2 divides every block's
# heads, and K14 and K16 (d a multiple of 8, T = 32 and 8) take every site
UNET_KW = dict(in_channels=12, out_channels=4, block_out_channels=(32, 64),
               attn_down=(True, False), layers_per_block=1,
               attention_head_dim=4, norm_num_groups=8,
               use_fused_attention=True)
FLAGS = {"packed": {"use_packed_attention": True},
         "absorbed": {"use_absorbed_attention": True}}
MODEL_AXIS = {"train_kwargs": {"batch_size": B, "clip_grad": 0.05},
              "lr_scheduler_name": "none",
              "optimizer_kwargs": {"lr": LR, "weight_decay": 0.01},
              "optimizer_zero_redundancy": True, "tensor_parallel": True,
              "spatial_parallel": True}
BF16 = {"train_kwargs": {"weight_dtype": "bfloat16"}}


def _cfg(base, *over, parallel=True):
    cfg = merge_dicts(base, {k: CFG[k] for k in (
        "vae_model_kwargs", "image_vae_kwargs", "train_kwargs",
        "ignore_label")})
    cfg = merge_dicts(cfg, MODEL_AXIS)
    if not parallel:
        cfg = merge_dicts(cfg, {"tensor_parallel": False,
                                "spatial_parallel": False})
    for o in over:
        cfg = merge_dicts(cfg, o)
    return cfg


def _kw(flag):
    return dict(UNET_KW, **FLAGS[flag])


def _jmesh():
    return jmake_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])


def _draws(key):
    """The noise and timesteps ``_train_step_impl`` draws from ``key``."""
    keys = jax.random.split(key, 10)
    return {"noise": np.asarray(jax.random.normal(keys[3], (B,) + LAT
                                                  + (4,))),
            "timesteps": np.asarray(jax.random.randint(keys[4], (B,), 0,
                                                       1000))}


def _jax_step(flag, params, batch, key, tmp):
    """JAX's step on the (1, 2) mesh with ``tensor_parallel``,
    ``spatial_parallel`` and ZeRO-1: the loss, the mean gradients before
    the clip, the masters after."""
    kw = _kw(flag)
    jt = JTrainer(_cfg(JAX_CONFIG),
                  unet_config=JUNetConfig(use_cross_attention=False,
                                          cond_channels=4, **kw),
                  mesh=_jmesh(), results_folder=str(tmp))
    assert jt.spatial_parallel
    jt.tx = _capture(jt.tx)
    up, ip, sp = params
    jt.init_state(batch, unet_params=up, vae_seg_params=sp,
                  vae_img_params=ip)
    db = jshard(jt.mesh, jt._device_batch(batch))
    step = jt._train_step.lower(jt.state, jt.frozen_params, db, key).compile(
        compiler_options=FAST_XLA)
    state, metrics, _ = step(jt.state, jt.frozen_params, db, key)
    cfg = UNetConfig(**kw)
    return {"loss": float(metrics["loss"]),
            "grads": convert.unet_state_dict_from_jax(jax.tree_util.tree_map(
                np.asarray, state.opt_state[1]), cfg),
            "params": convert.unet_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, state.params), cfg)}


def _jax_sample(flag, params, image, init):
    """JAX's bf16 sampling composition on the mesh: the TP UNet with the
    flag, the VAEs under ``spatial_constraint``, 2 DDIM steps with
    self-conditioning."""
    mesh = _jmesh()
    bf = jnp.bfloat16
    up, ip, sp = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, bf), p)
                  for p in params)
    up = japply_tp(mesh, up)
    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **_kw(flag)))
    ivae = JImageVAE(decoder_enabled=False, **CFG["image_vae_kwargs"])
    vk = {k: v for k, v in CFG["vae_model_kwargs"].items()
          if k != "pretrained_path"}
    vk["block_out_channels"] = tuple(vk["block_out_channels"])
    svae = JSegVAE(**vk)
    sched = jddim.make_ddim_schedule(**CFG["noise_scheduler_kwargs"])

    def sample(image, init):
        rgb = spatial_constraint(
            2.0 * _jax_unnormalize_to01(image).astype(bf) - 1.0, mesh)
        lat = ivae.apply(ip, rgb, method=JImageVAE.encode).mode()
        lat = batch_constraint(lat.astype(jnp.float32) * 0.18215, mesh)

        def model_fn(latents, condition, t):
            x = jnp.concatenate([latents, lat, condition], -1).astype(bf)
            return unet.apply(up, x, t).astype(jnp.float32)
        x0 = jddim_sample(sched, model_fn, init, num_inference_steps=STEPS,
                          self_condition=True)
        logits = svae.apply(sp, (x0 * (1.0 / 0.2)).astype(bf), True,
                            method=JSegVAE.decode)
        return spatial_constraint(logits, mesh).astype(jnp.float32), x0
    args = (jnp.asarray(image), jnp.asarray(init))
    out = jax.jit(sample).lower(*args).compile(
        compiler_options=FAST_XLA)(*args)
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **UNET_KW))
    up = _random_params(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1, 4, 8, 12)),
        jnp.zeros((1,), jnp.int32)), 0)
    ivae = JImageVAE(decoder_enabled=False, **CFG["image_vae_kwargs"])
    ip = _random_params(lambda: ivae.init(
        jax.random.key(1), jnp.zeros((1, 32, 64, 3)),
        method=JImageVAE.encode), 1)
    vk = {k: v for k, v in CFG["vae_model_kwargs"].items()
          if k != "pretrained_path"}
    vk["block_out_channels"] = tuple(vk["block_out_channels"])
    svae = JSegVAE(**vk)
    sp = _random_params(lambda: svae.init(
        {"params": jax.random.key(2), "sample": jax.random.key(2)},
        jnp.zeros((1, 32, 64, 10)), sample_posterior=False), 2)
    params = jax.tree_util.tree_map(np.asarray, (up, ip, sp))
    ds = SyntheticDVPS(length=B, size=(32, 64), num_bits=5)
    batch = {k: np.stack([ds[j][k] for j in range(B)])
             for k in ("image", "image_semseg", "semseg")}
    key = jax.random.key(10)
    init = np.random.RandomState(3).randn(B, 4, 8, 4).astype(np.float32)
    runs_spec = {}
    for flag in FLAGS:
        runs_spec[f"{flag} step"] = {"kind": "step", "cfg": _cfg(
            DEFAULT_CONFIG), "unet_kw": _kw(flag)}
        runs_spec[f"{flag} sample"] = {"kind": "sample", "cfg": _cfg(
            DEFAULT_CONFIG, BF16), "unet_kw": _kw(flag)}
    spec = {"runs": runs_spec, "params": params, "batch": batch,
            "draws": _draws(key), "image": batch["image"], "init": init,
            "steps": STEPS}
    tmp = tmp_path_factory.mktemp("attention_axis")
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, W.attention_axis, 2, args=(spec,),
                              device="cpu", timeout_s=300)
        ref = {}
        for flag in FLAGS:
            ref[f"{flag} step"] = _jax_step(flag, params, batch, key,
                                            tmp / flag)
            ref[f"{flag} sample"] = _jax_sample(flag, params,
                                                batch["image"], init)
        ranks = spawned.result()
    one = {}
    for flag in FLAGS:
        tr = TrainerDiffusion(_cfg(DEFAULT_CONFIG, BF16, parallel=False),
                              unet_config=UNetConfig(**_kw(flag)),
                              device="cpu")
        tr.load_jax_params(*params)
        one[flag] = tr.sample_panoptic({"image": batch["image"]},
                                       init_noise=init,
                                       num_inference_steps=STEPS)
    return {"ranks": ranks, "jax": ref, "one": one}


def _whole(ranks, key, field):
    lay = ranks[0][key]["layout"]
    return {n: tp.whole_tensor([r[key][field][n] for r in ranks], *lay[n])
            if n in lay else ranks[0][key][field][n]
            for n in ranks[0][key][field]}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_step_with_the_flag_matches_jax_on_its_mesh(runs, flag):
    key = f"{flag} step"
    ranks, ref = runs["ranks"], runs["jax"][key]
    for r in ranks:
        np.testing.assert_allclose(r[key]["loss"], ref["loss"], rtol=1e-4)
        assert r[key]["fallbacks"][:2] == [0, 0]
    # the attention's projections are cut (K16 reads them as plain
    # Linear layers holding a rank's heads)
    lay = ranks[0][key]["layout"]
    attn = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    assert lay[f"{attn}.to_q.weight"] == (0, 1)
    assert lay[f"{attn}.to_out.0.weight"] == (1, 1)
    grads = _whole(ranks, key, "grads")
    assert grads.keys() == ref["grads"].keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref["grads"][n].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=n)
    norm = float(torch.stack([g.norm() for g in grads.values()]).norm())
    assert norm > 0.05  # the clip acted
    for n, p in _whole(ranks, key, "masters").items():
        g, j = grads[n].numpy(), ref["grads"][n].numpy()
        cond = 2.0 * np.abs(g - j) / (np.maximum(np.abs(g), np.abs(j))
                                      + 1e-8)
        err = np.abs(p.numpy() - ref["params"][n].numpy())
        assert (err <= LR * (1e-3 + cond)).all(), (n, float(err.max()))


@pytest.mark.parametrize("flag", list(FLAGS))
def test_bf16_sample_with_the_flag_matches_jax_and_one_rank(runs, flag):
    key = f"{flag} sample"
    logits_ref, x0_ref = runs["jax"][key]
    logits_one, x0_one = (t.numpy() for t in runs["one"][flag])
    ranks = runs["ranks"]
    assert torch.equal(ranks[0][key]["x0"], ranks[1][key]["x0"])
    assert torch.equal(ranks[0][key]["logits"], ranks[1][key]["logits"])
    x0, logits = ranks[0][key]["x0"].numpy(), ranks[0][key]["logits"].numpy()
    assert x0.shape == x0_ref.shape and logits.shape == logits_ref.shape
    # x0, the UNet's output: within 2e-2 of max|x0| of JAX's and of the
    # one-rank port's (test_torch_port_model_axis_train's bound)
    for want in (x0_ref, x0_one):
        assert np.abs(x0 - want).max() <= 2e-2 * np.abs(want).max()
    # the logits, the bf16 seg decoder's on x0: at these widths the
    # one-rank port itself sits at 0.023-0.024 of max|logits| from JAX's (a
    # few bf16 ulps of the decoder's output, without the model axis); the
    # mesh is held within 1.25 times that distance from JAX's, and within
    # it from the one-rank port's
    def dist(a, b):
        return np.abs(a - b).max() / np.abs(b).max()
    one = dist(logits_one, logits_ref)
    assert one <= 3e-2, one
    assert dist(logits, logits_ref) <= 1.25 * one
    assert dist(logits, logits_one) <= one
    assert ranks[0][key]["fallbacks"][:2] == [0, 0]
