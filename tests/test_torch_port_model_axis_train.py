"""The model axis in the trainer: four gloo ranks of the port on a
``(data=2, model=2)`` mesh against JAX's ``TrainerDiffusion`` on a ``(2, 2)``
``make_mesh`` of the conftest's virtual CPU devices (JAX's stage C:
``tensor_parallel``, ``spatial_parallel`` and ZeRO-1), the same weights,
rows and draws (each data rank takes its rows of the draws JAX makes from
its key), fp32, tiny UNet, global batch 4, ``clip_grad`` acting:

  * the loss to 1e-4 relative, every gradient shard against its slice of
    JAX's gradient at JAX's TP bounds (rtol 5e-3, atol 5e-4), the masters
    after the AdamW step to 1e-3 x lr (plus what the gradients' difference
    moves AdamW's first step, as ``test_torch_port_dp_train.py``);
  * each rank holds about a quarter of the optimizer state (ZeRO-1 over
    the data group of its UNet shards);
  * the checkpoint written on the mesh is the one-rank layout; a
    one-rank trainer resumes it bit-equal to the ranks' gathered masters,
    and a fresh trainer on the mesh to each rank's shards;
  * gradient accumulation (2 micro-batches) and the EMA on the mesh
    against one process of the port on the global batch;
  * a 2-step bf16 ``sample_panoptic`` with tensor and spatial parallelism
    against JAX's bf16 composition on the mesh (the TP UNet, the VAEs
    under ``spatial_constraint``), x0 and logits within 2e-2 of their
    largest value.
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
from test_torch_port_dp_train import _capture, _draws  # noqa: E402
from test_torch_port_sampling import (CFG, UNET_KW,  # noqa: E402
                                      _jax_unnormalize_to01, _random_params)

FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
B, LR = 4, 1e-3
MODEL_AXIS = {"train_kwargs": {"batch_size": B, "clip_grad": 0.05},
              "lr_scheduler_name": "none",
              "optimizer_kwargs": {"lr": LR, "weight_decay": 0.01},
              "optimizer_zero_redundancy": True, "tensor_parallel": True,
              "spatial_parallel": True}


def _cfg(base, **over):
    cfg = merge_dicts(base, {k: CFG[k] for k in (
        "vae_model_kwargs", "image_vae_kwargs", "train_kwargs",
        "ignore_label")})
    return merge_dicts(merge_dicts(cfg, MODEL_AXIS), over)


ACC_CFG = _cfg(DEFAULT_CONFIG, train_kwargs={"accumulate": 2},
               ema_on=True, ema_kwargs={"decay": 0.9})


def _jmesh():
    return jmake_mesh(num_data=2, num_model=2, devices=jax.devices()[:4])


def _jax_step(params, batch, key, tmp):
    """JAX's stage-C step: the loss, the mean gradients before the clip,
    the masters after."""
    jt = JTrainer(_cfg(JAX_CONFIG),
                  unet_config=JUNetConfig(use_cross_attention=False,
                                          cond_channels=4, **UNET_KW),
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
    cfg = UNetConfig(**UNET_KW)
    return {"loss": float(metrics["loss"]),
            "grads": convert.unet_state_dict_from_jax(jax.tree_util.tree_map(
                np.asarray, state.opt_state[1]), cfg),
            "params": convert.unet_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, state.params), cfg)}


def _jax_sample(params, image, init):
    """JAX's bf16 sampling composition on the mesh: the TP UNet, the VAEs
    under ``spatial_constraint``, 2 DDIM steps with self-conditioning."""
    mesh = _jmesh()
    bf = jnp.bfloat16
    up, ip, sp = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, bf), p)
                  for p in params)
    up = japply_tp(mesh, up)
    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **UNET_KW))
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
        x0 = jddim_sample(sched, model_fn, init, num_inference_steps=2,
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
    rng = np.random.RandomState(3)
    init = rng.randn(B, 4, 8, 4).astype(np.float32)
    tmp = tmp_path_factory.mktemp("model_axis")
    acc_micro = [(batch, _draws(jax.random.key(20 + i))) for i in range(2)]
    spec = {"cfg": _cfg(DEFAULT_CONFIG), "unet_kw": UNET_KW,
            "acc_cfg": ACC_CFG, "acc_micro": acc_micro,
            "params": params, "micro": (batch, _draws(key)),
            "folder": str(tmp / "port"),
            "sample_cfg": _cfg(DEFAULT_CONFIG, train_kwargs={
                "weight_dtype": "bfloat16"}),
            "sample_batch": {"image": batch["image"]}, "init": init}
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, W.model_axis_stage2, 4,
                              args=(spec,), device="cpu", timeout_s=300)
        jax_step = _jax_step(params, batch, key, tmp / "jax")
        jax_sample = _jax_sample(params, batch["image"], init)
        ranks = spawned.result()
    return {"ranks": ranks, "step": jax_step, "sample": jax_sample,
            "params": params, "spec": spec}


def _whole(ranks, key):
    """``key`` (a dict of tensors by parameter name) of data rank 0's two
    model ranks, the shards put together."""
    r0, r1 = ranks[0], ranks[1]
    assert (r0["data_rank"], r0["model_rank"], r1["model_rank"]) == (0, 0, 1)
    lay = r0["layout"]
    return {n: tp.whole_tensor([r0[key][n], r1[key][n]], *lay[n])
            if n in lay else r0[key][n] for n in r0[key]}


def test_composed_step_matches_jax_stage_c(runs):
    ranks, ref = runs["ranks"], runs["step"]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=1e-4)
    grads = _whole(ranks, "grads")
    assert grads.keys() == ref["grads"].keys()
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref["grads"][n].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=n)
    # the clip acted: the global norm is above clip_grad
    norm = float(torch.stack([g.norm() for g in grads.values()]).norm())
    assert norm > 0.05
    masters = _whole(ranks, "masters")
    for n, p in masters.items():
        g, j = grads[n].numpy(), ref["grads"][n].numpy()
        cond = 2.0 * np.abs(g - j) / (np.maximum(np.abs(g), np.abs(j))
                                      + 1e-8)
        err = np.abs(p.numpy() - ref["params"][n].numpy())
        assert (err <= LR * (1e-3 + cond)).all(), (n, float(err.max()))
    # the data ranks of a model rank hold the same masters
    for n, p in ranks[0]["masters"].items():
        assert torch.equal(p, ranks[2]["masters"][n]), n


def test_zero1_state_shares_a_quarter(runs):
    shares = [r["state_bytes"] for r in runs["ranks"]]
    assert all(0.2 < s / sum(shares) < 0.3 for s in shares), shares


def test_checkpoint_is_one_rank_layout_and_resumes_bit_equal(runs):
    ranks = runs["ranks"]
    path = ranks[0]["saved"]
    data = torch.load(path, weights_only=True)
    masters = _whole(ranks, "masters")
    assert data["step"] == 1
    for n, p in masters.items():
        assert torch.equal(data["params"][n], p), n
    # on the mesh, each rank's resumed shards and optimizer state equal
    # the ones that wrote it
    assert all(r["resumed"] for r in ranks)
    tr = TrainerDiffusion(_cfg(DEFAULT_CONFIG),
                          unet_config=UNetConfig(**UNET_KW), device="cpu")
    tr.load_jax_params(*runs["params"])
    tr.resume(path)
    assert tr.state.step == 1
    for n, p in tr.unet.named_parameters():
        assert torch.equal(p.detach(), masters[n]), n
    sd = tr.state.optimizer.state_dict()
    assert sd["count"] == data["opt_state"]["count"] == 1
    for i, st in data["opt_state"]["torch"]["state"].items():
        for k, v in st.items():
            assert torch.equal(sd["torch"]["state"][i][k], v), (i, k)
            if k == "exp_avg":  # the moments are whole parameters' shapes
                name = tr._grouped_names()[i]
                assert v.shape == masters[name].shape


def test_bf16_sample_with_tp_and_sp_matches_jax(runs):
    logits_ref, x0_ref = runs["sample"]
    ranks = runs["ranks"]
    x0 = torch.cat([ranks[0]["x0"], ranks[2]["x0"]]).numpy()
    logits = torch.cat([ranks[0]["logits"], ranks[2]["logits"]]).numpy()
    assert x0.shape == x0_ref.shape and logits.shape == logits_ref.shape
    for r, q in ((ranks[1], ranks[0]), (ranks[3], ranks[2])):
        # a data rank's model ranks hold the same samples
        assert torch.equal(r["x0"], q["x0"])
        assert torch.equal(r["logits"], q["logits"])
    assert np.abs(x0 - x0_ref).max() <= 2e-2 * np.abs(x0_ref).max()
    assert np.abs(logits - logits_ref).max() <= \
        2e-2 * np.abs(logits_ref).max()


def _adamw_bound(ours, theirs, grads, ref_grads, n):
    """1e-3 x lr, plus what the gradients' difference moves AdamW's first
    step where a gradient is at that difference's level."""
    g, j = grads[n].numpy(), ref_grads[n].numpy()
    cond = 2.0 * np.abs(g - j) / (np.maximum(np.abs(g), np.abs(j)) + 1e-8)
    err = np.abs(ours.numpy() - theirs.numpy())
    return (err <= LR * (1e-3 + cond)).all(), float(err.max())


def test_accumulation_and_ema_on_the_mesh_as_one_process(runs):
    ranks, spec = runs["ranks"], runs["spec"]
    acc = [r["acc"] for r in ranks]
    assert all(a["step"] == 1 for a in acc)
    tr = TrainerDiffusion(ACC_CFG, unet_config=UNetConfig(**UNET_KW),
                          device="cpu")
    tr.load_jax_params(*runs["params"])
    before = {n: p.detach().clone() for n, p in tr.unet.named_parameters()}
    seen = []
    W._capture_steps(tr.state.optimizer, seen)
    for batch, d in spec["acc_micro"]:
        tr.forward_backward(batch, noise=d["noise"],
                            timesteps=d["timesteps"])
        tr.state.apply_gradients()
    assert tr.state.step == 1
    one = W._named(list(tr.unet.named_parameters()), seen)[0]
    grads = _whole([{**r, "g": r["acc"]["grads"]} for r in ranks], "g")
    masters = _whole([{**r, "m": r["acc"]["masters"]} for r in ranks], "m")
    ema = _whole([{**r, "e": r["acc"]["ema"]} for r in ranks], "e")
    for n, p in tr.unet.named_parameters():
        np.testing.assert_allclose(grads[n].numpy(), one[n].numpy(),
                                   rtol=5e-3, atol=5e-4, err_msg=n)
        ok, err = _adamw_bound(masters[n], p.detach(), grads, one, n)
        assert ok, (n, err)
        # the EMA moved a tenth of the way from the start to the masters
        want = torch.lerp(before[n], masters[n], 0.1)
        np.testing.assert_allclose(ema[n].numpy(), want.numpy(), rtol=0,
                                   atol=1e-7, err_msg=n)
