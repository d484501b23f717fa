"""Stage 2 of the trained-model gate against the JAX trainer on the CPU, at
the gate's own sizes: its config (``small_cfg``), its UNet (widths 32 and
64, 2 heads, 8 groups), its 96x320 synthetic frames at batch 8. From the
same initial weights (JAX's ``init_state``) and on the same batches, three
``train_step`` calls with the JAX step's noise and timesteps handed to the
port: the losses within 1e-2 relative (bf16 compute); then the gate's
10-step sample of a validation batch from JAX's initial noise: x0 within
1e-2 of max|ref| (three bf16 training steps apart). Then the scoring
where DVPQ is not 0: each sample's logits plus the ground truth's one-hot
(weights 1 and 2), scored by ``tools/trained_gate.py`` and by JAX's
resize, ``panoptic_post_process`` and ``evaluate_dvpq``: the same logits
give the same DVPQ within 1e-6, the port's sample JAX's within 0.1.

About a minute (JAX compiles the gate's trainer), so it is marked
``slow``: ``python -m pytest -m slow tests/test_torch_port_gate_stage2.py
-p no:randomly``."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

STEPS = 3
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(
        *args)


def _copy(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), tree)


@pytest.mark.slow
def test_gate_stage2_steps_and_sample_match_jax(tmp_path):
    from ldmseg_tpu.data import Loader as JLoader
    from ldmseg_tpu.data import SyntheticDVPS as JSynthetic
    from ldmseg_tpu.models import UNetConfig as JUNetConfig
    from ldmseg_tpu.parallel import make_mesh
    from ldmseg_tpu.tools.perf import trained_gate as jax_gate
    from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer
    from ldmseg_tpu.train.trainer_ldm import _cast_f32
    from ldmseg_tpu.utils.config import (DEFAULT_CONFIG as JAX_DEFAULT,
                                         merge_dicts as jax_merge)
    from ldmseg_torch.tools import trained_gate
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

    ldm = {"sampling_kwargs": {"num_inference_steps": 10,
                               "int8_inference": False}}
    jcfg = jax_merge(jax_gate.small_cfg(jax_merge, JAX_DEFAULT), ldm)
    cfg = merge_dicts(trained_gate.small_cfg(merge_dicts, DEFAULT_CONFIG),
                      ldm)
    jtr = JTrainer(jcfg, unet_config=JUNetConfig(
        in_channels=8, out_channels=4, block_out_channels=(32, 64),
        attn_down=(True, True), layers_per_block=1, cross_attention_dim=32,
        attention_head_dim=2, norm_num_groups=8, use_cross_attention=False),
        mesh=make_mesh(devices=jax.devices()[:1]),
        results_folder=str(tmp_path))
    hw = (trained_gate.H, trained_gate.W)
    train = JSynthetic(length=8 * STEPS, size=hw, num_classes=20,
                       frames_per_scene=trained_gate.CLIP_T)
    batches = list(JLoader(train, 8, shuffle=False))
    jtr.init_state(jtr._device_batch(batches[0]), 0)
    tr = TrainerDiffusion(cfg, unet_config=trained_gate.unet_config(),
                          device="cpu")
    tr.load_jax_params(_copy(jtr.state.params),
                       _copy(jtr.frozen_params["vae_img"]),
                       _copy(jtr.frozen_params["vae_seg"]))

    step = None
    key = jax.random.key(0)
    for batch in batches:
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, 10)
        b, h, w = batch["semseg"].shape
        noise = np.asarray(jax.random.normal(keys[3], (b, h // 8, w // 8,
                                                       4)))
        t = np.asarray(jax.random.randint(keys[4], (b,), 0, 1000))
        db = jtr._device_batch(batch)
        args = (jtr.state, jtr.frozen_params, db, sub)
        if step is None:
            step = jax.jit(jtr._train_step_impl).lower(*args).compile(
                compiler_options=FAST_XLA)
        jtr.state, metrics, _ = step(*args)
        mine = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                for k, v in batch.items()}
        loss, _, _ = tr.train_step(mine, noise=noise.copy(),
                                   timesteps=torch.from_numpy(t.copy()))
        want = float(metrics["loss"])
        assert abs(float(loss) - want) <= 1e-2 * abs(want), (float(loss),
                                                              want)

    val = JSynthetic(length=8, size=hw, num_classes=20,
                     frames_per_scene=trained_gate.CLIP_T, seed=1)
    vb = next(iter(JLoader(val, 8, shuffle=False)))
    # the JAX trainer's sample_panoptic, its jits compiled at the lowest
    # optimisation level
    skey = jax.random.key(5)
    rgb = _compiled(jtr._encode_rgb_impl, jtr.frozen_params,
                    jnp.asarray(vb["image"]), skey)
    jlogits, jx0 = _compiled(
        functools.partial(jtr._sample_decode_impl, num_inference_steps=10),
        _cast_f32(jtr.state.eval_params(), jtr.compute_dtype),
        jtr.frozen_params, rgb, skey)
    init = np.asarray(jax.random.normal(skey, rgb.shape[:3] + (4,)))
    logits, x0 = tr.sample_panoptic({"image": vb["image"].copy()},
                                    init_noise=init)
    ref = np.asarray(jx0)
    err = float(np.abs(x0.numpy() - ref).max())
    assert err <= 1e-2 * max(1.0, float(np.abs(ref).max())), err

    # the scoring where DVPQ is not 0: both samples' logits plus the ground
    # truth's one-hot at two weights (DVPQ about 5 and 44 at these weights)
    from ldmseg_tpu.evals import evaluate_dvpq
    from ldmseg_tpu.ops import panoptic_post_process

    def jax_dvpq(lg):
        cleaned, _ = panoptic_post_process(
            jax.image.resize(jnp.asarray(lg), gt.shape + lg.shape[-1:],
                             "linear"), mask_th=tr.mask_th,
            count_th=tr.count_th, overlap_th=tr.overlap_th, ignore_label=0)
        preds = [np.maximum(p, 0) for p in np.asarray(cleaned)]
        zeros = [np.zeros_like(p) for p in preds]
        return evaluate_dvpq(preds, zeros, list(gt), zeros, eval_frames=1,
                             **trained_gate.DVPQ_KW)["pq"]

    def port_dvpq(lg):
        maps = trained_gate.panoptic_maps(torch.from_numpy(lg.copy()),
                                          gt.shape[1:], tr)
        return trained_gate.dvpq(list(maps), list(gt.copy()), 1,
                                 "cpu")["pq"]

    gt = np.stack(list(vb["semseg"]))
    onehot = (gt[..., None] == np.arange(jlogits.shape[-1])).astype(
        np.float32)
    jl, pl = np.asarray(jlogits, np.float32), logits.float().numpy()
    for weight in (1.0, 2.0):
        want = jax_dvpq(jl + weight * onehot)
        assert 1.0 < want < 100.0, (weight, want)
        # the same logits: the same score
        assert port_dvpq(jl + weight * onehot) == pytest.approx(want,
                                                                abs=1e-6)
        # the port's sample: within a tenth of a point (the gate's
        # thresholds are 1 and 2 points)
        assert port_dvpq(pl + weight * onehot) == pytest.approx(want,
                                                                abs=0.1)
