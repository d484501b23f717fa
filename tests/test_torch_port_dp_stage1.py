"""Stage 1 and the pose net under data parallelism against the JAX package:
two gloo ranks of the port against JAX on a 2-device ``make_mesh(num_data=
2)``, the same weights and the same global draws (each rank its rows), in
fp32:

  * one ``TrainerAE`` step with ZeRO-1 at global batch 4, where the second
    rank's rows are mostly the ignore label, so that the CE's valid-point
    count and the mask count differ per rank: the loss and its parts as
    JAX's (1e-5 relative; the ranks' own counts miss them), the reduced
    gradients within 1e-4 of each tensor's largest entry, the masters
    after AdamW within 1e-3 x lr (plus what the gradients' difference moves
    AdamW's first step, as in test_torch_port_dp_train);
  * one ``TrainerPose`` step at global batch 4 (2 clips a rank): the loss,
    the gradients and the masters the same way.

Both ranks' runs are one spawn of ``tests/torch_dp_workers.py`` each, in a
thread while JAX compiles.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
optax = pytest.importorskip("optax")
import torch  # noqa: E402

from ldmseg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ldmseg_tpu.parallel import replicate as jreplicate  # noqa: E402
from ldmseg_tpu.parallel import shard_batch as jshard  # noqa: E402
from ldmseg_tpu.train.state import TrainState as JState  # noqa: E402
from ldmseg_tpu.train.trainer_ae import TrainerAE as JTrainerAE  # noqa
from ldmseg_tpu.train.trainer_pose import TrainerPose as JTrainerPose  # noqa
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.parallel.launch import run_ranks  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

import torch_dp_workers as W  # noqa: E402
from test_torch_port_dp_train import _capture  # noqa: E402
from test_torch_port_pose import CFG as POSE_CFG  # noqa: E402
from test_torch_port_pose import HW, _depth, _pose_params  # noqa: E402
from test_torch_port_trainer_ae import (FAST, _cfg, _draws,  # noqa: E402
                                        _random_variables)

B = 4
AE = {"train_kwargs": {"batch_size": B},
      "optimizer_zero_redundancy": True}
AE_LR = 1e-4  # test_torch_port_trainer_ae's COMMON
POSE = {"train_kwargs": {"batch_size": B}}
POSE_LR = 1e-4


def _ae_batch(seed=0, size=16):
    """Global batch 4: the last two rows (the second rank's) are the
    ignore label (0) but for a corner."""
    rng = np.random.RandomState(seed)
    sem = rng.randint(0, 7, (B, size, size)).astype(np.int32)
    sem[2:, 3:, :] = 0
    sem[2:, :, 4:] = 0
    return {"image_semseg": rng.randint(0, 2, (B, size, size, 4)).astype(
                np.float32),
            "semseg": sem,
            "image": rng.randn(B, size, size, 3).astype(np.float32)}


def _close_masters(ours, ref_new, grads, ref_grads, lr):
    """The masters within 1e-3 x lr of JAX's, plus 2 lr |dg| / (|g| +
    eps) where |g| is at the level of the gradients' difference."""
    for n, p in ours.items():
        g, j = grads[n].numpy(), ref_grads[n].numpy()
        cond = 2.0 * np.abs(g - j) / (np.maximum(np.abs(g), np.abs(j))
                                      + 1e-8)
        err = np.abs(p.numpy() - ref_new[n].numpy())
        assert (err <= lr * (1e-3 + cond)).all(), (n, float(err.max()))


def _close_grads(ours, ref):
    for n, g in ours.items():
        scale = float(ref[n].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[n].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_ae")
    mesh = jmake_mesh(num_data=2)
    jtr = JTrainerAE(_cfg(JAX_CONFIG, "float32", **AE), mesh=mesh,
                     results_folder=str(root))
    batch = _ae_batch()
    params = _random_variables(jtr.vae, batch, jtr.fuse_rgb, 3)
    key = jax.random.key(7)
    draws = _draws(jtr, params, key, batch)
    spec = {"cfg": _cfg(DEFAULT_CONFIG, "float32", **AE), "batch": batch,
            "params": jax.tree_util.tree_map(np.asarray, params),
            "draws": draws}
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, W.stage1, 2, args=(spec,),
                              device="cpu", timeout_s=180)

        def step(p, batch, key):
            (loss, parts), grads = jax.value_and_grad(
                jtr._forward_loss, has_aux=True)(p, batch, key)
            updates, _ = jtr.tx.update(grads, jtr.tx.init(p), p)
            return loss, parts, grads, optax.apply_updates(p, updates)
        args = (jreplicate(mesh, params), jshard(mesh, batch), key)
        loss, parts, grads, new = jax.jit(step).lower(*args).compile(
            compiler_options=FAST)(*args)
        ranks = spawned.result()
    kw = spec["cfg"]["vae_model_kwargs"]
    to_port = lambda t: convert.seg_vae_state_dict_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), kw)
    return {"ranks": ranks, "loss": float(loss),
            "parts": {k: float(v) for k, v in parts.items()},
            "grads": to_port(grads), "new": to_port(new)}


def test_stage1_two_ranks_step_as_jax_mesh(stage1):
    r0, r1 = stage1["ranks"]
    np.testing.assert_allclose(r0["loss"], stage1["loss"], rtol=1e-5)
    for k in ("ce", "mask", "kl"):
        np.testing.assert_allclose(r0["parts"][k], stage1["parts"][k],
                                   rtol=1e-5, err_msg=k)
    # each rank's own valid-point and mask counts miss JAX's CE and mask
    # loss by far more than the tolerance they are held to
    for k in ("ce", "mask"):
        assert abs(r0["own_parts"][k] - stage1["parts"][k]) > \
            100 * 1e-5 * abs(stage1["parts"][k]), k
    _close_grads(r0["grads"][0], stage1["grads"])
    for n, p in r0["masters"].items():
        assert torch.equal(p, r1["masters"][n]), n
    _close_masters(r0["masters"], stage1["new"], r0["grads"][0],
                   stage1["grads"], AE_LR)


@pytest.fixture(scope="module")
def pose(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_pose")
    cfg = merge_dicts(POSE_CFG, POSE)
    rng = np.random.RandomState(8)
    t, (h, w) = 3, HW
    base = rng.rand(B, 1, h, w, 3).astype(np.float32)
    batch = {"image": (base + 0.05 * rng.randn(B, t, h, w, 3)).astype(
                 np.float32),
             "depth": np.stack([_depth(rng, B, h, w)] * t, 1),
             "focal": np.array([70.0, 85.0, 60.0, 90.0], np.float32)}
    mesh = jmake_mesh(num_data=2)
    jtr = JTrainerPose(merge_dicts(JAX_CONFIG, {
        k: cfg[k] for k in ("train_kwargs", "optimizer_kwargs",
                            "lr_scheduler_kwargs")}), mesh=mesh,
        results_folder=str(root / "jax"), nb_ref_imgs=2, output_exp=True)
    params = _pose_params(jtr.model, HW, 9)
    spec = {"cfg": cfg, "batch": batch, "folder": str(root / "port"),
            "nb_ref": 2, "params": jax.tree_util.tree_map(np.asarray,
                                                          params)}
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, W.pose, 2, args=(spec,),
                              device="cpu", timeout_s=180)
        state = JState.create(jreplicate(mesh, params), _capture(jtr.tx))
        db = jshard(mesh, batch)
        key = jax.random.key(0)
        state, metrics = jtr._train_step.lower(state, db, key).compile(
            compiler_options=FAST)(state, db, key)
        ranks = spawned.result()
    to_port = lambda t: convert.pose_state_dict_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t), output_exp=True)
    return {"ranks": ranks, "loss": float(metrics["loss"]),
            "grads": to_port(state.opt_state[1]),
            "new": to_port(state.params)}


def test_pose_two_ranks_step_as_jax_mesh(pose):
    r0, r1 = pose["ranks"]
    np.testing.assert_allclose(r0["loss"], pose["loss"], rtol=1e-5)
    grads = r0["grads"][0]
    # the coarser masks feed no term: no gradient on any rank, as in one
    # process (JAX's are zeros)
    for n, g in pose["grads"].items():
        if n not in grads:
            assert float(g.abs().max()) == 0.0, n
    _close_grads(grads, pose["grads"])
    for n, p in r0["masters"].items():
        assert torch.equal(p, r1["masters"][n]), n
    _close_masters({n: r0["masters"][n] for n in grads}, pose["new"], grads,
                   pose["grads"], POSE_LR)
