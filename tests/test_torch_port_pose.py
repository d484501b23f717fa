"""The port's pose math, PoseExpNet and TrainerPose against the JAX
package's on the CPU.

- ``euler_to_matrix``, ``pose_vec_to_mat``, ``invert_pose_mat``: atol 1e-6.
- ``inverse_warp`` bilinear and nearest, with a pose vector and with a
  matrix, channels-last and NCHW: warped atol 1e-5 (bilinear, on frames
  smooth at the pixel scale), equal (nearest; where a rotation is in play,
  apart from coordinates within 1e-4 px of a rounding boundary), ``valid``
  equal.
- ``photometric_consistency_loss`` with and without explainability masks,
  ``segmentation_consistency_loss``: rtol 1e-5.
- ``PoseExpNet`` with and without ``output_exp`` at 64x128 and at an odd
  size, weights through ``pose_state_dict_from_jax``: atol 1e-5; the
  decoder's keys dropped exactly when a model without the decoder adopts a
  tree or state dict that has them.
- One ``TrainerPose`` step from the same weights and clip batch as JAX's
  ``_train_step_impl``: loss rtol 1e-4, every gradient within 1e-4 of its
  leaf's largest, and the parameters after one AdamW step atol 1e-5.

The JAX references compile at XLA's lowest CPU optimisation level.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.losses import pose_consistency as jpc  # noqa: E402
from ldmseg_tpu.models.posenet import PoseExpNet as JPoseExpNet  # noqa
from ldmseg_torch.losses import pose_consistency as pc  # noqa: E402
from ldmseg_torch.models.convert import pose_state_dict_from_jax  # noqa
from ldmseg_torch.models.posenet import (PoseExpNet,  # noqa: E402
                                         load_pose_state_dict)
from ldmseg_torch.train.trainer_pose import TrainerPose  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

CPU = torch.device("cpu")
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
HW = (64, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    # a copy: never a tensor sharing memory with an array JAX reads
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _fast(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


def _close(ours, ref, atol, rtol=0.0, msg=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


def _poses(rng, b, r=None):
    shape = (b, 6) if r is None else (b, r, 6)
    scale = np.array([0.3, 0.1, 0.5, 0.02, 0.03, 0.02], np.float32)
    return (rng.randn(*shape) * scale).astype(np.float32)


def _depth(rng, b, h, w):
    yy = np.arange(h, dtype=np.float32)[:, None] / h
    return (2.0 + 30.0 * yy + rng.rand(b, h, w)).astype(np.float32)


# ---------------------------------------------------------------------------
# pose math and warps
# ---------------------------------------------------------------------------
def test_pose_matrices_match_jax():
    rng = np.random.RandomState(0)
    pose = (rng.randn(4, 3, 6) * 0.5).astype(np.float32)
    _close(pc.euler_to_matrix(_t(pose[..., 3:])),
           jpc.euler_to_matrix(jnp.asarray(pose[..., 3:])), 1e-6)
    mat = pc.pose_vec_to_mat(_t(pose))
    jmat = jpc.pose_vec_to_mat(jnp.asarray(pose))
    assert tuple(mat.shape) == (4, 3, 3, 4)
    _close(mat, jmat, 1e-6)
    _close(pc.invert_pose_mat(mat), jpc.invert_pose_mat(jmat), 1e-6)
    # the inverse composes to the identity
    inv = pc.invert_pose_mat(mat)
    rot = pc._mat33(inv[..., :3], mat[..., :3])
    _close(rot, np.broadcast_to(np.eye(3, dtype=np.float32), rot.shape),
           1e-6)


def _smooth(rng, shape):
    """Frames smooth at the pixel scale: three waves of at most one cycle
    across the frame per channel (a slope below 0.1 a pixel)."""
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros(shape, np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(-1, 1, 2)
        phase = rng.uniform(0, 2 * np.pi, (b, 1, 1, c))
        amp = rng.uniform(0.2, 0.5, (b, 1, 1, c))
        arg = 2 * np.pi * (fy * yy / h + fx * xx / w)
        out += (amp * np.sin(arg[None, :, :, None] + phase)).astype(
            np.float32)
    return out


def _ramps(b, h, w):
    """Each pixel's (x, y) index: bilinear reads of it are the sampling
    positions themselves."""
    return np.ascontiguousarray(np.broadcast_to(np.stack(np.meshgrid(
        np.arange(w), np.arange(h)), -1), (b, h, w, 2)).astype(np.float32))


def _warp_both(ref, depth, pose, focal, mode, as_matrix):
    jpose, tpose = jnp.asarray(pose), _t(pose)
    if as_matrix:
        jpose = jpc.invert_pose_mat(jpc.pose_vec_to_mat(jpose))
        tpose = pc.invert_pose_mat(pc.pose_vec_to_mat(tpose))
    jw, jv = jpc.inverse_warp(jnp.asarray(ref), jnp.asarray(depth), jpose,
                              jnp.asarray(focal), mode=mode)
    tw, tv = pc.inverse_warp(_t(ref), _t(depth), tpose, _t(focal),
                             mode=mode)
    assert tv.dtype == torch.bool and tuple(tw.shape) == ref.shape
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0.5 < float(tv.float().mean()) < 1.0  # in and out of bounds
    # NCHW in and out: the same values
    tw2, tv2 = pc.inverse_warp(_t(ref).permute(0, 3, 1, 2), _t(depth),
                               tpose, _t(focal), mode=mode,
                               channels_last=False)
    assert torch.equal(tw2.permute(0, 2, 3, 1), tw) and torch.equal(tv2, tv)
    return tw, np.asarray(jw), (tpose if mode == "nearest" else tv)


@pytest.mark.parametrize("as_matrix", [False, True])
def test_inverse_warp_bilinear_matches_jax(as_matrix):
    # the two packages' fp32 pixel coordinates differ by a few ulps (their
    # 3x3 products sum in other orders): on the valid pixels (those the
    # losses and the clip blend read) the sampling positions (the
    # pixel-index ramps warped, exact on a linear function) agree within
    # 1e-4 px, and on smooth frames the reads within 1e-5. A read that
    # leaves the frame blends with the zero padding, so there the value
    # itself, not its slope, scales the same few ulps
    rng = np.random.RandomState(1 + as_matrix)
    b, (h, w), c = 2, HW, 5
    depth, pose = _depth(rng, b, h, w), _poses(rng, b)
    focal = np.array([70.0, 95.5], np.float32)
    tw, jw, valid = _warp_both(_smooth(rng, (b, h, w, c)), depth, pose,
                               focal, "bilinear", as_matrix)
    _close(tw * valid[..., None], jw * valid.numpy()[..., None], 1e-5)
    _close(tw, jw, 1e-4)
    tw, jw, _ = _warp_both(_ramps(b, h, w), depth, pose, focal, "bilinear",
                           as_matrix)
    _close(tw * valid[..., None], jw * valid.numpy()[..., None], 1e-4)


@pytest.mark.parametrize("as_matrix", [False, True])
def test_inverse_warp_nearest_matches_jax(as_matrix):
    """Nearest picks, half to even. With no rotation, a power-of-two focal
    length and dyadic depth and translation every coordinate is exact in
    both packages: the warps are equal. With a rotation they differ only
    where a coordinate lies within 1e-4 px of a rounding boundary, found
    by warping the pixel-index ramps bilinearly (exact on a linear
    function)."""
    rng = np.random.RandomState(3 + as_matrix)
    b, (h, w), c = 2, HW, 4
    ref = rng.randn(b, h, w, c).astype(np.float32)
    depth = (2.0 + np.floor(rng.rand(b, h, w) * 64) / 2).astype(np.float32)
    pose = np.zeros((b, 6), np.float32)
    pose[:, :3] = [[0.25, -0.125, 0.5], [-0.5, 0.0625, 0.25]]
    tw, jw, _ = _warp_both(ref, depth, pose, np.array([64.0, 128.0],
                                                       np.float32),
                           "nearest", as_matrix)
    assert np.array_equal(tw.numpy(), jw)

    depth = _depth(rng, b, h, w)
    pose = _poses(rng, b)
    focal = np.array([70.0, 95.5], np.float32)
    tw, jw, tpose = _warp_both(ref, depth, pose, focal, "nearest",
                               as_matrix)
    at, _ = pc.inverse_warp(_t(_ramps(b, h, w)), _t(depth), tpose,
                            _t(focal))
    frac = np.abs(np.mod(at.numpy(), 1.0) - 0.5)
    near_tie = (frac < 1e-4).any(-1)
    differ = (tw.numpy() != jw).any(-1)
    assert not (differ & ~near_tie).any()


@pytest.mark.parametrize("with_masks", [False, True])
def test_photometric_loss_matches_jax(with_masks):
    rng = np.random.RandomState(3)
    b, r, (h, w) = 2, 2, HW
    target = _smooth(rng, (b, h, w, 3))
    refs = _smooth(rng, (b * r, h, w, 3)).reshape(b, r, h, w, 3)
    depth = _depth(rng, b, h, w)
    poses = _poses(rng, b, r)
    focal = np.array([80.0, 707.0 * w / 1242], np.float32)
    masks = rng.uniform(0.05, 0.95, (b, h, w, r)).astype(np.float32) \
        if with_masks else None
    ref = jpc.photometric_consistency_loss(
        jnp.asarray(target), jnp.asarray(refs), jnp.asarray(depth),
        jnp.asarray(poses), jnp.asarray(focal),
        exp_masks=None if masks is None else jnp.asarray(masks))
    ours = pc.photometric_consistency_loss(
        _t(target), _t(refs), _t(depth), _t(poses), _t(focal),
        exp_masks=None if masks is None else _t(masks))
    for key in ("photo", "mask_reg"):
        _close(ours[key], ref[key], 1e-12, rtol=1e-5, msg=key)
    assert float(ours["photo"]) > 0
    assert (float(ours["mask_reg"]) > 0) == with_masks
    # every pixel, reads that leave the frame too (see the bilinear warp)
    _close(ours["warped"], ref["warped"], 1e-4)


def test_segmentation_consistency_loss_matches_jax():
    rng = np.random.RandomState(4)
    b, (h, w) = 2, HW
    bits = (rng.rand(2, b, h, w, 6) > 0.5).astype(np.float32) * 2 - 1
    # nearest picks: the coordinates exact in both packages (see
    # test_inverse_warp_nearest_matches_jax)
    depth = (2.0 + np.floor(rng.rand(b, h, w) * 64) / 2).astype(np.float32)
    pose = np.zeros((b, 6), np.float32)
    pose[:, :3] = [[0.25, -0.125, 0.5], [-0.5, 0.0625, 0.25]]
    focal = np.array([64.0, 128.0], np.float32)
    ref = jpc.segmentation_consistency_loss(
        jnp.asarray(bits[0]), jnp.asarray(bits[1]), jnp.asarray(depth),
        jnp.asarray(pose), jnp.asarray(focal))
    ours = pc.segmentation_consistency_loss(
        _t(bits[0]), _t(bits[1]), _t(depth), _t(pose), _t(focal))
    assert float(ours) > 0
    _close(ours, ref, 1e-12, rtol=1e-5)


# ---------------------------------------------------------------------------
# PoseExpNet
# ---------------------------------------------------------------------------
def _pose_params(net, hw, seed):
    """The tree ``net.init`` makes, drawn with numpy (scaled so that the
    ReLUs keep about half their inputs at every stage)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1,) + hw + (3,)),
        [jnp.zeros((1,) + hw + (3,))] * net.nb_ref_imgs))

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) * (2.0 / fan_in) ** 0.5).astype(
                np.float32)
        return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [HW, (45, 77)])
def test_posenet_matches_jax(hw):
    rng = np.random.RandomState(5)
    target = rng.randn(2, *hw, 3).astype(np.float32)
    refs = [rng.randn(2, *hw, 3).astype(np.float32) for _ in range(2)]
    jnet = JPoseExpNet(nb_ref_imgs=2, output_exp=True)
    params = _pose_params(jnet, hw, 6)
    jmasks, jpose = _fast(
        lambda p, t, r0, r1: jnet.apply(p, t, [r0, r1], train=True),
        params, jnp.asarray(target), *map(jnp.asarray, refs))
    for exp in (True, False):
        net = PoseExpNet(nb_ref_imgs=2, output_exp=exp)
        net.load_state_dict(pose_state_dict_from_jax(params, exp),
                            strict=True)
        with torch.no_grad():
            masks, pose = net(_nchw(target), [_nchw(r) for r in refs])
            single, pose_eval = net(_nchw(target), [_nchw(r) for r in refs],
                                    train=False)
        assert tuple(pose.shape) == (2, 2, 6) and torch.equal(pose,
                                                              pose_eval)
        _close(pose, jpose, 1e-5)
        assert float(pose.abs().max()) > 1e-3
        if not exp:
            assert masks == [None] * 4 and single is None
            continue
        assert torch.equal(single, masks[0])
        for m, jm in zip(masks, jmasks):
            _close(m.permute(0, 2, 3, 1), jm, 1e-5)
        assert tuple(masks[0].shape) == (2, 2) + hw


def test_posenet_decoder_keys_drop_exactly():
    jnet = JPoseExpNet(nb_ref_imgs=2, output_exp=True)
    params = _pose_params(jnet, HW, 7)
    full = pose_state_dict_from_jax(params, output_exp=True)
    assert any(k.startswith("upconv1") for k in full)
    # the tree with the decoder converts for a model without it ...
    enc = pose_state_dict_from_jax(params, output_exp=False)
    assert set(enc) == set(PoseExpNet(2, False).state_dict())
    # ... and so does the port's state dict
    net = PoseExpNet(2, output_exp=False)
    load_pose_state_dict(net, full)
    assert torch.equal(net.conv1.weight, full["conv1.weight"])
    # any other missing or extra key raises
    with pytest.raises(RuntimeError):
        load_pose_state_dict(net, dict(enc, extra=torch.zeros(1)))
    with pytest.raises(RuntimeError):
        load_pose_state_dict(PoseExpNet(2, output_exp=True), enc)
    bad = dict(params["params"])
    bad.pop("conv3")
    with pytest.raises(KeyError, match="conv3"):
        pose_state_dict_from_jax({"params": bad})
    with pytest.raises(KeyError, match="upconv"):
        pose_state_dict_from_jax(_pose_params(JPoseExpNet(2, False), HW, 0),
                                 output_exp=True)


# ---------------------------------------------------------------------------
# TrainerPose
# ---------------------------------------------------------------------------
CFG = merge_dicts(DEFAULT_CONFIG, {
    "train_kwargs": {"batch_size": 2, "train_num_steps": 3,
                     "clip_grad": 1.0},
    "optimizer_kwargs": {"lr": 1e-4},
    "lr_scheduler_kwargs": {"warmup_iters": 1}})


class _GradState:
    """Stands in for the JAX TrainState: ``apply_gradients`` hands back the
    gradients."""

    def __init__(self, params):
        self.params = params

    def apply_gradients(self, grads):
        return grads


@pytest.fixture(scope="module")
def pose_step(tmp_path_factory):
    from ldmseg_tpu.parallel import make_mesh
    from ldmseg_tpu.train.state import TrainState as JState
    from ldmseg_tpu.train.trainer_pose import TrainerPose as JTrainerPose
    rng = np.random.RandomState(8)
    b, t, (h, w) = 2, 3, HW
    base = rng.rand(b, 1, h, w, 3).astype(np.float32)
    image = (base + 0.05 * rng.randn(b, t, h, w, 3)).astype(np.float32)
    batch = {"image": image, "depth": np.stack([_depth(rng, b, h, w)] * t, 1),
             "focal": np.array([70.0, 85.0], np.float32)}
    jtr = JTrainerPose(CFG, mesh=make_mesh(devices=jax.devices()[:1]),
                       results_folder=str(tmp_path_factory.mktemp("jp")),
                       nb_ref_imgs=2, output_exp=True)
    params = _pose_params(jtr.model, HW, 9)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads, metrics = _fast(
        lambda p, bb: jtr._train_step_impl(_GradState(p), bb, None),
        params, jb)
    new_params = _fast(
        lambda p, g: JState.create(p, jtr.tx).apply_gradients(g).params,
        params, grads)
    return params, batch, grads, metrics, new_params


def test_trainer_pose_step_matches_jax(pose_step, tmp_path):
    params, batch, grads, metrics, new_params = pose_step
    tr = TrainerPose(CFG, results_folder=str(tmp_path), device=CPU)
    tr.load_jax_params(params)
    loss, parts = tr.forward_loss(batch)
    for key in ("photo", "mask_reg"):
        _close(parts[key], metrics[key], 0.0, rtol=1e-4, msg=key)
    _close(loss, metrics["loss"], 0.0, rtol=1e-4)
    loss.backward()
    ref = pose_state_dict_from_jax(grads, output_exp=True)
    for name, p in tr.model.named_parameters():
        g = ref[name]
        scale = float(g.abs().max())
        # the coarser masks (predict_mask2-4) feed no term: zero gradients
        assert (scale > 0) != name.startswith(("predict_mask2",
                                               "predict_mask3",
                                               "predict_mask4")), name
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close(grad, g, 1e-4 * scale, msg=name)
    # train_step: the same loss, then one AdamW step
    tr = TrainerPose(CFG, results_folder=str(tmp_path), device=CPU)
    tr.load_jax_params(params)
    step = tr.train_step(batch)
    _close(step["loss"], metrics["loss"], 0.0, rtol=1e-4)
    assert tr.state.step == 1
    after = pose_state_dict_from_jax(new_params, output_exp=True)
    before = pose_state_dict_from_jax(params, output_exp=True)
    for name, p in tr.model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == bool(ref[name].abs().max() > 0), name
        _close(p, after[name], 1e-5, msg=name)


def test_trainer_pose_loop_save_resume_and_predict(tmp_path):
    from ldmseg_torch.data import SyntheticDVPS
    from ldmseg_torch.data.video import ClipDataset
    clips = ClipDataset(SyntheticDVPS(length=6, size=(32, 64),
                                      frames_per_scene=3), clip_len=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=torch.device"):
            TrainerPose(CFG, dataset=clips, results_folder=str(tmp_path))
    tr = TrainerPose(CFG, dataset=clips, results_folder=str(tmp_path),
                     device=CPU)
    with pytest.raises(RuntimeError, match="init_params"):
        tr.predict_poses({"image": np.zeros((1, 3, 32, 64, 3), np.float32)})
    losses = tr.train_loop(max_steps=3, log_every=2)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert tr.state.step == 3
    path = tr.save(step=3)
    data = torch.load(path, weights_only=True)
    assert set(data) == {"params", "nb_ref"} and data["nb_ref"] == 2
    batch = clips[0]
    batch = {"image": batch["image"][None]}
    poses = tr.predict_poses(batch)
    assert tuple(poses.shape) == (1, 2, 6)
    fresh = TrainerPose(CFG, results_folder=str(tmp_path), device=CPU)
    fresh.resume(path)
    assert torch.equal(fresh.predict_poses(batch), poses)
    with pytest.raises(ValueError, match="reference frames"):
        TrainerPose(CFG, results_folder=str(tmp_path), nb_ref_imgs=4,
                    device=CPU).resume(path)
