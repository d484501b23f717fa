"""The port's clip sampling against the JAX trainer's on the CPU.

``TrainerDiffusion.sample_panoptic_clip`` and the JAX trainer's
``_sample_clip_impl`` (jitted at XLA's lowest CPU optimisation level) on
the same weights (the tiny models of ``test_torch_port_sampling`` and a
full-depth ``PoseExpNet`` at 64x128), the same clips (one 3-frame clip of
``SyntheticDVPS`` through ``ClipDataset``, with its depth and KITTI's focal
length), and the same noise (JAX's draws from its key, handed to the port
as ``init_noise`` and ``refine_noise``):

- pose warp on (two DDIM steps, a one-step refine tail) and off, clip-shared
  noise on and off, and a DPM-Solver++(2M) first pass (then the DDIM
  tail): x0 and logits within 1e-3 * max(1, max|ref|), the tolerance of
  ``sample_panoptic``'s test;
- (the int8 path: ``test_torch_port_clip_int8``);
- the JAX trainer's pose net in the compute dtype: with bf16 compute the
  poses of both come from bf16-rounded weights computed in fp32;
- a static clip samples more consistently with the warp than without.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.data.synthetic import SyntheticDVPS as JSynthetic  # noqa
from ldmseg_tpu.data.video import ClipDataset as JClipDataset  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.posenet import PoseExpNet as JPoseExpNet  # noqa
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.data.video import ClipDataset  # noqa: E402
from ldmseg_torch.models.convert import pose_state_dict_from_jax  # noqa
from ldmseg_torch.models.posenet import PoseExpNet  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_pose import _pose_params  # noqa: E402
from test_torch_port_sampling import CFG, UNET_KW, _random_params  # noqa

CPU = torch.device("cpu")
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
HW, T = (64, 128), 3
STEPS = 2
# the int8 sampling path, and with it the serving configuration's int8
# image VAE (tools/bench.py:bench_config), at tiny width
INT8_UNET_CFG = merge_dicts(CFG, {"sampling_kwargs": {"int8_inference": True}})
INT8_CFG = merge_dicts(INT8_UNET_CFG, {"image_vae_kwargs": {
    "use_int8": True, "int8_act_scale": 0.05, "use_fused_attention": True}})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_trainer(cfg, tmp):
    from ldmseg_tpu.parallel import make_mesh
    from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer
    return JTrainer(cfg, unet_config=JUNetConfig(
        use_cross_attention=False, cond_channels=4, **UNET_KW),
        mesh=make_mesh(devices=jax.devices()[:1]), results_folder=tmp)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX trainers (float and int8) with their frozen trees and pose
    net attached, the UNet tree, the clip batch."""
    tmp = str(tmp_path_factory.mktemp("jax"))
    jtr = _jax_trainer(CFG, tmp)
    k = jax.random.split(jax.random.key(0), 3)
    up = _random_params(lambda: jtr.unet.init(
        k[0], jnp.zeros((1, 8, 16, 12)), jnp.zeros((1,), jnp.int32)), 0)
    ip = _random_params(lambda: jtr.vae_img.init(
        k[1], jnp.zeros((1,) + HW + (3,)), method=JImageVAE.encode), 1)
    sp = _random_params(lambda: jtr.vae_seg.init(
        {"params": k[2], "sample": k[2]}, jnp.zeros((1,) + HW + (10,)),
        sample_posterior=False), 2)
    pp = _pose_params(JPoseExpNet(nb_ref_imgs=T - 1), HW, 3)
    # 0.5 keeps the tiny random pose net's poses a few pixels' worth
    pp = jax.tree_util.tree_map(lambda x: 0.5 * x, pp)
    params = (up, ip, sp, pp)
    trainers = {"float": _with_frozen(jtr, params)}
    for name, cfg in (("int8", INT8_UNET_CFG), ("int8 vae", INT8_CFG)):
        trainers[name] = lambda cfg=cfg: _with_frozen(_jax_trainer(cfg, tmp),
                                                      params)
    clips = ClipDataset(SyntheticDVPS(length=6, size=HW, num_bits=5,
                                      frames_per_scene=T), clip_len=T)
    clip = clips[1]
    batch = {"image": clip["image"][None], "depth": clip["depth"][None],
             "meta": [clip["meta"]]}
    return trainers, params, batch


def _with_frozen(jtr, params):
    """The JAX trainer with the frozen trees its ``init_state`` would hold
    (fp32 compute: no cast) and the pose net attached."""
    _, ip, sp, pp = params
    jtr.frozen_params = {"vae_img": ip, "vae_seg": sp}
    jtr.attach_pose(JPoseExpNet(nb_ref_imgs=T - 1), pp)
    return jtr


def _jax_clip(jtr, params, batch, key, **kw):
    db = {"image": jnp.asarray(batch["image"]),
          "depth": jnp.asarray(batch["depth"], jnp.float32),
          "focal": jnp.full((batch["image"].shape[0],), 707.0)}
    kw = dict(dict(num_inference_steps=STEPS, repeat_noise=True,
                   pose_warp=True, refine_strength=0.3, warp_blend=0.5,
                   guidance_scale=1.0), **kw)
    fn = jax.jit(lambda p, f, b, k: jtr._sample_clip_impl(p, f, b, k, **kw))
    args = (params, jtr.frozen_params, db, key)
    logits, x0 = fn.lower(*args).compile(compiler_options=FAST_XLA)(*args)
    return np.asarray(logits), np.asarray(x0)


def _jax_noise(key, repeat_noise):
    """The draws of ``_sample_clip_impl`` from ``key``: the init noise (one
    map per clip with ``repeat_noise``) and the refine noise."""
    k_init, k_refine = jax.random.split(key)
    lh, lw = HW[0] // 8, HW[1] // 8
    init = jax.random.normal(k_init, (1, 1 if repeat_noise else T, lh, lw,
                                      4))
    return np.asarray(init), np.asarray(jax.random.normal(
        k_refine, (1, 1, lh, lw, 4)))


def _port(cfg, params):
    up, ip, sp, pp = params
    tr = TrainerDiffusion(cfg, unet_config=UNetConfig(**UNET_KW),
                          device=CPU)
    tr.load_jax_params(up, ip, sp)
    tr.attach_pose(PoseExpNet(nb_ref_imgs=T - 1),
                   pose_state_dict_from_jax(pp))
    return tr


def _assert_close(ours, ref, what):
    ours = ours.numpy()
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    bound = 1e-3 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ours - ref).max())
    assert err <= bound, f"{what}: max abs diff {err} > {bound}"


# (pose_warp, repeat_noise, sampler)
CASES = [(True, True, "ddim"), (False, True, "ddim"), (True, False, "ddim"),
         (True, True, "dpmpp_2m")]


@pytest.fixture(scope="module")
def float_results(models):
    trainers, params, batch = models
    out = {}
    for case in CASES:
        warp, repeat, sampler = case
        jtr = trainers["float"]
        jtr.sampler = sampler
        key = jax.random.key(3)
        out[case] = _jax_clip(jtr, params[0], batch, key, pose_warp=warp,
                              repeat_noise=repeat)
    trainers["float"].sampler = "ddim"
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_sample_panoptic_clip_matches_jax(models, float_results, case):
    trainers, params, batch = models
    warp, repeat, sampler = case
    ref_logits, ref_x0 = float_results[case]
    init, refine = _jax_noise(jax.random.key(3), repeat)
    tr = _port(merge_dicts(CFG, {"sampling_kwargs": {"sampler": sampler}}),
               params)
    logits, x0 = tr.sample_panoptic_clip(
        batch, init_noise=init, refine_noise=refine,
        num_inference_steps=STEPS, repeat_noise=repeat, pose_warp=warp)
    assert logits.shape == (T, *HW, 24) and x0.shape == (T, 8, 16, 4)
    _assert_close(x0, ref_x0, "x0")
    _assert_close(logits, ref_logits, "logits")
    if warp:
        # the warp and the tail moved the frames off the plain pass
        plain = float_results[(False, True, "ddim")][1] if repeat and \
            sampler == "ddim" else None
        if plain is not None:
            assert np.abs(ref_x0 - plain).max() > 1e-2


def test_pose_net_runs_on_bf16_rounded_weights_in_fp32(models):
    trainers, params, batch = models
    pp = params[3]
    from ldmseg_tpu.train.state import cast_f32
    images = jnp.asarray(batch["image"])
    jpose = JPoseExpNet(nb_ref_imgs=T - 1).apply(
        cast_f32(pp, jnp.bfloat16), images[:, 1], [images[:, 0],
                                                   images[:, 2]],
        train=False)[1]
    tr = TrainerDiffusion(merge_dicts(CFG, {"train_kwargs": {
        "weight_dtype": "bfloat16"}}), unet_config=UNetConfig(**UNET_KW),
        device=CPU)
    tr.attach_pose(PoseExpNet(nb_ref_imgs=T - 1),
                   pose_state_dict_from_jax(pp))
    w = tr.pose_model.conv1.weight
    assert w.dtype == torch.float32 and torch.equal(
        w, w.to(torch.bfloat16).float())
    poses, mid, refs = tr._clip_poses(torch.from_numpy(batch["image"]))
    assert (mid, refs) == (1, [0, 2])
    jpose = np.asarray(jpose)
    err = float(np.abs(poses.numpy() - jpose).max())
    assert err <= 1e-4 * float(np.abs(jpose).max()), err
    # and not the fp32 weights' poses: the rounding moves them far more
    full = np.asarray(JPoseExpNet(nb_ref_imgs=T - 1).apply(
        pp, images[:, 1], [images[:, 0], images[:, 2]], train=False)[1])
    assert float(np.abs(full - jpose).max()) > 10 * err


def test_warped_clip_is_more_consistent_on_a_static_scene(models):
    trainers, params, batch = models
    static = {k: np.repeat(np.asarray(batch[k])[:, :1], T, axis=1)
              for k in ("image", "depth")}
    static["meta"] = batch["meta"]
    tr = _port(CFG, params)
    init, refine = _jax_noise(jax.random.key(4), False)

    def disagreement(pose_warp):
        _, x0 = tr.sample_panoptic_clip(
            static, init_noise=init, refine_noise=refine,
            num_inference_steps=4, repeat_noise=False, pose_warp=pose_warp,
            refine_strength=0.5)
        x0 = x0.numpy()
        return float(np.mean(np.abs(np.diff(x0, axis=0))))
    assert disagreement(True) < disagreement(False)


def test_clip_dataset_and_flatten_match_jax():
    from ldmseg_tpu.data.video import flatten_clip_batch as jflatten
    from ldmseg_torch.data import collate
    from ldmseg_torch.data.video import flatten_clip_batch
    for stride in (1, 2):
        ours = ClipDataset(SyntheticDVPS(length=10, size=(16, 32),
                                         frames_per_scene=4), 3, stride)
        ref = JClipDataset(JSynthetic(length=10, size=(16, 32),
                                      frames_per_scene=4), 3, stride)
        assert ours.clips == ref.clips and len(ours) == (4 if stride == 1
                                                         else 2)
        a, b = ours.__getitem__(1, epoch=2), ref.__getitem__(1, epoch=2)
        assert set(a) == set(b)
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert [m["frame"] for m in a["meta"]] == [m["frame"] for m in
                                                     b["meta"]]
        batch = collate([ours[0], ours[1]])
        assert batch["image"].shape == (2, 3, 16, 32, 3)
        flat, jflat = flatten_clip_batch(batch), jflatten(batch)
        assert set(flat) == set(jflat) and flat["image"].shape[0] == 6
        for key in flat:
            if isinstance(flat[key], np.ndarray):
                np.testing.assert_array_equal(flat[key], jflat[key])
        assert [m["image_id"] for m in flat["meta"]] == \
            [m["image_id"] for m in jflat["meta"]]


def test_attach_pose_refuses_meta_model_without_weights():
    """A pose net on the meta device has no weights to freeze: attaching it
    without a state dict raises rather than keep uninitialised memory."""
    tr = TrainerDiffusion(CFG, unet_config=UNetConfig(**UNET_KW), device=CPU)
    with torch.device("meta"):
        net = PoseExpNet(nb_ref_imgs=T - 1)
    with pytest.raises(ValueError, match="meta"):
        tr.attach_pose(net)
