"""The port's eval loop and the sampling arguments it adds, against the JAX
package on the CPU.

- ``TrainerDiffusion.compute_pq`` on a KITTI-DVPS val tree written here
  (``ldmseg_torch/tools/kitti_tree.py``), with both trainers'
  ``sample_panoptic`` replaced by the same fixed logits: the result dict
  equals the JAX trainer's (integers exactly, floats within 1e-12) in the
  full-resolution branch (``keep_fullres_gt``: the weight-matrix restore to
  each image's own size) and the resize branch. The JAX side runs its
  trainer's own ``compute_pq``, ``_eval_fullres`` and ``_fullres_post`` on a
  stand-in object holding the attributes they read (building the JAX
  trainer would initialise and compile its models).
- ``restore_fullres`` and ``restore_resized`` equal JAX's restore +
  post-processing pixel for pixel, with a ``padding`` crop and a partial
  ``gt_mask``.
- ``sample_panoptic(repeat_noise=True)`` gives every frame row 0 of the
  noise; ``guidance_scale`` changes nothing without a context.
- ``ddim_sample``'s ``tmin`` and ``return_all`` against JAX's trajectory.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.data import KittiDVPS as JKitti  # noqa: E402
from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.diffusion.sampler import ddim_sample as jddim_sample  # noqa
from ldmseg_tpu.evals import PanopticEvaluator as JEvaluator  # noqa: E402
from ldmseg_tpu.ops import panoptic_post_process as jpost  # noqa: E402
from ldmseg_tpu.train.trainer_ldm import (  # noqa: E402
    TrainerDiffusion as JTrainer)
from ldmseg_torch.data import KittiDVPS, collate  # noqa: E402
from ldmseg_torch.diffusion import ddim  # noqa: E402
from ldmseg_torch.diffusion.sampler import ddim_sample  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.tools.kitti_tree import write_kitti_dvps_tree  # noqa
from ldmseg_torch.train import trainer_ldm  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

from test_torch_port_evals import _same_results  # noqa: E402

CPU = torch.device("cpu")
CLASSES = 24
CFG = merge_dicts(DEFAULT_CONFIG, {
    "vae_model_kwargs": {
        "in_channels": 10, "int_channels": 16, "out_channels": CLASSES,
        "block_out_channels": [8, 8, 16, 16], "num_upscalers": 2,
        "upscale_channels": 16, "norm_num_groups": 8},
    "image_vae_kwargs": {"block_out_channels": [8, 8, 16, 16], "groups": 8},
    "train_kwargs": {"self_condition": True, "weight_dtype": "float32",
                     "batch_size": 3},
    "eval_kwargs": {"mask_th": 0.5, "count_th": 20, "overlap_th": 0.5},
    "ignore_label": 0,
})
UNET_KW = dict(in_channels=12, out_channels=4, block_out_channels=(8, 16),
               attn_down=(True, False), layers_per_block=1,
               attention_head_dim=2, norm_num_groups=4,
               use_fused_attention=True)
SIZE = (32, 64)          # the model's resolution
TREE_HW = (45, 110)      # the frames' own


def fixed_logits(batch, hw):
    """Logits at ``hw`` for a batch, the same on both sides: a one-hot of
    the model-resolution ``semseg`` (nearest-resized to ``hw``) scaled by
    6, plus seeded noise per image id; shifted so that the sigmoid-overlap
    rule keeps segments."""
    out = []
    for sem, meta in zip(batch["semseg"], batch["meta"]):
        rng = np.random.RandomState(meta["image_id"] % 1000)
        ys = (np.arange(hw[0]) * sem.shape[0] // hw[0])
        xs = (np.arange(hw[1]) * sem.shape[1] // hw[1])
        lab = sem[ys][:, xs]
        x = 6.0 * np.eye(CLASSES, dtype=np.float32)[lab] - 3.0
        out.append(x + 0.5 * rng.randn(*x.shape).astype(np.float32))
    return np.stack(out)


class _JaxEval:
    """The attributes the JAX trainer's eval methods read, and those
    methods."""

    compute_pq = JTrainer.compute_pq
    _eval_fullres = JTrainer._eval_fullres
    _fullres_post = JTrainer._fullres_post

    def __init__(self, ds_val, logits_hw):
        ek = CFG["eval_kwargs"]
        self.p, self.ds_val = CFG, ds_val
        self.batch_size = CFG["train_kwargs"]["batch_size"]
        self.ignore_label = CFG["ignore_label"]
        self.mask_th, self.count_th = ek["mask_th"], ek["count_th"]
        self.overlap_th = ek["overlap_th"]
        self.logits_hw = logits_hw

    def sample_panoptic(self, batch, key, num_inference_steps=None):
        return jnp.asarray(fixed_logits(batch, self.logits_hw)), None


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    write_kitti_dvps_tree(root, "val", frames=5, hw=TREE_HW, scenes=2,
                          seed=11)
    return root


def _port_trainer(ds_val, logits_hw, monkeypatch):
    trainer = TrainerDiffusion(CFG, unet_config=UNetConfig(**UNET_KW),
                               device=CPU, val_dataset=ds_val)
    calls = []

    def sample(batch, generator=None, num_inference_steps=None, **kw):
        calls.append(len(batch["image"]))
        return torch.from_numpy(fixed_logits(batch, logits_hw)), None
    monkeypatch.setattr(trainer, "sample_panoptic", sample)
    return trainer, calls


@pytest.mark.parametrize("fullres,logits_hw,thing_ids", [
    (True, SIZE, frozenset()), (True, SIZE, frozenset(range(11, 19))),
    (False, SIZE, frozenset()), (False, (24, 40), frozenset(range(11, 19)))])
def test_compute_pq_matches_jax(val_root, monkeypatch, fullres, logits_hw,
                                thing_ids):
    kw = dict(split="val", size=SIZE, keep_fullres_gt=fullres)
    ours, calls = _port_trainer(KittiDVPS(prefix=val_root, **kw),
                                logits_hw, monkeypatch)
    ref = _JaxEval(JKitti(prefix=val_root, **kw), logits_hw)
    got = ours.compute_pq(thing_ids=thing_ids)
    want = ref.compute_pq(thing_ids=thing_ids)
    # 5 frames at batch 3: the last batch short (drop_last=False)
    assert calls == [3, 2]
    assert got["tp"] > 0
    _same_results(got, want)
    metrics = ours.compute_metrics(thing_ids=thing_ids, max_batches=1)
    assert set(metrics) == {"pq"} and calls[2:] == [3]


def test_restores_match_jax_pixel_for_pixel(val_root, monkeypatch):
    ds = KittiDVPS(prefix=val_root, split="val", size=SIZE,
                   keep_fullres_gt=True)
    trainer, _ = _port_trainer(ds, SIZE, monkeypatch)
    ref = _JaxEval(None, SIZE)
    batch = collate([ds[i] for i in range(3)])
    logits = fixed_logits(batch, SIZE)
    metas = [dict(m) for m in batch["meta"]]
    metas[1]["padding"] = (2, 0, 0, 4)         # a crop folded into W
    metas[2]["gt_mask"] = metas[2]["gt_mask"].copy()
    metas[2]["gt_mask"][:, :30] = 0
    got = trainer.restore_fullres(torch.from_numpy(logits), metas)
    for bi, m in enumerate(metas):
        oh, ow = m["gt_sem"].shape
        ev_j = JEvaluator(thing_ids=set(), class_agnostic=True)
        ref._eval_fullres(ev_j, jnp.asarray(logits[bi:bi + 1]), [m])
        ev_o = JEvaluator(thing_ids=set(), class_agnostic=True)
        ev_o.add_image(got[bi], m["gt_sem"], m.get("gt_inst"))
        assert got[bi].shape == (oh, ow) and got[bi].dtype == np.int32
        assert (ev_o.TP, ev_o.FP, ev_o.FN) == (ev_j.TP, ev_j.FP, ev_j.FN)
        # JAX's restore, one image at a time, pixel for pixel
        t, b_, le, r = m.get("padding") or (0, 0, 0, 0)
        li = jnp.asarray(logits[bi:bi + 1, t:SIZE[0] - b_, le:SIZE[1] - r])
        li = jax.image.resize(li, (1, oh, ow, CLASSES), "linear")
        want, _ = jpost(li, mask_th=0.5, count_th=20, overlap_th=0.5,
                        ignore_label=0,
                        valid_mask=jnp.asarray(m["gt_mask"][None] > 0))
        assert np.array_equal(got[bi], np.asarray(want)[0])
    # the resize branch: to semseg's size under the batch's mask
    small = fixed_logits(batch, (24, 40))
    got = trainer.restore_resized(torch.from_numpy(small), SIZE,
                                  batch["mask"])
    li = jax.image.resize(jnp.asarray(small), (3, *SIZE, CLASSES), "linear")
    want, _ = jpost(li, mask_th=0.5, count_th=20, overlap_th=0.5,
                    ignore_label=0, valid_mask=jnp.asarray(batch["mask"]))
    assert np.array_equal(got, np.asarray(want))


def test_compute_pq_refuses_what_is_not_ported(val_root, monkeypatch):
    ds = KittiDVPS(prefix=val_root, split="val", size=SIZE)
    trainer, calls = _port_trainer(ds, SIZE, monkeypatch)
    with pytest.raises(ValueError, match="results_folder"):
        trainer.compute_pq(save_model=True)
    # image logging is ported: without a results_folder it is refused
    with pytest.raises(ValueError, match="results_folder"):
        trainer.compute_pq(log_images=True)
    assert calls == []
    bare = TrainerDiffusion(CFG, unet_config=UNetConfig(**UNET_KW),
                            device=CPU)
    with pytest.raises(ValueError, match="val_dataset"):
        bare.compute_pq()


# ---------------------------------------------------------------------------
# sample_panoptic's repeat_noise and guidance_scale
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_trainer():
    trainer = TrainerDiffusion(CFG, unet_config=UNetConfig(**UNET_KW),
                               device=CPU)
    trainer.init_params(seed=3)
    return trainer


@pytest.mark.parametrize("given", [False, True])
def test_repeat_noise_broadcasts_row_zero(tiny_trainer, monkeypatch, given):
    seen = []

    def spy(sched, model_fn, init, **kw):
        seen.append(init.clone())
        return torch.zeros_like(init)
    monkeypatch.setattr(trainer_ldm, "ddim_sample", spy)
    image = np.random.RandomState(0).randn(3, 32, 64, 3).astype(np.float32)
    noise = (np.random.RandomState(1).randn(3, 4, 8, 4).astype(np.float32)
             if given else None)
    gen = torch.Generator().manual_seed(5)
    tiny_trainer.sample_panoptic({"image": image}, gen, init_noise=noise,
                                 num_inference_steps=1, repeat_noise=True)
    gen = torch.Generator().manual_seed(5)
    tiny_trainer.sample_panoptic({"image": image}, gen, init_noise=noise,
                                 num_inference_steps=1)
    shared, own = seen
    assert not torch.equal(own[0], own[1])
    for i in range(3):
        assert torch.equal(shared[i], own[0])


def test_guidance_scale_changes_nothing_without_a_context(tiny_trainer):
    image = np.random.RandomState(2).randn(2, 32, 64, 3).astype(np.float32)
    noise = np.random.RandomState(3).randn(2, 4, 8, 4).astype(np.float32)
    a, xa = tiny_trainer.sample_panoptic({"image": image}, init_noise=noise,
                                         num_inference_steps=2)
    b, xb = tiny_trainer.sample_panoptic({"image": image}, init_noise=noise,
                                         num_inference_steps=2,
                                         guidance_scale=4.0)
    assert torch.equal(a, b) and torch.equal(xa, xb)


# ---------------------------------------------------------------------------
# ddim_sample's tmin and return_all
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("steps,tmin,self_condition", [
    (10, 0, False), (10, 450, True), (50, 990, True), (7, 0, True)])
def test_ddim_sample_tmin_and_trajectory_match_jax(steps, tmin,
                                                   self_condition):
    kw = CFG["noise_scheduler_kwargs"]
    rng = np.random.RandomState(steps + tmin)
    init = rng.randn(2, 4, 6, 4).astype(np.float32)
    a = rng.randn(4, 4).astype(np.float32) * 0.3

    def jmodel(latents, condition, t):
        base = latents @ jnp.asarray(a) * (t / 1000.0)
        return base if condition is None else base + 0.1 * condition

    def tmodel(latents, condition, t):
        x = latents.permute(0, 2, 3, 1)
        base = x @ torch.from_numpy(a) * (t / 1000.0)
        if condition is not None:
            base = base + 0.1 * condition.permute(0, 2, 3, 1)
        return base.permute(0, 3, 1, 2)
    ref_x0, ref_traj = jddim_sample(
        jddim.make_ddim_schedule(**kw), jmodel, jnp.asarray(init),
        num_inference_steps=steps, self_condition=self_condition, tmin=tmin,
        return_all=True)
    x0, traj = ddim_sample(
        ddim.make_ddim_schedule(**kw, device=CPU), tmodel,
        torch.from_numpy(init).permute(0, 3, 1, 2),
        num_inference_steps=steps, self_condition=self_condition, tmin=tmin,
        return_all=True)
    n = len(jddim.inference_timesteps(1000, steps, tmin=tmin))
    assert traj.shape == (n, 2, 4, 4, 6) and ref_traj.shape[0] == n
    # fp32, the toy model's products summed in another order: 1e-5 of
    # max|ref| (the trajectory grows to ~20)
    ref_traj = np.asarray(ref_traj)
    np.testing.assert_allclose(traj.permute(0, 1, 3, 4, 2).numpy(),
                               ref_traj, rtol=0,
                               atol=1e-5 * np.abs(ref_traj).max())
    np.testing.assert_allclose(x0.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref_x0), rtol=0,
                               atol=1e-5 * np.abs(ref_traj).max())
    only = ddim_sample(ddim.make_ddim_schedule(**kw, device=CPU), tmodel,
                       torch.from_numpy(init).permute(0, 3, 1, 2),
                       num_inference_steps=steps,
                       self_condition=self_condition, tmin=tmin)
    assert torch.equal(only, x0)
    np.testing.assert_array_equal(
        ddim.inference_timesteps(1000, steps, tmin=tmin),
        jddim.inference_timesteps(1000, steps, tmin=tmin))


# ---------------------------------------------------------------------------
# the bench line and the entry, where no card is
# ---------------------------------------------------------------------------
def test_bench_line_on_a_tiny_pipeline():
    """The bench line's measurement, ``measure_sampling``, on the tiny
    pipeline in both of its dtypes (the line itself needs the card)."""
    from ldmseg_torch.tools import bench
    tiny = merge_dicts(CFG, {"train_kwargs": {"self_condition": False}})
    for int8 in (False, True):
        trainer = TrainerDiffusion(
            merge_dicts(tiny, {"sampling_kwargs": {"int8_inference": int8}}),
            unet_config=UNetConfig(**dict(UNET_KW, in_channels=8)),
            device=CPU)
        trainer.init_params(seed=0)
        got = bench.measure_sampling(trainer, batch=2, steps=1, calls=2,
                                     warmup=0, image_hw=(32, 64))
        assert got["logits_shape"] == [2, 32, 64, CLASSES]
        assert len(got["s_each_call"]) == 2 and got["s_per_call"] == sum(
            got["s_each_call"]) / 2
        assert got["frames_per_s"] == 2 / got["s_per_call"] > 0
        assert got["peak_bytes"] is None
        # the kernels launch only on the card
        assert set(got["launches_per_call"].values()) == {0}
    # the full-width pipeline the command line runs
    full = bench.bench_config(True)
    assert full["sampling_kwargs"]["int8_inference"] is True
    assert full["model_kwargs"]["in_channels"] == 8
    assert full["vae_model_kwargs"]["out_channels"] == 128


def test_bench_and_entry_refuse_without_a_card(monkeypatch):
    from ldmseg_torch import entry
    from ldmseg_torch.tools import bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["bench"])
    assert bench.main() == 1
    with pytest.raises(RuntimeError, match="cuda"):
        entry.entry()
