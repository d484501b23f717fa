"""The port's stage-1 trainer against the JAX ``TrainerAE`` on the CPU.

One train step from the same parameters and batch, with the JAX step's
random draws (posterior noise, inpainting corruption, point coordinates)
made from its split keys and handed to the port: in fp32 (the loss within
1e-4 relative, every gradient within 1e-4 of its tensor's max, the
parameters after one AdamW step within 1e-5) and in bf16 (the loss within
1e-2 relative). Each dtype's JAX step is compiled once per module. Then the
port's own loop, evaluation, checkpoints and export, and the visualization
panels against the JAX package's, pixel for pixel.
"""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import optax  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from ldmseg_tpu.parallel import make_mesh  # noqa: E402
from ldmseg_tpu.train.trainer_ae import TrainerAE as JTrainerAE  # noqa
from ldmseg_tpu.utils import visualization as jvis  # noqa: E402
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.diffusion.ddim import make_ddim_schedule  # noqa: E402
from ldmseg_torch.train.trainer_ae import TrainerAE  # noqa: E402
from ldmseg_torch.utils import visualization as vis  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

jddim = importlib.import_module("ldmseg_tpu.diffusion.ddim")
CPU = torch.device("cpu")
VAE = dict(in_channels=4, int_channels=16, out_channels=8,
           block_out_channels=[8, 16, 16], latent_channels=4,
           norm_num_groups=4, num_upscalers=1, upscale_channels=16)
TRAIN = dict(batch_size=2, train_num_steps=4, clip_grad=1.0)
OVERRIDES = {
    "float32": {"train_kwargs": dict(TRAIN, prob_inpainting=0.6,
                                     latent_mask=True),
                "vae_model_kwargs": dict(VAE, fuse_rgb=True),
                "loss_weights": {"ce": 1.0, "mask": 0.5, "kl": 0.01}},
    "bfloat16": {"train_kwargs": dict(TRAIN, weight_dtype="bfloat16"),
                 "vae_model_kwargs": dict(VAE, num_mid_blocks=1),
                 "loss_weights": {"ce": 1.0, "mask": 1.0, "kl": 0.1}},
}
COMMON = {"ignore_label": 0, "lr_scheduler_name": "none",
          "optimizer_kwargs": {"lr": 1e-4, "weight_decay": 0.01},
          "loss_kwargs": {"num_points": 32, "max_masks": 6}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    several workers at once, and torch's default pool of every core in
    each of them costs more than it gains here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(base, dtype, **extra):
    return merge_dicts(merge_dicts(merge_dicts(base, COMMON),
                                   OVERRIDES[dtype]), extra)


def _batch(seed=0, b=2, size=16):
    rng = np.random.RandomState(seed)
    sem = rng.randint(0, 7, (b, size, size)).astype(np.int32)
    return {"image_semseg": rng.randint(0, 2, (b, size, size, 4)).astype(
                np.float32),
            "semseg": sem,
            "image": rng.randn(b, size, size, 3).astype(np.float32)}


def _draws(jtr, params, key, batch):
    """The numbers the JAX step draws from ``key`` (its own splits)."""
    k_sample, k_mask, k_points = jax.random.split(key, 3)
    b = batch["semseg"].shape[0]
    lat = batch["semseg"].shape[1] // jtr.vae.downsample_factor
    dt = jtr.compute_dtype
    # SegVAE draws from make_rng("sample"), a key Flax derives from k_sample
    k_noise = jtr.vae.apply(params,
                            method=lambda m: m.make_rng("sample"),
                            rngs={"sample": k_sample})
    noise = jax.random.normal(k_noise, (b, lat, lat, 4), dt)
    k1, k2 = jax.random.split(k_mask)
    corrupt = (np.asarray(jax.random.uniform(k1, (b, 1, 1))),
               np.asarray(jax.random.uniform(k2, (b, 32, 32))))
    cfg = jtr.loss_cfg
    points = {}
    for name, k, n in zip(("ce", "mask"), jax.random.split(k_points),
                          (b, b * cfg.max_masks)):
        ko, kr = jax.random.split(k)
        n_unc = int(cfg.importance_sample_ratio * cfg.num_points)
        points[name] = (
            np.asarray(jax.random.uniform(
                ko, (n, int(cfg.num_points * cfg.oversample_ratio), 2))),
            np.asarray(jax.random.uniform(kr, (n, cfg.num_points - n_unc,
                                               2))))
    return {"noise": torch.from_numpy(np.asarray(
                noise, np.float32).transpose(0, 3, 1, 2).copy()),
            "corrupt": corrupt, "points": points}


# XLA's CPU backend at its lowest optimisation level: the same values, a
# fraction of the compile time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _random_variables(model, batch, fuse_rgb, seed):
    """The Flax variables ``init`` would make, drawn with numpy (tracing
    the shapes is far cheaper than compiling ``init``)."""
    rng = np.random.RandomState(seed)
    x = batch["image_semseg"][:1]
    rgb = batch["image"][:1] if fuse_rgb else None
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "sample": jax.random.key(0)}, x,
        rgb_sample=rgb, sample_posterior=False))

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.randn(*leaf.shape).astype(np.float32) / fan_in**0.5
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def stepped(request, tmp_path_factory):
    """One JAX step and the port's from the same parameters and batch: in
    fp32 the loss, its parts, the gradients and the AdamW update (the JAX
    trainer's optax chain), in bf16 the loss and its parts."""
    dtype = request.param
    root = tmp_path_factory.mktemp(f"ae_{dtype}")
    jtr = JTrainerAE(_cfg(JAX_CONFIG, dtype),
                     mesh=make_mesh(devices=jax.devices()[:1]),
                     results_folder=str(root / "jax"))
    batch = _batch()
    params = _random_variables(jtr.vae, batch, jtr.fuse_rgb, 3)
    key = jax.random.key(5)
    out = dict(dtype=dtype, kw=_cfg(DEFAULT_CONFIG, dtype))
    if dtype == "float32":
        def step(p, batch, key):
            (loss, parts), grads = jax.value_and_grad(
                jtr._forward_loss, has_aux=True)(p, batch, key)
            updates, _ = jtr.tx.update(grads, jtr.tx.init(p), p)
            return loss, parts, grads, optax.apply_updates(p, updates)
        loss, parts, out["grads"], out["new"] = _compile(step, params, batch,
                                                         key)
    else:
        loss, parts = _compile(jtr._forward_loss, params, batch, key)
    out["metrics"] = dict(parts, loss=loss)
    tr = TrainerAE(out["kw"], device=CPU, results_folder=str(root / "port"))
    tr.load_jax_params(params)
    out["loss"], out["parts"] = tr.forward_loss(
        batch, draws=_draws(jtr, params, key, batch))
    out["loss"].backward()
    out["ours_grads"] = {n: p.grad.clone()
                         for n, p in tr.vae.named_parameters()}
    tr.state.apply_gradients()
    out["tr"] = tr
    return out


def test_train_step_loss_matches_jax(stepped):
    tol = 1e-4 if stepped["dtype"] == "float32" else 1e-2
    m = stepped["metrics"]
    np.testing.assert_allclose(stepped["loss"].item(), float(m["loss"]),
                               rtol=tol)
    for k in ("ce", "mask", "kl"):
        np.testing.assert_allclose(stepped["parts"][k].item(), float(m[k]),
                                   rtol=tol, atol=1e-6 if k == "kl" else 0)


def test_train_step_gradients_and_update_match_jax(stepped):
    if stepped["dtype"] != "float32":
        # bf16: its loss is held above; every gradient finite, non-zero
        for n, g in stepped["ours_grads"].items():
            assert torch.isfinite(g).all() and g.abs().max() > 0, n
        assert stepped["tr"].state.step == 1
        return
    from ldmseg_torch.models import convert
    kw = stepped["kw"]["vae_model_kwargs"]
    jgrads = convert.seg_vae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, stepped["grads"]), kw)
    jnew = convert.seg_vae_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, stepped["new"]), kw)
    for n, p in stepped["tr"].vae.named_parameters():
        g, ref = stepped["ours_grads"][n].numpy(), jgrads[n].numpy()
        bound = 1e-4 * max(float(np.abs(ref).max()), 1e-12)
        assert float(np.abs(g - ref).max()) <= bound, n
        np.testing.assert_allclose(p.detach().numpy(), jnew[n].numpy(),
                                   atol=1e-5, err_msg=n)
    assert stepped["tr"].state.step == 1


# ---------------------------------------------------------------------------
# the port's loop, evaluation, checkpoints and export (port only)
# ---------------------------------------------------------------------------
def _synthetic(length):
    return SyntheticDVPS(length=length, size=(16, 16), num_bits=2,
                         num_classes=4, ignore_label=0)


def test_train_loop_evaluates_saves_resumes_and_exports(tmp_path):
    cfg = merge_dicts(_cfg(DEFAULT_CONFIG, "float32"), {
        "train_kwargs": {"prob_inpainting": 0.0},
        "vae_model_kwargs": {"fuse_rgb": False}, "ema_on": True,
        "optimizer_name": "adafactor"})
    tr = TrainerAE(cfg, device=CPU, dataset=_synthetic(4),
                   val_dataset=_synthetic(2), results_folder=str(tmp_path))
    tr.init_params(seed=1)
    losses = tr.train_loop(max_steps=2, log_every=1, save_every=1,
                           vis_every=2, eval_every=2,
                           eval_kwargs={"max_batches": 1})
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_model", "metrics.jsonl", "rgb_gt_pred_ae_2.jpg", "step_1",
        "step_2"]
    res = tr.compute_metrics(max_batches=1)
    assert set(res) == {"miou", "pq"} and "mIoU" in res["miou"]
    assert Image.open(tmp_path / "rgb_gt_pred_ae_2.jpg").size == (16, 48)
    # resume into a fresh trainer: the same weights, EMA, moments and step
    back = TrainerAE(cfg, device=CPU, results_folder=str(tmp_path))
    back.init_params(seed=9)
    assert back.resume().endswith("step_2") and back.state.step == 2
    for a, b in zip(tr.vae.parameters(), back.vae.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(tr.state.ema_params, back.state.ema_params):
        assert torch.equal(a, b)
    assert back.state.optimizer.state_dict()["factored"].keys() == \
        tr.state.optimizer.state_dict()["factored"].keys()
    out = tr.export_reference(str(tmp_path / "ae.pt"), use_ema=True)
    data = torch.load(out, weights_only=True)
    assert data["step"] == 2
    sd = tr._eval_vae.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in data["vae"].items())


# ---------------------------------------------------------------------------
# the panels, pixel for pixel against the JAX package's
# ---------------------------------------------------------------------------
def test_panels_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    rgb = rng.randn(3, 10, 12, 3).astype(np.float32)
    gt = rng.randint(0, 9, (3, 10, 12))
    pred = rng.randint(0, 9, (3, 10, 12))
    inpaint = (rng.rand(3, 5, 6) > 0.5).astype(np.float32)
    pairs = [
        (vis.save_train_panel(str(tmp_path / "a.png"), rgb[0], gt[0],
                              pred[0]),
         jvis.save_train_panel(str(tmp_path / "ja.png"), rgb[0], gt[0],
                               pred[0])),
        (vis.save_val_overview(str(tmp_path / "b.png"), rgb, gt, pred,
                               inpainting=inpaint),
         jvis.save_val_overview(str(tmp_path / "jb.png"), rgb, gt, pred,
                                inpainting=inpaint)),
        (vis.save_val_overview(str(tmp_path / "c.png"), rgb, None, pred),
         jvis.save_val_overview(str(tmp_path / "jc.png"), rgb, None, pred)),
    ]
    bits = rng.randint(0, 2, (10, 12, 4)).astype(np.float32)
    kw = DEFAULT_CONFIG["noise_scheduler_kwargs"]
    noise = np.asarray(jax.random.normal(jax.random.key(4), (1, 10, 12, 4)))
    pairs.append((
        vis.noise_schedule_panel(str(tmp_path / "d.png"),
                                 make_ddim_schedule(**kw, device=CPU), bits,
                                 noise=noise),
        jvis.noise_schedule_panel(str(tmp_path / "jd.png"),
                                  jddim.make_ddim_schedule(**kw), bits,
                                  seed=4)))
    for ours, ref in pairs:
        np.testing.assert_array_equal(np.asarray(Image.open(ours)),
                                      np.asarray(Image.open(ref)))
