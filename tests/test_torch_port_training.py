"""The port's training slice against the JAX package on the CPU, in fp32.

Loss weights, the diffusion loss, the seg-VAE encoder, the optimizer chain,
the loss-mask modes and one whole train step of the tiny trainer
(``UNET_KW``/``CFG`` of ``test_torch_port_sampling.py``, self-conditioning
on). The JAX side of the train step is not the JAX trainer (its tests are
slow-marked for their compile cost): it composes the functions
``_train_step_impl`` runs, with the same weights, batch, noise and
timesteps. Tolerances are stated at each comparison.
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.diffusion import ddim as jddim  # noqa: E402
from ldmseg_tpu.losses.diffusion_losses import (  # noqa: E402
    diffusion_loss as jloss)
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import DiagonalGaussian as JGaussian  # noqa
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.models.unet import freeze_filter as jfreeze  # noqa: E402
from ldmseg_tpu.train import optim as joptim  # noqa: E402
from ldmseg_tpu.train.trainer_ldm import (  # noqa: E402
    TrainerDiffusion as JTrainer)
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.diffusion import ddim  # noqa: E402
from ldmseg_torch.losses.diffusion_losses import diffusion_loss  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.seg_vae import SegVAE  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.train import optim  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

from test_torch_port_sampling import (  # noqa: E402
    CFG, UNET_KW, _jax_unnormalize_to01, _random_params)

CPU = torch.device("cpu")
NOISE_KW = DEFAULT_CONFIG["noise_scheduler_kwargs"]
SVAE_KW = {k: v for k, v in CFG["vae_model_kwargs"].items()
           if k != "pretrained_path"}
SVAE_KW["block_out_channels"] = tuple(SVAE_KW["block_out_channels"])


def _close(out, ref, tol):
    """max |out - ref| <= tol * max(1, max|ref|)."""
    ref = np.asarray(ref, np.float32)
    bound = tol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def test_config_training_keys_are_the_jax_defaults():
    def walk(ours, theirs, path=""):
        for key, value in ours.items():
            assert key in theirs, path + key
            if isinstance(value, dict):
                walk(value, theirs[key], f"{path}{key}.")
            else:
                assert value == theirs[key], path + key
    walk(DEFAULT_CONFIG, JAX_CONFIG)
    for key in ("batch_size", "clip_grad", "freeze_layers", "accumulate"):
        assert key in DEFAULT_CONFIG["train_kwargs"]


# ---------------------------------------------------------------------------
# loss weights and the loss (exact numpy twins; the loss in fp32 to 1e-6)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ddim.LOSS_WEIGHT_MODES)
def test_loss_weights_match_jax(mode):
    kw = dict(NOISE_KW, weight=mode, max_snr=3.0)
    ours = ddim.make_ddim_schedule(**kw, device=CPU)
    ref = jddim.make_ddim_schedule(**kw)
    np.testing.assert_array_equal(ours.weights.numpy(),
                                  np.asarray(ref.weights))
    np.testing.assert_array_equal(
        ddim.compute_loss_weights(np.asarray(ref.alphas_cumprod), mode, 3.0),
        jddim.compute_loss_weights(np.asarray(ref.alphas_cumprod), mode,
                                   3.0))


@pytest.mark.parametrize("variant", ["plain", "mask_weights", "ohem"])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "smooth_l1"])
def test_diffusion_loss_matches_jax(loss_type, variant):
    rng = np.random.RandomState(7)
    pred = 1.5 * rng.randn(3, 6, 5, 4).astype(np.float32)  # NHWC
    target = rng.randn(3, 6, 5, 4).astype(np.float32)
    t = np.array([3, 500, 999])
    kw, tkw = {}, {}
    if variant != "plain":
        mask = (rng.rand(3, 6, 5) > 0.3).astype(np.float32)
        w = jddim.make_ddim_schedule(**dict(NOISE_KW, weight="max_clamp_snr"))
        kw = dict(timesteps=jnp.asarray(t), schedule_weights=w.weights,
                  loss_mask=jnp.asarray(mask))
        tkw = dict(timesteps=torch.from_numpy(t),
                   schedule_weights=torch.from_numpy(np.array(w.weights)),
                   loss_mask=torch.from_numpy(mask))
    ratio = 0.3 if variant == "ohem" else 1.0
    ref = jloss(jnp.asarray(pred), jnp.asarray(target), loss_type=loss_type,
                ohem_ratio=ratio, **kw)
    ours = diffusion_loss(_nchw(pred), _nchw(target), loss_type=loss_type,
                          ohem_ratio=ratio, **tkw)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


# ---------------------------------------------------------------------------
# the seg-VAE encoder at the dryrun widths (1e-4 * max(1, max|ref|), fp32)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def seg_vae():
    model = JSegVAE(**SVAE_KW)
    params = _random_params(lambda: model.init(
        {"params": jax.random.key(2), "sample": jax.random.key(3)},
        jnp.zeros((1, 32, 64, 10)), sample_posterior=False), 2)
    port = SegVAE(**SVAE_KW)
    port.load_state_dict(convert.seg_vae_state_dict_from_jax(params, SVAE_KW),
                         strict=True)
    return model, params, port


def test_seg_vae_encode_matches_jax(seg_vae):
    model, params, port = seg_vae
    rng = np.random.RandomState(8)
    bits = rng.randint(0, 2, (2, 32, 64, 10)).astype(np.float32) * 2 - 1

    @jax.jit
    def encode(p, x):
        post = model.apply(p, x, method=JSegVAE.encode)
        return post.mean, post.logvar, post.kl()

    mean, logvar, kl = encode(params, jnp.asarray(bits))
    with torch.no_grad():
        post = port.encode(_nchw(bits))
    assert post.mean.shape == (2, 4, 4, 8)
    _close(_nhwc(post.mode()), mean, 1e-4)
    _close(_nhwc(post.logvar), logvar, 1e-4)
    _close(post.kl().numpy(), kl, 1e-4)
    noise = rng.randn(2, 4, 8, 4).astype(np.float32)
    ref = JGaussian(mean, logvar)
    want = ref.mean + jnp.exp(0.5 * ref.logvar) * jnp.asarray(noise)
    _close(_nhwc(post.sample(noise=_nchw(noise))), want, 1e-4)


def test_seg_vae_encode_refuses_other_bottlenecks():
    # every JAX bottleneck is ported (tests/test_torch_port_stage1.py); an
    # unknown one still raises. The int8 decoder is ported: it keeps the
    # float decoder's parameters and, prepared, decodes (held against JAX
    # in tests/test_torch_port_vae_int8.py)
    with pytest.raises(NotImplementedError, match="vq"):
        SegVAE(**dict(SVAE_KW, parametrization="vq"))
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.ops.quant import prepare_int8_vae
    float_vae, int8_vae = SegVAE(**SVAE_KW), SegVAE(**dict(SVAE_KW,
                                                           use_int8=True))
    init_random_(float_vae, torch.Generator().manual_seed(0))
    int8_vae.load_state_dict(float_vae.state_dict(), strict=True)
    prepare_int8_vae(int8_vae)
    z = torch.randn(1, 4, 4, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out, ref = int8_vae.decode(z), float_vae.decode(z)
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert np.corrcoef(out.flatten().numpy(),
                       ref.flatten().numpy())[0, 1] > 0.99


# ---------------------------------------------------------------------------
# the optimizer chain on the tiny UNet's parameters
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unet_params():
    model = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                              **UNET_KW))
    return _random_params(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 4, 8, 12)),
        jnp.zeros((1,), jnp.int32)), 0)


def _port_keys(tree):
    """JAX leaf path -> the port's parameter name, through the converter:
    each leaf is filled with its own index."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    ids = jax.tree_util.tree_unflatten(treedef, [
        np.full(np.shape(leaf), i, np.float32)
        for i, (_, leaf) in enumerate(leaves)])
    sd = convert.unet_state_dict_from_jax(ids, UNetConfig(**UNET_KW))
    by_id = {int(v.reshape(-1)[0]): k for k, v in sd.items()}
    assert len(by_id) == len(leaves) == len(sd)
    return {path: by_id[i] for i, (path, _) in enumerate(leaves)}


def test_norm_bias_and_frozen_sets_match_jax(unet_params):
    keys = _port_keys(unet_params)
    for name, jfn, tfn in [
            ("norm", joptim.is_norm_param, optim.is_norm_param),
            ("bias", joptim.is_bias_param, optim.is_bias_param),
            ("frozen", jfreeze(("time_embedding",)),
             optim.freeze_filter(("time_embedding",))),
            ("frozen+norm", jfreeze(), optim.freeze_filter())]:
        ref = {keys[p] for p in keys if jfn(p)}
        ours = {k for k in keys.values() if tfn(k)}
        assert ours == ref, name
        assert ref, f"{name}: the case tests nothing"


@pytest.mark.parametrize("name", ["warmup", "cosine", "step", "none"])
def test_lr_schedules_match_jax(name):
    kw = dict(warmup_iters=5, final_lr=1e-6, step_size=7, gamma=0.5)
    ref = joptim.make_lr_schedule(name, 1e-3, 30, **kw)
    ours = optim.make_lr_schedule(name, 1e-3, 30, **kw)
    for step in range(32):
        # JAX evaluates in fp32: 1e-6 of the base lr
        np.testing.assert_allclose(ours(step), float(ref(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,schedule", [
    ("adamw", "warmup"), ("adamw", "cosine"), ("adam", "warmup"),
    ("sgd", "cosine")])
def test_optimizer_matches_optax(unet_params, name, schedule):
    # 3 steps with clipping active (norms ~ 30 > 1), weight decay on, norm
    # and bias overrides and the frozen time embedding; params agree to
    # float32 rounding (rtol 1e-5, atol 1e-7)
    keys = _port_keys(unet_params)
    flt = jfreeze(("time_embedding",))
    kw = dict(betas=(0.9, 0.99), weight_decay=0.1, weight_decay_norm=0.0,
              weight_decay_bias=0.05, clip_grad=1.0)
    tx = joptim.make_optimizer(
        name, learning_rate=joptim.make_lr_schedule(schedule, 1e-2, 10,
                                                    warmup_iters=2),
        lr_factor_fn=lambda p: 0.0 if flt(p) else 1.0, **kw)
    tflt = optim.freeze_filter(("time_embedding",))
    cfg = UNetConfig(**UNET_KW)
    sd = convert.unet_state_dict_from_jax(unet_params, cfg)
    named = [(k, torch.nn.Parameter(v.clone())) for k, v in sd.items()]
    opt = optim.Optimizer(
        named, name, learning_rate=optim.make_lr_schedule(
            schedule, 1e-2, 10, warmup_iters=2),
        lr_factor_fn=lambda n: 0.0 if tflt(n) else 1.0, **kw)

    params, state = unet_params, tx.init(unet_params)
    rng = np.random.RandomState(9)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: rng.randn(*np.shape(x)).astype(np.float32), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tgrads = convert.unet_state_dict_from_jax(grads, cfg)
        for k, p in named:
            p.grad = tgrads[k].clone()
        opt.step()
    assert opt.count == 3
    ref = convert.unet_state_dict_from_jax(params, cfg)
    frozen = [k for k in keys.values() if tflt(k)]
    assert frozen
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        if k in frozen:
            np.testing.assert_array_equal(p.detach().numpy(), sd[k].numpy())


def test_optimizer_refuses_adafactor():
    # Adafactor is ported (tests/test_torch_port_stage2_train.py holds it
    # against optax); an optimizer the JAX chain lacks still raises
    optim.Optimizer([("w", torch.nn.Parameter(torch.ones(2)))], "adafactor")
    with pytest.raises(NotImplementedError, match="adamw8bit"):
        optim.Optimizer([("w", torch.nn.Parameter(torch.ones(2)))],
                        "adamw8bit")


# ---------------------------------------------------------------------------
# the loss-mask modes against the JAX trainer's _loss_weight_mask (exact)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["ignore", "counts", "padding", "none"])
def test_loss_weight_mask_matches_jax(mode):
    rng = np.random.RandomState(10)
    batch = {"semseg": rng.randint(0, 6, (2, 30, 50)).astype(np.int32),
             "mask": (rng.rand(2, 30, 50) > 0.4).astype(np.uint8)}
    fake = types.SimpleNamespace(type_mask=mode, ignore_label=0,
                                 num_classes=6)
    ref = JTrainer._loss_weight_mask(
        fake, {k: jnp.asarray(v) for k, v in batch.items()}, (4, 7))
    trainer = TrainerDiffusion(
        merge_dicts(CFG, {"train_kwargs": {"type_mask": mode}}),
        unet_config=UNetConfig(**UNET_KW), device=CPU)
    trainer.num_classes = 6
    ours = trainer._loss_weight_mask(batch, (4, 7))
    if mode == "none":
        assert ours is None and ref is None
        return
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-7)


# ---------------------------------------------------------------------------
# one train step of the tiny trainer against a JAX composition
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def step_inputs(unet_params):
    ivae = JImageVAE(decoder_enabled=False, **CFG["image_vae_kwargs"])
    ip = _random_params(lambda: ivae.init(
        jax.random.key(1), jnp.zeros((1, 32, 64, 3)),
        method=JImageVAE.encode), 1)
    svae = JSegVAE(**SVAE_KW)
    sp = _random_params(lambda: svae.init(
        {"params": jax.random.key(2), "sample": jax.random.key(2)},
        jnp.zeros((1, 32, 64, 10)), sample_posterior=False), 2)
    ds = SyntheticDVPS(length=4, size=(32, 64), num_bits=5)
    batch = {k: np.stack([ds[i][k] for i in range(2)])
             for k in ("image", "image_semseg", "semseg")}
    rng = np.random.RandomState(11)
    noise = rng.randn(2, 4, 8, 4).astype(np.float32)
    timesteps = np.array([731, 42])
    return ivae, ip, svae, sp, batch, noise, timesteps


def _jax_step(unet_params, step_inputs):
    """loss and UNet gradients as ``_train_step_impl`` computes them."""
    ivae, ip, svae, sp, batch, noise, timesteps = step_inputs
    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **UNET_KW))
    sched = jddim.make_ddim_schedule(**CFG["noise_scheduler_kwargs"])
    fake = types.SimpleNamespace(type_mask="ignore", ignore_label=0,
                                 num_classes=24)

    @jax.jit
    def step(params, batch, noise, t):
        bits = 2.0 * batch["image_semseg"] - 1.0
        latents = svae.apply(sp, bits, method=JSegVAE.encode).mode() * 0.2
        rgb = 2.0 * _jax_unnormalize_to01(batch["image"]) - 1.0
        lat = ivae.apply(ip, rgb, method=JImageVAE.encode).mode() * 0.18215
        mask = JTrainer._loss_weight_mask(fake, batch, latents.shape[1:3])
        noisy = jddim.add_noise(sched, latents, noise, t)
        x = jnp.concatenate([noisy, lat, jnp.zeros_like(noisy)], axis=-1)
        pred0 = unet.apply(jax.lax.stop_gradient(params), x, t)
        cond = jax.lax.stop_gradient(
            jddim.remove_noise(sched, noisy, pred0, t))

        def loss_fn(p):
            x = jnp.concatenate([noisy, lat, cond], axis=-1)
            pred = unet.apply(p, x, t)
            return jloss(pred, noise, timesteps=t,
                         schedule_weights=sched.weights, loss_mask=mask)
        return jax.value_and_grad(loss_fn)(params)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return step(unet_params, jb, jnp.asarray(noise), jnp.asarray(timesteps))


def test_train_step_matches_jax(unet_params, step_inputs):
    # loss to 1e-5 relative; every UNet gradient leaf to 1e-4 of the largest
    # gradient (fp32 through two UNet passes, summed in another order)
    ivae, ip, svae, sp, batch, noise, timesteps = step_inputs
    ref_loss, ref_grads = _jax_step(unet_params, step_inputs)
    trainer = TrainerDiffusion(CFG, unet_config=UNetConfig(**UNET_KW),
                               device=CPU)
    trainer.load_jax_params(unet_params, ip, sp)
    loss, metrics, pred_x0 = trainer.forward_backward(
        batch, noise=noise, timesteps=timesteps)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert pred_x0.shape == (2, 4, 8, 4)
    assert float(metrics["timestep_mean"]) == float(timesteps.mean())
    ref = convert.unet_state_dict_from_jax(ref_grads, trainer.unet_config)
    attn = 0
    for name, p in trainer.unet.named_parameters():
        assert p.grad is not None, name
        scale = float(ref[name].abs().max())
        if name.endswith(("to_q.weight", "to_k.weight", "to_v.weight")):
            attn += 1
            assert scale > 0, name  # a zero gradient here is the K1 fault
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)
    assert attn > 0

    # the update: time_embedding frozen, everything else moves
    before = {n: p.detach().clone() for n, p in trainer.unet.named_parameters()}
    trainer.state.apply_gradients()
    assert trainer.state.step == 1
    for name, p in trainer.unet.named_parameters():
        assert p.grad is None, name
        moved = not torch.equal(p.detach(), before[name])
        assert moved != name.startswith("time_embedding"), name


def test_gradient_accumulation_steps_on_the_mean(step_inputs):
    ivae, ip, svae, sp, batch, noise, timesteps = step_inputs
    trainer = TrainerDiffusion(
        merge_dicts(CFG, {"train_kwargs": {"accumulate": 2}}),
        unet_config=UNetConfig(**UNET_KW), device=CPU)
    trainer.init_params(seed=1)
    w = trainer.unet.conv_out.weight
    before = w.detach().clone()
    trainer.train_step(batch, noise=noise, timesteps=timesteps)
    one = w.grad.clone()
    assert trainer.state.step == 0 and torch.equal(w.detach(), before)
    trainer.forward_backward(batch, noise=noise, timesteps=timesteps)
    torch.testing.assert_close(w.grad, 2 * one)  # summed in .grad
    trainer.state.apply_gradients()
    assert trainer.state.step == 1 and w.grad is None
    assert not torch.equal(w.detach(), before)


def test_train_loop_runs_on_the_cpu():
    ds = SyntheticDVPS(length=5, size=(32, 64), num_bits=5)
    cfg = merge_dicts(CFG, {"train_kwargs": {"batch_size": 2}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=torch.device"):
            TrainerDiffusion(cfg, unet_config=UNetConfig(**UNET_KW),
                             dataset=ds)
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(**UNET_KW),
                               device=CPU, dataset=ds)
    with pytest.raises(RuntimeError, match="init_params"):
        trainer.train_loop(max_steps=1)
    trainer.init_params(seed=0)
    losses = trainer.train_loop(max_steps=3, log_every=2)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert trainer.state.step == 3
