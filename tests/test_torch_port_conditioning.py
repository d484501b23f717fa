"""The port's conditioning and classifier-free guidance against the JAX
trainer on the CPU.

The tiny models of ``test_torch_port_sampling`` (its config: small VAEs,
self-conditioning, fp32) with a UNet that has cross-attention
(cross_attention_dim 16), the JAX weights drawn with numpy and adopted by
``load_jax_params``; the JAX trainer's own methods, jitted at XLA's lowest
CPU optimisation level, are the references:

- one train step with the ``none`` descriptor (a caller's context) and with
  ``learnable`` queries against ``_train_step_impl`` (a stand-in state hands
  back its gradients), with the noise and timesteps JAX drew from its key:
  the loss within 1e-4 relative, the UNet gradient's cosine with JAX's >=
  0.999 and every leaf within 1e-3 of the largest gradient;
- ``cfg_model_fn`` against JAX's, scale 1 calling the model once;
- a 2-step ``sample_panoptic`` with guidance 3.0 under DDIM and under
  DPM-Solver++(2M) against ``_sample_decode_impl`` with JAX's init noise:
  logits and x0 within 1e-3 * max(1, max|ref|) (the tolerance of
  ``sample_panoptic``'s test), two UNet calls a step, one at scale 1;
- int8 sampling with a context on random weights (the default scales)
  against the JAX trainer's int8 UNet on its ``_prequant`` tree, held to
  half the quantization's own effect (the yardstick of
  ``test_torch_port_int8``);
- the trait: JAX's calibration cannot run with a context descriptor, and
  the port's ``calibrate_int8`` refuses it by name.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models.descriptors import DescriptorSpec as JSpec  # noqa
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.models.convert import unet_state_dict_from_jax  # noqa
from ldmseg_torch.models.descriptors import DescriptorSpec  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_sampling import CFG as SAMPLING_CFG  # noqa: E402
from test_torch_port_sampling import _random_params  # noqa: E402

CPU = torch.device("cpu")
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
HW, LATENT = (32, 64), (4, 8)
STEPS = 2
XUNET_KW = dict(in_channels=12, out_channels=4, block_out_channels=(8, 16),
                attn_down=(True, False), layers_per_block=1,
                attention_head_dim=2, norm_num_groups=4,
                use_fused_attention=True, cross_attention_dim=16,
                use_cross_attention=True)
QUERIES = 4
CFG = merge_dicts(SAMPLING_CFG, {
    "train_kwargs": {"batch_size": 2},
    "sampling_kwargs": {"num_inference_steps": STEPS,
                        "guidance_scale": 3.0}})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


def _specs(kind):
    n = QUERIES if kind == "learnable" else 0
    return (JSpec(kind=kind, use_cross_attention=True, num_object_queries=n),
            DescriptorSpec(kind=kind, use_cross_attention=True,
                           num_object_queries=n))


def _unet_kw(kind):
    return dict(XUNET_KW, num_object_queries=QUERIES
                if kind == "learnable" else 0)


def jax_trainer(kind, cfg, tmp):
    from ldmseg_tpu.parallel import make_mesh
    from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer
    return JTrainer(cfg, unet_config=JUNetConfig(**_unet_kw(kind)),
                    mesh=make_mesh(devices=jax.devices()[:1]),
                    results_folder=tmp, descriptor=_specs(kind)[0])


def port_trainer(kind, cfg, params):
    up, ip, sp = params
    tr = TrainerDiffusion(cfg, unet_config=UNetConfig(**_unet_kw(kind)),
                          device=CPU, descriptor=_specs(kind)[1])
    tr.load_jax_params(up, ip, sp)
    # random weights: int8 keeps the default scales, as JAX's guard does
    tr._params_pretrained = False
    return tr


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The UNet trees (with a context, with queries), the VAE trees, a
    batch of two SyntheticDVPS frames with a context [2, 5, 16]."""
    tmp = str(tmp_path_factory.mktemp("jax"))
    jtr = jax_trainer("none", CFG, tmp)
    k = jax.random.split(jax.random.key(0), 4)
    unets = {}
    for i, kind in enumerate(("none", "learnable")):
        model = jax_trainer(kind, CFG, tmp).unet
        unets[kind] = _random_params(lambda: model.init(
            k[i], jnp.zeros((1,) + LATENT + (12,)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 5, 16))), 10 + i)
    ip = _random_params(lambda: jtr.vae_img.init(
        k[2], jnp.zeros((1,) + HW + (3,)), method=JImageVAE.encode), 1)
    sp = _random_params(lambda: jtr.vae_seg.init(
        {"params": k[3], "sample": k[3]}, jnp.zeros((1,) + HW + (10,)),
        sample_posterior=False), 2)
    ds = SyntheticDVPS(length=4, size=HW, num_bits=5)
    batch = {key: np.stack([ds[i][key] for i in range(2)])
             for key in ("image", "image_semseg", "semseg")}
    batch["context"] = np.random.RandomState(3).randn(2, 5, 16).astype(
        np.float32)
    return unets, ip, sp, batch, tmp


class _GradState:
    """Stands in for the JAX TrainState: ``apply_gradients`` hands back the
    gradients."""

    def __init__(self, params):
        self.params = params

    def apply_gradients(self, grads):
        return grads


def _flat(sd):
    return torch.cat([v.reshape(-1) for v in sd.values()])


@pytest.mark.parametrize("kind", ["none", "learnable"])
def test_train_step_with_a_descriptor_matches_jax(models, kind):
    unets, ip, sp, batch, tmp = models
    up = unets[kind]
    jtr = jax_trainer(kind, CFG, tmp)
    jtr.frozen_params = {"vae_img": ip, "vae_seg": sp}
    db = {k: jnp.asarray(v) for k, v in jtr._device_batch(batch).items()}
    assert ("context" in db) == (kind == "none")
    key = jax.random.key(5)
    grads, metrics, _ = _jit(
        lambda p, f, b, kk: jtr._train_step_impl(_GradState(p), f, b, kk),
        up, jtr.frozen_params, db, key)
    keys = jax.random.split(key, 10)  # the draws of _train_step_impl
    noise = np.asarray(jax.random.normal(keys[3], (2,) + LATENT + (4,)))
    timesteps = np.asarray(jax.random.randint(keys[4], (2,), 0, 1000))
    tr = port_trainer(kind, CFG, (up, ip, sp))
    ctx = tr.context(batch)
    assert (ctx is None) == (kind == "learnable")
    loss, _, _ = tr.forward_backward(batch, noise=noise,
                                     timesteps=timesteps)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                               rtol=1e-4)
    ref = unet_state_dict_from_jax(grads, tr.unet_config)
    named = dict(tr.unet.named_parameters())
    g = _flat({n: named[n].grad for n in ref})
    r = _flat(ref)
    cos = float(torch.dot(g, r) / (g.norm() * r.norm()))
    assert cos >= 0.999, cos
    assert float((g - r).abs().max()) <= 1e-3 * float(r.abs().max())
    # the context reaches attn2's to_k (a caller's, or the queries)
    k_grads = [p.grad for n, p in named.items() if ".attn2.to_k." in n]
    assert k_grads and all(float(x.abs().max()) > 0 for x in k_grads)
    if kind == "learnable":
        assert float(named["object_queries.weight"].grad.abs().max()) > 0


def test_cfg_model_fn_matches_jax():
    from ldmseg_tpu.diffusion.sampler import cfg_model_fn as jcfg
    from ldmseg_torch.diffusion.sampler import cfg_model_fn
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    calls = []

    def cond(lat, c, t):
        calls.append("cond")
        return lat * 2.0 + t

    def uncond(lat, c, t):
        calls.append("uncond")
        return lat * -1.0
    for scale in (3.0, 1.0, 7.5):
        ref = np.asarray(jcfg(cond, uncond, scale)(jnp.asarray(x), None, 1))
        calls.clear()
        out = cfg_model_fn(cond, uncond, scale)(torch.from_numpy(x), None, 1)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
        # scale 1 is the conditional model alone
        assert calls == (["cond"] if scale == 1.0 else ["cond", "uncond"])


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp_2m"])
def test_guided_sample_panoptic_matches_jax(models, sampler, monkeypatch):
    unets, ip, sp, batch, tmp = models
    up = unets["none"]
    cfg = merge_dicts(CFG, {"sampling_kwargs": {"sampler": sampler}})
    jtr = jax_trainer("none", cfg, tmp)
    frozen = {"vae_img": ip, "vae_seg": sp}
    key = jax.random.key(7)
    rgb = jtr._encode_rgb(frozen, jnp.asarray(batch["image"]), key)
    ctx = jnp.asarray(batch["context"])
    ref_logits, ref_x0 = _jit(
        lambda p, f, r, kk, c, u: jtr._sample_decode_impl(
            p, f, r, kk, c, u, num_inference_steps=STEPS,
            guidance_scale=3.0),
        up, frozen, rgb, key, ctx, jnp.zeros_like(ctx))
    init = np.asarray(jax.random.normal(key, (2,) + LATENT + (4,)))
    tr = port_trainer("none", cfg, (up, ip, sp))
    calls = []
    real = tr._unet_apply

    def counted(*args, **kw):
        calls.append(kw.get("context"))
        return real(*args, **kw)
    monkeypatch.setattr(tr, "_unet_apply", counted)
    logits, x0 = tr.sample_panoptic({"image": batch["image"],
                                     "context": batch["context"]},
                                    init_noise=init)
    # CFG: the conditional and the unconditional (zero) context each step
    assert len(calls) == 2 * STEPS
    assert all(float(c.abs().max()) == 0 for c in calls[1::2])
    for ours, ref in ((logits, ref_logits), (x0, ref_x0)):
        ref = np.asarray(ref)
        bound = 1e-3 * max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(ours.numpy() - ref).max())
        assert err <= bound, (err, bound)
    calls.clear()
    _, x0_one = tr.sample_panoptic({"image": batch["image"],
                                    "context": batch["context"]},
                                   init_noise=init, guidance_scale=1.0)
    assert len(calls) == STEPS
    assert not torch.allclose(x0_one, x0, atol=1e-4)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def test_int8_sampling_with_a_context_against_jax(models):
    """The int8 UNet (K3 -> attn2 in the compute dtype -> K4 a block) with
    a context on random weights, default scales, guidance 3.0."""
    unets, ip, sp, batch, tmp = models
    up = unets["none"]
    cfg = merge_dicts(CFG, {"sampling_kwargs": {"int8_inference": True}})
    jtr = jax_trainer("none", cfg, tmp)
    frozen = {"vae_img": ip, "vae_seg": sp}
    key = jax.random.key(9)
    rgb = jtr._encode_rgb(frozen, jnp.asarray(batch["image"]), key)
    ctx = jnp.asarray(batch["context"])
    init = np.asarray(jax.random.normal(key, (2,) + LATENT + (4,)))

    def jax_x0(params, int8):
        unet_infer = jtr.unet_infer
        if not int8:
            jtr.unet_infer = jtr.unet
        try:
            return np.asarray(_jit(
                lambda p, f, r, kk, c, u: jtr._sample_decode_impl(
                    p, f, r, kk, c, u, num_inference_steps=STEPS,
                    guidance_scale=3.0)[1],
                params, frozen, rgb, key, ctx, jnp.zeros_like(ctx)))
        finally:
            jtr.unet_infer = unet_infer
    x0_8 = jax_x0(jtr._prequant(up), True)
    x0_f = jax_x0(up, False)
    tr = port_trainer("none", cfg, (up, ip, sp))
    _, x0 = tr.sample_panoptic({"image": batch["image"],
                                "context": batch["context"]},
                               init_noise=init)
    blocks = [m for m in tr._unet_int8.modules()
              if type(m).__name__ == "BasicTransformerBlock"]
    assert blocks and all(b.fuse_attn and b.fuse_ff and b.cross
                          and b.attn2.to_k.weight.dtype == torch.float32
                          for b in blocks)
    quant_effect = _rel(x0_8, x0_f)
    assert quant_effect > 1e-3, "the int8 path changed nothing"
    err = _rel(x0.numpy(), x0_8)
    assert err <= 0.5 * quant_effect, (err, quant_effect)


def test_int8_calibration_with_a_context_is_refused(models):
    """The trait: JAX calibrates on a UNet forward without a context
    (trainer_ldm.py:1139-1141), where ``attn2`` falls back to
    self-attention and its context-sized ``to_k`` fails; the port's
    ``calibrate_int8`` (and so the auto-calibration of adopted weights)
    refuses a descriptor whose context comes from outside, by name."""
    from flax.errors import ScopeParamShapeError
    from ldmseg_tpu.ops import quant as jquant
    unets, ip, sp, batch, tmp = models
    up = unets["none"]
    cfg = merge_dicts(CFG, {"sampling_kwargs": {"int8_inference": True}})
    jtr = jax_trainer("none", cfg, tmp)
    inp = jnp.zeros((2,) + LATENT + (12,))
    with pytest.raises(ScopeParamShapeError, match="attn2/to_k"):
        jquant.calibrate_act_scale_tree(
            jtr.unet.apply, up, (inp, jnp.full((2,), 500, jnp.int32)))
    tr = port_trainer("none", cfg, (up, ip, sp))
    with pytest.raises(RuntimeError, match="without a context"):
        tr.calibrate_int8({"image": batch["image"]})
    tr._params_pretrained = True  # adopted weights auto-calibrate
    with pytest.raises(RuntimeError, match="'none' descriptor"):
        tr.sample_panoptic({"image": batch["image"],
                            "context": batch["context"]})
    # learnable queries live in the UNet: calibration runs
    tr = port_trainer("learnable", cfg, (unets["learnable"], ip, sp))
    scales = tr.calibrate_int8({"image": batch["image"]})
    assert scales and all(np.isfinite(v) and v > 0
                          for v in scales.values())
