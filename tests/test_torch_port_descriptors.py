"""The port's conditioning descriptors against the JAX package on the CPU.

``get_image_descriptors``' specs and its refusals (a CLIP tower without
local weights raises JAX's ``ValueError``); then the CLIP towers, tiny and
random (a ``transformers`` config: hidden 16, one layer), built in Flax for
the JAX trainer and carried into ``transformers``' PyTorch models with
``load_flax_weights_in_pytorch_model``, as ``test_conditioning.py`` builds
them (the repo has no CLIP weights, so the towers run only here): one train
step with ``clip_text`` against ``_train_step_impl`` (the loss within 1e-4
relative, the gradient's cosine >= 0.999, every leaf within 1e-3 of the
largest); the ``clip_vision`` context (the antialiased resize to 224x224,
CLIP's statistics, the tower) and a 2-step guided ``sample_panoptic`` on
it through ``encoder_hid_proj`` against ``_context_impl`` and
``_sample_decode_impl`` within 1e-3 * max(1, max|ref|); a guided
``sample_panoptic_clip`` with tokens per clip against
``_sample_clip_impl``, and with the same tokens per frame equal to it; the
empty caption's embedding of the unconditional branch, computed once.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models import descriptors as jdesc  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.models import descriptors  # noqa: E402
from ldmseg_torch.models.convert import unet_state_dict_from_jax  # noqa
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402

from test_torch_port_conditioning import (  # noqa: E402
    CFG, CPU, HW, LATENT, STEPS, XUNET_KW, _GradState, _flat, _jit,
    _one_torch_thread)
from test_torch_port_sampling import _random_params  # noqa: E402

__all__ = ["_one_torch_thread"]
T = 3  # frames a clip
HIDDEN = 16  # the towers' width: the UNet's cross_attention_dim


@pytest.mark.parametrize("name", ["remove", "none", "learnable"])
def test_specs_match_jax(name):
    ours = descriptors.get_image_descriptors(name, num_queries=5)
    ref = jdesc.get_image_descriptors(name, num_queries=5)
    for field in ("kind", "use_cross_attention", "num_object_queries",
                  "encoder_hid_dim", "model", "tokenizer"):
        assert getattr(ours, field) == getattr(ref, field), field


@pytest.mark.parametrize("name,port_only", [
    ("clip", False), ("clipproj", False), ("text", False),
    ("clip_vision", True), ("clip_text", True)])
def test_clip_towers_need_local_weights(name, port_only):
    with pytest.raises(ValueError, match="need local pretrained weights"):
        descriptors.get_image_descriptors(name)
    if port_only:  # the kind's name, taken by the port only
        with pytest.raises(NotImplementedError):
            jdesc.get_image_descriptors(name)
    else:
        with pytest.raises(ValueError, match="need local pretrained"):
            jdesc.get_image_descriptors(name)
    with pytest.raises(NotImplementedError):
        descriptors.get_image_descriptors("bert")


class _Tokenizer:
    """A stand-in CLIP tokenizer (no vocabulary files here): each caption
    to 77 ids, its characters' codes mod the vocabulary, start 1, end 2,
    padding 0."""

    def __call__(self, texts, padding, max_length, truncation,
                 return_tensors):
        out = np.zeros((len(texts), max_length), np.int64)
        for i, s in enumerate(texts):
            ids = [1] + [3 + ord(c) % 60 for c in s][:max_length - 2] + [2]
            out[i, :len(ids)] = ids
        return {"input_ids": out}


@pytest.fixture(scope="module")
def towers():
    from transformers.modeling_flax_pytorch_utils import (
        load_flax_weights_in_pytorch_model)
    tc = transformers.CLIPTextConfig(
        vocab_size=64, hidden_size=HIDDEN, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=77)
    vc = transformers.CLIPVisionConfig(
        hidden_size=HIDDEN, intermediate_size=32, num_hidden_layers=1,
        num_attention_heads=2, image_size=224, patch_size=32)
    out = {}
    for seed, (kind, cfg, flax_cls, pt_cls, shape) in enumerate((
            ("clip_text", tc, transformers.FlaxCLIPTextModel,
             transformers.CLIPTextModel, (1, 77)),
            ("clip_vision", vc, transformers.FlaxCLIPVisionModel,
             transformers.CLIPVisionModel, (1, 224, 224, 3)))):
        fm = flax_cls(cfg, _do_init=False)
        # the parameters init would make, drawn with numpy (tracing the
        # shapes is far cheaper than running init); the model is called
        # with them, as the JAX trainer calls it with its frozen tree
        params = _random_params(lambda: fm.init_weights(
            jax.random.key(0), shape), 40 + seed)
        pm = load_flax_weights_in_pytorch_model(pt_cls(cfg), params)
        out[kind] = (fm, pm, params)
    return out


def _specs(kind, towers, tokenizer=None):
    fm, pm, _ = towers[kind]
    hid = HIDDEN if kind == "clip_vision" else 0
    return (jdesc.DescriptorSpec(kind=kind, use_cross_attention=True,
                                 encoder_hid_dim=hid, model=fm,
                                 tokenizer=tokenizer),
            descriptors.DescriptorSpec(kind=kind, use_cross_attention=True,
                                       encoder_hid_dim=hid, model=pm,
                                       tokenizer=tokenizer))


def _unet_kw(kind):
    return dict(XUNET_KW, encoder_hid_dim=HIDDEN
                if kind == "clip_vision" else 0)


@pytest.fixture(scope="module")
def models(towers, tmp_path_factory):
    from ldmseg_tpu.parallel import make_mesh
    from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer
    tmp = str(tmp_path_factory.mktemp("jax"))
    k = jax.random.split(jax.random.key(0), 4)
    jtrainers, unets = {}, {}
    for i, kind in enumerate(("clip_text", "clip_vision")):
        jtr = JTrainer(CFG, unet_config=JUNetConfig(**_unet_kw(kind)),
                       mesh=make_mesh(devices=jax.devices()[:1]),
                       results_folder=tmp,
                       descriptor=_specs(kind, towers)[0])
        unets[kind] = _random_params(lambda: jtr.unet.init(
            k[i], jnp.zeros((1,) + LATENT + (12,)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, HIDDEN))), 20 + i)
        jtrainers[kind] = jtr
    jtr = jtrainers["clip_text"]
    ip = _random_params(lambda: jtr.vae_img.init(
        k[2], jnp.zeros((1,) + HW + (3,)), method=JImageVAE.encode), 1)
    sp = _random_params(lambda: jtr.vae_seg.init(
        {"params": k[3], "sample": k[3]}, jnp.zeros((1,) + HW + (10,)),
        sample_posterior=False), 2)
    for kind, j in jtrainers.items():
        j.frozen_params = {"vae_img": ip, "vae_seg": sp,
                           "descriptor": towers[kind][2]}
    ds = SyntheticDVPS(length=4, size=HW, num_bits=5)
    batch = {key: np.stack([ds[i][key] for i in range(2)])
             for key in ("image", "image_semseg", "semseg")}
    batch["text_tokens"] = np.random.RandomState(4).randint(
        0, 64, (2, 77)).astype(np.int32)
    return jtrainers, unets, ip, sp, batch


def _port(kind, towers, models, cfg=CFG, tokenizer=None):
    _, unets, ip, sp, _ = models
    tr = TrainerDiffusion(cfg, unet_config=UNetConfig(**_unet_kw(kind)),
                          device=CPU,
                          descriptor=_specs(kind, towers, tokenizer)[1])
    tr.load_jax_params(unets[kind], ip, sp)
    return tr


def _close(ours, ref):
    ref = np.asarray(ref)
    bound = 1e-3 * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(ours) - ref).max())
    assert err <= bound, (err, bound)


def test_clip_text_train_step_matches_jax(towers, models):
    jtrainers, unets, ip, sp, batch = models
    jtr = jtrainers["clip_text"]
    db = {k: jnp.asarray(v) for k, v in jtr._device_batch(batch).items()}
    assert db["text_tokens"].shape == (2, 77)
    key = jax.random.key(5)
    grads, metrics, _ = _jit(
        lambda p, f, b, kk: jtr._train_step_impl(_GradState(p), f, b, kk),
        unets["clip_text"], jtr.frozen_params, db, key)
    keys = jax.random.split(key, 10)
    noise = np.asarray(jax.random.normal(keys[3], (2,) + LATENT + (4,)))
    timesteps = np.asarray(jax.random.randint(keys[4], (2,), 0, 1000))
    tr = _port("clip_text", towers, models)
    ctx = tr.context(batch)
    assert tuple(ctx.shape) == (2, 77, HIDDEN)
    ref_ctx = np.asarray(jtr._context(jtr.frozen_params, db))
    np.testing.assert_allclose(ctx.numpy(), ref_ctx, rtol=1e-4, atol=1e-4)
    loss, _, _ = tr.forward_backward(batch, noise=noise,
                                     timesteps=timesteps)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                               rtol=1e-4)
    ref = unet_state_dict_from_jax(grads, tr.unet_config)
    named = dict(tr.unet.named_parameters())
    g, r = _flat({n: named[n].grad for n in ref}), _flat(ref)
    assert float(torch.dot(g, r) / (g.norm() * r.norm())) >= 0.999
    assert float((g - r).abs().max()) <= 1e-3 * float(r.abs().max())
    # the tower is frozen
    assert all(p.grad is None and not p.requires_grad
               for p in tr.descriptor_model.parameters())


def test_clip_vision_context_and_guided_sample_match_jax(towers, models):
    jtrainers, unets, ip, sp, batch = models
    jtr = jtrainers["clip_vision"]
    image = jnp.asarray(batch["image"])
    ref_ctx = _jit(jtr._context_impl, jtr.frozen_params, {"image": image})
    tr = _port("clip_vision", towers, models)
    ctx = tr.context({"image": batch["image"]})
    assert tuple(ctx.shape) == (2, 50, HIDDEN)  # 49 patches + CLS
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), rtol=1e-4,
                               atol=1e-4)
    key = jax.random.key(8)
    frozen = jtr.frozen_params
    rgb = jtr._encode_rgb(frozen, image, key)
    ref_logits, ref_x0 = _jit(
        lambda p, f, r, kk, c, u: jtr._sample_decode_impl(
            p, f, r, kk, c, u, num_inference_steps=STEPS,
            guidance_scale=3.0),
        unets["clip_vision"], frozen, rgb, key, ref_ctx,
        jnp.zeros_like(ref_ctx))
    init = np.asarray(jax.random.normal(key, (2,) + LATENT + (4,)))
    logits, x0 = tr.sample_panoptic({"image": batch["image"]},
                                    init_noise=init)
    _close(logits.numpy(), ref_logits)
    _close(x0.numpy(), ref_x0)


def test_guided_clip_sampling_with_tokens_per_clip_and_per_frame(towers,
                                                                 models):
    from ldmseg_torch.data.video import ClipDataset
    jtrainers, unets, ip, sp, _ = models
    jtr = jtrainers["clip_text"]
    clips = ClipDataset(SyntheticDVPS(length=6, size=HW, num_bits=5,
                                      frames_per_scene=T), clip_len=T)
    image = np.stack([clips[0]["image"], clips[1]["image"]])  # [2, T, ...]
    toks = np.random.RandomState(6).randint(0, 64, (2, 77)).astype(np.int32)
    key = jax.random.key(3)
    # the JAX trainer's sample_panoptic_clip, composed: tokens repeated
    # over the flattened frames, the context, zeros unconditional
    flat_toks = jnp.asarray(np.repeat(toks, T, axis=0))
    ctx = jtr._context(jtr.frozen_params, {"text_tokens": flat_toks})
    ref_logits, ref_x0 = _jit(
        lambda p, f, b, kk, c, u: jtr._sample_clip_impl(
            p, f, b, kk, c, u, num_inference_steps=STEPS,
            repeat_noise=True, pose_warp=False, guidance_scale=3.0),
        unets["clip_text"], jtr.frozen_params, {"image": jnp.asarray(image)},
        key, ctx, jnp.zeros_like(ctx))
    k_init, _ = jax.random.split(key)
    init = np.asarray(jax.random.normal(k_init, (2, 1) + LATENT + (4,)))
    tr = _port("clip_text", towers, models)
    logits, x0 = tr.sample_panoptic_clip(
        {"image": image, "text_tokens": toks}, init_noise=init,
        pose_warp=False)
    assert tuple(x0.shape) == (2 * T,) + LATENT + (4,)
    _close(logits.numpy(), ref_logits)
    _close(x0.numpy(), ref_x0)
    _, x0_flat = tr.sample_panoptic_clip(
        {"image": image, "text_tokens": np.repeat(toks, T, axis=0)},
        init_noise=init, pose_warp=False)
    assert torch.equal(x0_flat, x0)


def test_empty_caption_embedding_is_computed_once(towers, models):
    """With a tokenizer the unconditional branch reads the empty caption's
    embedding (JAX :501-519), made once and broadcast; the port's equals
    JAX's."""
    jtrainers, _, _, _, batch = models
    jtr = jtrainers["clip_text"]
    jtr.descriptor.tokenizer = _Tokenizer()
    try:
        ctx = jnp.zeros((2, 77, HIDDEN))
        ref = np.asarray(jtr._uncond_context(ctx, jtr.frozen_params))
    finally:
        jtr.descriptor.tokenizer = None
        jtr._uncond_embed = None
    tr = _port("clip_text", towers, models, tokenizer=_Tokenizer())
    calls = []
    real = tr.descriptor_model.forward

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    tr.descriptor_model.forward = counted
    first = tr._uncond_context(torch.zeros(2, 77, HIDDEN))
    again = tr._uncond_context(torch.zeros(3, 77, HIDDEN))
    assert len(calls) == 1 and tuple(again.shape) == (3, 77, HIDDEN)
    np.testing.assert_allclose(first.numpy(), ref, rtol=1e-4, atol=1e-4)
    # captions are tokenized where a batch has no tokens
    ids = tr.tokenize(["a car", ""])
    assert ids.shape == (2, 77) and ids.dtype == np.int32
    got = tr.context({"image": batch["image"], "text": ["a car", ""]})
    torch.testing.assert_close(got[1], first[0])
