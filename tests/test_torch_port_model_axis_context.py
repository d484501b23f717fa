"""The rest of serving on the model axis, on two gloo ranks of the port
(``tests/torch_dp_workers.py:serving``, a ``(data=1, model=2)`` mesh)
against one process of the port and the JAX package on the conftest's
virtual CPU devices:

  * the int8 image encoder and the int8 seg decoder alone under spatial
    parallelism (s8 convs with their halos and the whole image's dynamic
    scale, the ``lowp`` GroupNorm's all-reduced sums, the int8 upscalers)
    against one rank of the port and against JAX's modules under
    ``spatial_constraint`` on a ``(1, 2)`` mesh, at JAX's own bound
    (``tests/test_spatial_parallel.py:150-152``, rtol = atol = 1e-2);
  * a 2-step int8 ``sample_panoptic`` without fused norms (K13 with its
    dynamic q/k/v scales, K12 with its dynamic interior scale: the
    maximum over the group of each rank's amaxes), and without K12 too
    (the s8 linears, the row-parallel ``ff.net.2`` on its input's amax
    over the group; every scale dynamic), with tensor and spatial
    parallelism against the port's one-rank sample (2e-2 of max|x0|);
  * a 2-step guided ``sample_panoptic`` (CFG 7.5) with the ``none``
    descriptor on a UNet with ``encoder_hid_proj`` (a random context of a
    CLIP tower's width, 768; no tower is built) against JAX's trainer's
    ``_sample_decode_impl`` on its TP params on a ``(1, 2)`` mesh, x0 and
    logits within 2e-2 of their largest value (the bound of
    ``test_torch_port_model_axis_train.py``'s bf16 sample);
  * one training step with ``learnable`` queries on the mesh against
    ``_train_step_impl`` on JAX's TP params: the loss to 1e-4 relative and
    every gradient shard against its slice of JAX's gradient at JAX's TP
    bounds (rtol 5e-3, atol 5e-4), ``object_queries`` replicated.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")  # the JAX package builds on it
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models.descriptors import DescriptorSpec as JSpec  # noqa
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.parallel import apply_tp as japply_tp  # noqa: E402
from ldmseg_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from ldmseg_tpu.parallel.sp import spatial_constraint  # noqa: E402
from ldmseg_tpu.train.trainer_ldm import TrainerDiffusion as JTrainer  # noqa
from ldmseg_tpu.utils.config import DEFAULT_CONFIG as JAX_CONFIG  # noqa
from ldmseg_torch.data.synthetic import SyntheticDVPS  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models.image_vae import ImageVAE  # noqa: E402
from ldmseg_torch.models.seg_vae import SegVAE  # noqa: E402
from ldmseg_torch.models.unet import UNetConfig  # noqa: E402
from ldmseg_torch.ops.quant import prepare_int8_vae  # noqa: E402
from ldmseg_torch.parallel import tp  # noqa: E402
from ldmseg_torch.parallel.launch import run_ranks  # noqa: E402
from ldmseg_torch.parallel.mesh import Mesh  # noqa: E402
from ldmseg_torch.parallel.sp import model_axis  # noqa: E402
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts  # noqa

import torch_dp_workers as W  # noqa: E402
from test_torch_port_conditioning import XUNET_KW  # noqa: E402
from test_torch_port_sampling import CFG, UNET_KW, _random_params  # noqa

FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}
STEPS, B, HW, LATENT = 2, 2, (32, 64), (4, 8)
AXIS = {"tensor_parallel": True, "spatial_parallel": True}
UNFUSED = {"sampling_kwargs": {"int8_inference": True, "fused_norms": False,
                               "int8_attn_act_scale": None},
           "train_kwargs": {"batch_size": B}}
# without K12 too, every scale dynamic: the s8 linears around the gelu,
# ff.net.2 row-parallel (RowQuantLinear: its input's amax over the group)
UNFUSED_FF = merge_dicts(UNFUSED, {"sampling_kwargs": {
    "fused_ff": False, "int8_act_scale": None}})
GUIDED_KW = dict(XUNET_KW, encoder_hid_dim=768)
QUERIES_KW = dict(XUNET_KW, num_object_queries=4)
GUIDANCE = 7.5


def _cfg(base, *over):
    cfg = merge_dicts(base, {k: CFG[k] for k in (
        "vae_model_kwargs", "image_vae_kwargs", "train_kwargs",
        "ignore_label")})
    for o in over:
        cfg = merge_dicts(cfg, o)
    return cfg


def _jmesh():
    return jmake_mesh(num_data=1, num_model=2, devices=jax.devices()[:2])


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


def _seg_kw():
    vk = {k: v for k, v in CFG["vae_model_kwargs"].items()
          if k != "pretrained_path"}
    vk["block_out_channels"] = tuple(vk["block_out_channels"])
    return vk


def _jtrainer(kind, unet_kw, tmp):
    n = unet_kw.get("num_object_queries", 0)
    return JTrainer(_cfg(JAX_CONFIG, AXIS, {"train_kwargs": {
        "batch_size": B}}), unet_config=JUNetConfig(**unet_kw),
        mesh=_jmesh(), results_folder=tmp,
        descriptor=JSpec(kind=kind, use_cross_attention=True,
                         num_object_queries=n,
                         encoder_hid_dim=unet_kw.get("encoder_hid_dim", 0)))


class _GradState:
    """Stands in for the JAX TrainState: ``apply_gradients`` hands back the
    gradients."""

    def __init__(self, params):
        self.params = params

    def apply_gradients(self, grads):
        return grads


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("jax"))
    rng = np.random.RandomState(0)
    k = jax.random.split(jax.random.key(0), 5)
    # the models and draws
    jt_g = _jtrainer("none", GUIDED_KW, tmp)
    jt_q = _jtrainer("learnable", QUERIES_KW, tmp)
    ctx_w = GUIDED_KW["encoder_hid_dim"]
    ug = _random_params(lambda: jt_g.unet.init(
        k[0], jnp.zeros((1,) + LATENT + (12,)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 5, ctx_w))), 10)
    uq = _random_params(lambda: jt_q.unet.init(
        k[1], jnp.zeros((1,) + LATENT + (12,)), jnp.zeros((1,), jnp.int32),
        None), 11)
    ip = _random_params(lambda: jt_g.vae_img.init(
        k[2], jnp.zeros((1,) + HW + (3,)), method=JImageVAE.encode), 1)
    sp = _random_params(lambda: jt_g.vae_seg.init(
        {"params": k[3], "sample": k[3]}, jnp.zeros((1,) + HW + (10,)),
        sample_posterior=False), 2)
    ip, sp = jax.tree_util.tree_map(np.asarray, (ip, sp))
    ds = SyntheticDVPS(length=B, size=HW, num_bits=5)
    batch = {key: np.stack([ds[i][key] for i in range(B)])
             for key in ("image", "image_semseg", "semseg")}
    context = rng.randn(B, 5, ctx_w).astype(np.float32)
    guided_key, step_key = jax.random.key(7), jax.random.key(5)
    init = np.asarray(jax.random.normal(guided_key, (B,) + LATENT + (4,)))
    keys = jax.random.split(step_key, 10)  # the draws of _train_step_impl
    noise = np.asarray(jax.random.normal(keys[3], (B,) + LATENT + (4,)))
    timesteps = np.asarray(jax.random.randint(keys[4], (B,), 0, 1000))
    # the int8 VAEs alone: the port's modules from JAX's float trees
    ikw = dict(CFG["image_vae_kwargs"], decoder_enabled=False,
               use_fused_attention=True, use_int8=True)
    skw = dict(_seg_kw(), use_int8=True)
    rgb = rng.randn(B, 3, *HW).astype(np.float32)
    z = rng.randn(B, 4, *LATENT).astype(np.float32)
    vaes = {"image_kw": ikw, "seg_kw": skw, "dtype": torch.float32,
            "image_sd": convert.image_vae_state_dict_from_jax(ip),
            "seg_sd": convert.seg_vae_state_dict_from_jax(sp, skw),
            "rgb": torch.from_numpy(rgb), "z": torch.from_numpy(z)}
    spec = {"trainers": {"unfused": {"cfg": _cfg(DEFAULT_CONFIG, UNFUSED,
                                                 AXIS)},
                         "unfused_ff": {"cfg": _cfg(DEFAULT_CONFIG,
                                                    UNFUSED_FF, AXIS)}},
            "unet_kw": UNET_KW, "params": (up_plain(), ip, sp),
            "image": batch["image"], "init": init, "steps": STEPS,
            "vaes": vaes,
            "context": {
                "guided": {"cfg": _cfg(DEFAULT_CONFIG, AXIS),
                           "unet_kw": GUIDED_KW, "params": (ug, ip, sp),
                           "batch": {"image": batch["image"],
                                     "context": context},
                           "init": init, "steps": STEPS,
                           "guidance": GUIDANCE},
                "learnable": {"cfg": _cfg(DEFAULT_CONFIG, AXIS),
                              "unet_kw": QUERIES_KW, "params": (uq, ip, sp),
                              "batch": batch, "noise": noise,
                              "timesteps": timesteps}}}
    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(run_ranks, W.serving, 2, args=(spec,),
                              device="cpu", timeout_s=240)
        ref = _jax_refs(jt_g, jt_q, ug, uq, ip, sp, batch, context,
                        guided_key, step_key, ikw, skw, rgb, z)
        ranks = spawned.result()
    # one rank of the port
    one = {}
    for key, over in (("unfused", UNFUSED), ("unfused_ff", UNFUSED_FF)):
        tr = TrainerDiffusion(_cfg(DEFAULT_CONFIG, over),
                              unet_config=UNetConfig(**UNET_KW),
                              device="cpu")
        tr.load_jax_params(*spec["params"])
        tr._params_pretrained = False
        _, one[key] = tr.sample_panoptic(
            {"image": batch["image"]}, init_noise=init,
            num_inference_steps=STEPS)
    ivae, svae = ImageVAE(**ikw), SegVAE(**skw)
    ivae.load_state_dict(vaes["image_sd"])
    svae.load_state_dict(vaes["seg_sd"])
    with torch.no_grad():
        for m in (ivae, svae):
            prepare_int8_vae(m.eval())
        one_vaes = {"moments": ivae.quant_conv(ivae.encoder(vaes["rgb"])),
                    "logits": svae.decode(vaes["z"], True)}
    return {"ranks": ranks, "ref": ref, "one": dict(one, vaes=one_vaes)}


def up_plain():
    """The tiny UNet without a context (the unfused int8 sample's)."""
    from ldmseg_tpu.models.unet import UNet2DCondition as JUNet
    unet = JUNet(JUNetConfig(use_cross_attention=False, cond_channels=4,
                             **UNET_KW))
    return _random_params(lambda: unet.init(
        jax.random.key(0), jnp.zeros((1,) + LATENT + (12,)),
        jnp.zeros((1,), jnp.int32)), 0)


def _jax_refs(jt_g, jt_q, ug, uq, ip, sp, batch, context, guided_key,
              step_key, ikw, skw, rgb, z):
    """JAX's trainers' methods on their TP params on the ``(1, 2)`` mesh,
    and its int8 VAE modules under ``spatial_constraint``."""
    mesh = jt_g.mesh
    frozen = {"vae_img": ip, "vae_seg": sp}
    img = jnp.asarray(batch["image"])
    lat = jt_g._encode_rgb(frozen, img, guided_key)
    ctx = jnp.asarray(context)
    def placed(p):
        return japply_tp(mesh, jax.tree_util.tree_map(jnp.asarray, p))
    g_logits, g_x0 = _jit(
        lambda p, f, r, kk, c: jt_g._sample_decode_impl(
            p, f, r, kk, c, jnp.zeros_like(c), num_inference_steps=STEPS,
            guidance_scale=GUIDANCE), placed(ug), frozen, lat, guided_key,
        ctx)
    jt_q.frozen_params = frozen
    db = {key: jnp.asarray(v) for key, v in jt_q._device_batch(
        batch).items()}
    grads, metrics, _ = _jit(
        lambda p, f, b, kk: jt_q._train_step_impl(_GradState(p), f, b, kk),
        placed(uq), frozen, db, step_key)
    jivae, jsvae = JImageVAE(**ikw), JSegVAE(**skw)
    moments = _jit(lambda p, x: jivae.apply(
        p, spatial_constraint(x, mesh), method=JImageVAE.encode).mode(),
        ip, jnp.asarray(rgb.transpose(0, 2, 3, 1)))
    logits = _jit(lambda p, x: spatial_constraint(jsvae.apply(
        p, x, True, method=JSegVAE.decode), mesh), sp,
        jnp.asarray(z.transpose(0, 2, 3, 1)))
    return {"guided": (np.asarray(g_logits), np.asarray(g_x0)),
            "loss": float(metrics["loss"]),
            "grads": convert.unet_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, grads),
                UNetConfig(**QUERIES_KW)),
            "mode": np.asarray(moments), "seg_logits": np.asarray(logits)}


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_int8_vaes_under_sp_match_one_rank_and_jax(runs):
    one, ref = runs["one"]["vaes"], runs["ref"]
    for r in runs["ranks"]:
        v = r["vaes"]
        assert v["replicated"] == 0
        for key in ("moments", "logits"):
            want = one[key].float()
            err = float((v[key] - want).abs().max())
            assert err <= 1e-3 * float(want.abs().max()), (key, err)
        # the posterior's mode: the first half of the moments
        mode = v["moments"][:, :v["moments"].shape[1] // 2]
        np.testing.assert_allclose(_nhwc(mode), ref["mode"], rtol=1e-2,
                                   atol=1e-2)
        np.testing.assert_allclose(_nhwc(v["logits"]), ref["seg_logits"],
                                   rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("key", ["unfused", "unfused_ff"])
def test_unfused_int8_sample_on_the_mesh_matches_one_rank(runs, key):
    want = runs["one"][key].numpy()
    for r in runs["ranks"]:
        x0 = r[key]["x0"].numpy()
        assert np.abs(x0 - want).max() <= 2e-2 * np.abs(want).max()
        assert r[key]["replicated"] == 0


def test_guided_sample_with_a_context_matches_jax_tp(runs):
    ref_logits, ref_x0 = runs["ref"]["guided"]
    for r in runs["ranks"]:
        g = r["context"]["guided"]
        assert g["column_attn2"] and g["column_hid_proj"]
        for ours, ref in ((g["x0"], ref_x0), (g["logits"], ref_logits)):
            assert ours.shape == ref.shape
            assert np.abs(ours.numpy() - ref).max() <= \
                2e-2 * np.abs(ref).max()


@pytest.mark.parametrize("rank", [0, 1])
def test_learnable_train_step_matches_jax_tp(runs, rank):
    q = runs["ranks"][rank]["context"]["learnable"]
    ref = runs["ref"]
    np.testing.assert_allclose(q["loss"], ref["loss"], rtol=1e-4)
    lay = q["layout"]
    assert "object_queries.weight" not in lay
    assert any(".attn2.to_k." in n for n in lay)
    ax = model_axis(Mesh(model=2, model_rank=rank))
    assert q["grads"].keys() == ref["grads"].keys()
    for n, g in q["grads"].items():
        want = ref["grads"][n]
        if n in lay:
            want = tp.local_tensor(want, lay[n][0], ax, lay[n][1])
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=5e-3,
                                   atol=5e-4, err_msg=n)
