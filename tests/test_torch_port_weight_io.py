"""The port's reference weight I/O against the JAX package's
``torch_export`` and ``torch_import`` on the CPU, at tiny widths, on files
written from seeded random weights.

- ``export_reference`` (and ``export_reference_ldm``) equal to JAX's
  ``export_reference_ldm`` key for key, in order, and value for value, with
  and without EMA.
- A diffusers directory (``unet/`` with cross-attention, ``vae/`` with a
  decoder; ``.bin`` with the legacy VAE attention names, and
  ``.safetensors``), a reference stage-2 save dict and a stage-1
  ``{'vae': ...}`` dict: loaded through JAX's ``torch_import`` and through
  the port's, the state dicts equal (through ``convert.py``) bit for bit,
  and the UNet, image-VAE and seg-VAE outputs within 1e-4 of max(1,
  max|ref|) (fp32 in two frameworks).
- The safetensors parser against the ``safetensors`` package; the widened
  ``conv_in`` against JAX's ``expand_conv_in``.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
safetensors_numpy = pytest.importorskip("safetensors.numpy")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models import torch_export as jexport  # noqa: E402
from ldmseg_tpu.models import torch_import as jimport  # noqa: E402
from ldmseg_tpu.models.image_vae import ImageVAE as JImageVAE  # noqa: E402
from ldmseg_tpu.models.seg_vae import SegVAE as JSegVAE  # noqa: E402
from ldmseg_tpu.models.unet import UNet2DCondition as JUNet  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.models.unet import expand_conv_in as jexpand  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models import torch_export as export  # noqa: E402
from ldmseg_torch.models import torch_import as timport  # noqa: E402
from ldmseg_torch.models.image_vae import ImageVAE  # noqa: E402
from ldmseg_torch.models.seg_vae import SegVAE  # noqa: E402
from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig  # noqa
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion  # noqa: E402
from ldmseg_torch.utils.config import merge_dicts  # noqa: E402

from test_torch_port_sampling import CFG, UNET_KW, _random_params  # noqa

CPU = torch.device("cpu")
IVK = CFG["image_vae_kwargs"]
VK = {k: v for k, v in CFG["vae_model_kwargs"].items()
      if k != "pretrained_path"}
VK["block_out_channels"] = tuple(VK["block_out_channels"])
SEG = dict(block_out_channels=VK["block_out_channels"],
           num_upscalers=VK["num_upscalers"])
TOL = 1e-4


def _jcfg(in_channels, xattn=False):
    kw = dict(UNET_KW, in_channels=in_channels)
    kw.pop("use_fused_attention")
    return JUNetConfig(use_cross_attention=xattn, cross_attention_dim=16,
                       cond_channels=max(in_channels - 8, 0), **kw)


def _unet_tree(in_channels, xattn=False, seed=0):
    junet = JUNet(_jcfg(in_channels, xattn))
    args = [jnp.zeros((1, 4, 8, in_channels)), jnp.zeros((1,), jnp.int32)]
    if xattn:
        args.append(jnp.zeros((1, 3, 16)))
    return _random_params(lambda: junet.init(jax.random.key(0), *args), seed)


def _vae_trees(decoder=False):
    ivae = JImageVAE(decoder_enabled=decoder, **IVK)
    ip = _random_params(lambda: ivae.init(
        jax.random.key(1), jnp.zeros((1, 32, 64, 3)),
        **({} if decoder else {"method": JImageVAE.encode})), 1)
    svae = JSegVAE(**VK)
    sp = _random_params(lambda: svae.init(
        {"params": jax.random.key(2), "sample": jax.random.key(2)},
        jnp.zeros((1, 32, 64, 10)), sample_posterior=False), 2)
    return ip, sp


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    bound = TOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


def _sd_equal(ours, ref):
    assert list(ours) == list(ref)
    for k in ref:
        assert torch.equal(ours[k], torch.as_tensor(np.asarray(ref[k]))), k


def _same_outputs(unet_tree, unet_sd, ip, img_sd, sp, seg_sd, in_channels):
    """JAX models on the JAX-loaded trees vs the port's on its own."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 4, 8, in_channels).astype(np.float32)
    t = np.array([999, 10])
    ref = JUNet(_jcfg(in_channels)).apply(unet_tree, jnp.asarray(x),
                                          jnp.asarray(t))
    unet = UNet2DCondition(UNetConfig(**dict(UNET_KW,
                                             in_channels=in_channels)))
    unet.load_state_dict(unet_sd)
    with torch.no_grad():
        out = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t))
    _close(out.permute(0, 2, 3, 1).numpy(), ref)

    rgb = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    ref = JImageVAE(**IVK).apply(ip, jnp.asarray(rgb),
                                 method=JImageVAE.encode).mode()
    vae = ImageVAE(**IVK)
    vae.load_state_dict(img_sd)
    with torch.no_grad():
        out = vae.encode(torch.from_numpy(rgb).permute(0, 3, 1, 2)).mode()
    _close(out.permute(0, 2, 3, 1).numpy(), ref)

    z = rng.randn(2, 8, 16, 4).astype(np.float32)
    ref = JSegVAE(**VK).apply(sp, jnp.asarray(z), True,
                              method=JSegVAE.decode)
    seg = SegVAE(**VK)
    seg.load_state_dict(seg_sd)
    with torch.no_grad():
        out = seg.decode(torch.from_numpy(z).permute(0, 3, 1, 2), True)
    _close(out.permute(0, 2, 3, 1).numpy(), ref)


def _payloads_equal(ours, ref):
    assert ours.keys() == ref.keys()
    assert (ours["step"], ours["epoch"]) == (ref["step"], ref["epoch"])
    for part in ("unet", "vae_image", "vae_semseg"):
        _sd_equal(ours[part], ref[part])
        assert all(v.dtype == torch.float32 for v in ours[part].values())
    if "ema" in ref:
        a, b = ours["ema"]["shadow_params"], ref["ema"]["shadow_params"]
        assert len(a) == len(b) == len(ref["unet"])
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("with_ema", [False, True])
def test_export_equals_jax_export(tmp_path, with_ema):
    up = _unet_tree(12)
    ip, sp = _vae_trees()
    cfg = merge_dicts(CFG, {"ema_on": with_ema})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(**UNET_KW),
                               device=CPU)
    trainer.load_jax_params(up, ip, sp)
    trainer.state.step = 7
    ours, ref = str(tmp_path / "ours.pt"), str(tmp_path / "ref.pt")
    trainer.export_reference(ours, use_ema=True)
    jexport.export_reference_ldm(ref, up, ip, sp, _jcfg(12), **SEG,
                                 ema_params=up if with_ema else None, step=7)
    _payloads_equal(torch.load(ours, weights_only=True),
                    torch.load(ref, weights_only=False))
    # an EMA apart from the masters, through export_reference_ldm
    ema = jax.tree_util.tree_map(lambda x: x * 0.5 + 0.25, up)
    conv = UNetConfig(**UNET_KW)
    export.export_reference_ldm(
        ours, convert.unet_state_dict_from_jax(up, conv),
        convert.image_vae_state_dict_from_jax(ip),
        convert.seg_vae_state_dict_from_jax(sp, VK), conv, **SEG,
        ema=convert.unet_state_dict_from_jax(ema, conv) if with_ema
        else None, step=3, epoch=2)
    jexport.export_reference_ldm(ref, up, ip, sp, _jcfg(12), **SEG,
                                 ema_params=ema if with_ema else None,
                                 step=3, epoch=2)
    _payloads_equal(torch.load(ours, weights_only=True),
                    torch.load(ref, weights_only=False))


def _write_diffusers(root, fmt):
    """A diffusers SD-style directory at tiny widths: a 4-channel UNet with
    cross-attention and an AutoencoderKL with its decoder."""
    up = _unet_tree(4, xattn=True, seed=3)
    ip, _ = _vae_trees(decoder=True)
    usd = jexport.unet_sd_from_params(up, _jcfg(4, xattn=True))
    vsd = jexport.image_vae_sd_from_params(ip, decoder_enabled=True)
    assert any(".attn2." in k for k in usd)
    assert any(k.startswith("decoder.") for k in vsd)
    if fmt == "bin":  # the legacy attention names
        legacy = {".to_q.": ".query.", ".to_k.": ".key.",
                  ".to_v.": ".value.", ".to_out.0.": ".proj_attn."}
        renamed = {}
        for k, v in vsd.items():
            if ".attentions." in k:
                for new, old in legacy.items():
                    k = k.replace(new, old)
            renamed[k] = v
        vsd = renamed
    for sub, sd in (("unet", usd), ("vae", vsd)):
        os.makedirs(os.path.join(root, sub))
        path = os.path.join(root, sub, f"diffusion_pytorch_model.{fmt}")
        arrays = {k: np.ascontiguousarray(v, np.float32)
                  for k, v in sd.items()}
        if fmt == "bin":
            torch.save({k: torch.from_numpy(v) for k, v in arrays.items()},
                       path)
        else:
            safetensors_numpy.save_file(arrays, path)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_diffusers_directory_loads_as_jax_loads_it(tmp_path, fmt):
    _write_diffusers(str(tmp_path), fmt)
    cfg = UNetConfig(**dict(UNET_KW, in_channels=4))
    jtree = jimport.load_diffusers_unet(str(tmp_path), _jcfg(4))
    usd = timport.load_diffusers_unet(str(tmp_path), cfg)
    _sd_equal(usd, convert.unet_state_dict_from_jax(jtree, cfg))
    jip = jimport.load_diffusers_vae(str(tmp_path), decoder_enabled=False)
    isd = timport.load_diffusers_vae(str(tmp_path))
    ref = convert.image_vae_state_dict_from_jax(jip)
    assert set(isd) == set(ref)
    for k in ref:
        assert torch.equal(isd[k], ref[k]), k
    _, sp = _vae_trees()
    _same_outputs(jtree, usd, jip, isd, sp,
                  convert.seg_vae_state_dict_from_jax(sp, VK), 4)
    # the decoder keys too, as JAX's loader reads them
    jfull = jimport.load_diffusers_vae(str(tmp_path), decoder_enabled=True)
    full = timport.load_diffusers_vae(str(tmp_path), decoder_enabled=True)
    ref = convert.image_vae_state_dict_from_jax(jfull)
    want = jexport.image_vae_sd_from_params(jfull, decoder_enabled=True)
    assert list(full) == list(want) and set(full) == set(ref)
    assert any(k.startswith("decoder.") for k in full)
    for k in ref:
        assert torch.equal(full[k], ref[k]), k
    ImageVAE(decoder_enabled=True, **IVK).load_state_dict(full, strict=True)


def test_reference_save_dicts_load_as_jax_loads_them(tmp_path):
    up = _unet_tree(12, seed=5)
    ema = jax.tree_util.tree_map(lambda x: x - 0.1, up)
    ip, sp = _vae_trees()
    path = str(tmp_path / "ldm.pt")
    jexport.export_reference_ldm(path, up, ip, sp, _jcfg(12), **SEG,
                                 ema_params=ema, step=11)
    ref = jimport.load_reference_ldm(path, _jcfg(12), **SEG)
    ours = timport.load_reference_ldm(path, UNetConfig(**UNET_KW), **SEG)
    conv = UNetConfig(**UNET_KW)
    assert ours["step"] == ref["step"] == 11
    _sd_equal(ours["unet"], convert.unet_state_dict_from_jax(ref["unet"],
                                                             conv))
    _sd_equal(ours["ema"], convert.unet_state_dict_from_jax(ref["ema"],
                                                            conv))
    _sd_equal(ours["vae_semseg"], convert.seg_vae_state_dict_from_jax(
        ref["vae_semseg"], VK))
    img = convert.image_vae_state_dict_from_jax(ref["vae_image"])
    for k in img:
        assert torch.equal(ours["vae_image"][k], img[k]), k
    _same_outputs(ref["ema"], ours["ema"], ref["vae_image"],
                  ours["vae_image"], ref["vae_semseg"], ours["vae_semseg"],
                  12)
    # stage 1: {'vae': ...} with the DDP prefixes
    seg = jexport.seg_vae_sd_from_params(sp, **SEG)
    stage1 = str(tmp_path / "vae.pt")
    torch.save({"vae": {f"module.{k}": torch.from_numpy(np.array(v))
                        for k, v in seg.items()}}, stage1)
    _sd_equal(timport.load_reference_seg_vae(stage1, **SEG),
              convert.seg_vae_state_dict_from_jax(
                  jimport.load_reference_seg_vae(stage1, **SEG), VK))


def test_safetensors_parser_matches_the_package(tmp_path):
    import safetensors.torch as st
    rng = np.random.RandomState(0)
    tensors = {
        "f32": torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
        "f16": torch.from_numpy(rng.randn(7).astype(np.float16)),
        "bf16": torch.from_numpy(rng.randn(2, 2, 3).astype(
            np.float32)).to(torch.bfloat16),
        "i64": torch.arange(6).reshape(2, 3),
        "u8": torch.arange(9, dtype=torch.uint8),
        "b": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    ours = timport.read_safetensors(path)
    ref = st.load_file(path)
    assert ours.keys() == ref.keys() == tensors.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k],
                                                             ref[k]), k


@pytest.mark.parametrize("seg,image,cond,mode_cond", [
    ("copy", "zero", 0, "zero"), ("div", "mean", 4, "copy"),
    ("random", "random", 4, "random")])
def test_expand_conv_in_matches_jax(seg, image, cond, mode_cond):
    up = _unet_tree(4, seed=9)
    sd = convert.unet_state_dict_from_jax(
        up, UNetConfig(**dict(UNET_KW, in_channels=4)))
    ref = jexpand(up, init_mode_seg=seg, init_mode_image=image,
                  cond_channels=cond, init_mode_cond=mode_cond, seed=3)
    ours = timport.expand_conv_in(sd, seg, image, cond, mode_cond, seed=3)
    want = convert.unet_state_dict_from_jax(
        ref, UNetConfig(**dict(UNET_KW, in_channels=8 + cond)))
    assert ours["conv_in.weight"].shape[1] == 8 + cond
    assert torch.equal(ours["conv_in.weight"], want["conv_in.weight"])
    assert torch.equal(ours["conv_in.bias"], sd["conv_in.bias"])
