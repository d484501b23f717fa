"""Rules of the PyTorch port that need no JAX, and its tests on the card.

This file imports no JAX, so that the ``gpu`` tests run on a machine that
has none:

    python -m pytest --noconftest -m gpu tests/test_torch_port_*.py

(the other ``test_torch_port_*`` files skip themselves there). A ``gpu``
test decides inside the ``cuda`` fixture whether a card is present and skips
without one.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

from ldmseg_torch.ops import attention as A
from ldmseg_torch.ops import attention_s8 as K3
from ldmseg_torch.ops import attention_s8 as K13
from ldmseg_torch.ops import geglu as K4
from ldmseg_torch.ops import geglu as K12
from ldmseg_torch.ops.quant import QuantConv2d
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "ldmseg_tpu")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "ldmseg_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imported_roots(f) if name in FORBIDDEN]
    assert bad == []


# the training slice's modules, one case each
TRAINING_MODULES = [
    "data", "data.transforms", "data.mask_generator", "data.synthetic",
    "data.collate", "data.loader", "losses", "losses.diffusion_losses",
    "train.optim", "train.state", "train.trainer_ldm",
    "tools.profile_training"]


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []
    importlib.import_module(f"ldmseg_torch.{module}")


# the int8 sampling slice's modules, one case each
INT8_MODULES = ["ops.quant", "ops.attention_s8", "ops.geglu", "models.unet",
                "models.layers", "tools.profile_sampling"]


@pytest.mark.parametrize("module", INT8_MODULES)
def test_int8_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []
    importlib.import_module(f"ldmseg_torch.{module}")


def test_int8_sources_are_built_by_the_port():
    from ldmseg_torch.ops import _build
    assert {"attention_ln_s8", "geglu_ln_s8"} <= set(_build.sources())


# the unfused int8 slice's modules (K13, K12, QuantLinear), one case each
UNFUSED_INT8_MODULES = ["ops.attention_s8", "ops.geglu", "ops.quant",
                        "models.unet", "train.trainer_ldm",
                        "tools.profile_sampling"]


@pytest.mark.parametrize("module", UNFUSED_INT8_MODULES)
def test_unfused_int8_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []
    importlib.import_module(f"ldmseg_torch.{module}")


def test_unfused_int8_sources_are_built_by_the_port():
    from ldmseg_torch.ops import _build
    assert "attention_s8" in _build.sources()
    k12 = (ROOT / "ldmseg_torch/csrc/geglu_ln_s8.cu").read_text()
    assert 'extern "C" int ldmseg_geglu_s8(' in k12


def test_importing_the_training_slice_loads_no_jax():
    # a fresh interpreter: other tests of this process may have loaded JAX
    code = ("import sys; "
            + "; ".join(f"import ldmseg_torch.{m}" for m in TRAINING_MODULES)
            + f"; bad = {{m.split('.')[0] for m in sys.modules}}"
            f" & {set(FORBIDDEN)!r}; print(bad, file=sys.stderr)"
            "; sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_trainer_runs_on_cuda_unless_told_otherwise():
    cfg = merge_dicts(DEFAULT_CONFIG, {"train_kwargs": {
        "self_condition": True}})
    if torch.cuda.is_available():
        assert TrainerDiffusion(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device=torch.device"):
            TrainerDiffusion(cfg)
    trainer = TrainerDiffusion(cfg, device=torch.device("cpu"))
    assert trainer.device.type == "cpu"
    assert trainer.unet_config.in_channels == 12  # 8 + 4 self-condition
    with pytest.raises(RuntimeError, match="init_params"):
        trainer.sample_panoptic({"image": torch.zeros(1, 32, 32, 3)})


# the cases of test_trainer_names_what_is_not_ported that the trainer now
# takes, each with what it builds (held against JAX in test_torch_port_dpm,
# test_torch_port_vae_int8, test_torch_port_clip_train)
NOW_PORTED = {
    # the clip path (test_torch_port_clip_train, test_torch_port_video_cli)
    "video clips": lambda t: t.p["train_kwargs"]["video_clips"] == 3,
    "pose": lambda t: (t.temporal_consistency_weight == 0.1
                       and t.pose_model is None),
    "DPM-Solver": lambda t: t.sampler == "dpmpp_2m",
    "int8 seg-VAE": lambda t: isinstance(t.vae_seg.decoder[0], QuantConv2d),
    "decoder": lambda t: t.vae_img.decoder_enabled,
    # conditioning and the UNet surgery (test_torch_port_unet_surgery,
    # test_torch_port_conditioning, test_torch_port_descriptors)
    "separate": lambda t: (t.unet_config.separate_conv
                           and hasattr(t.unet, "conv_in_seg")),
    "separate image": lambda t: (t.unet_config.separate_encoder
                                 and hasattr(t.unet, "down_blocks_img")),
    "adaptors": lambda t: t.unet_config.add_adaptor,
    "learnable": lambda t: (t.descriptor.kind == "learnable"
                            and t.unet_config.num_object_queries == 77
                            and t.unet_config.use_cross_attention),
    "none": lambda t: (t.descriptor.kind == "none"
                       and t.unet_config.use_cross_attention
                       and t.guidance_scale == 7.5),
    # data parallelism (test_torch_port_parallel, test_torch_port_dp_train):
    # ZeRO-1 is honoured; TP and SP act as JAX's on a mesh without a model
    # axis (none here: no effect), and take effect with one
    # (test_torch_port_parallel::
    # test_model_axis_options_refused_with_a_model_axis, test_torch_port_tp,
    # test_torch_port_sp, test_torch_port_model_axis_train)
    "ZeRO": lambda t: t.zero1 and t.mesh.shape == {"data": 1, "model": 1},
    "tensor parallel": lambda t: (t.mesh.model == 1
                                  and not t.tensor_parallel),
    "spatial parallel": lambda t: (t.mesh.model == 1
                                   and not t.spatial_parallel),
}


@pytest.mark.parametrize("override,named", [
    # JAX's "need local pretrained weights" ValueError: no CLIP weights
    ({"train_kwargs": {"image_descriptors": "clip_text"}}, "descriptors"),
    ({"sampling_kwargs": {"sampler": "dpmpp_2m"}}, "DPM-Solver"),
    ({"wandb": True}, "wandb"),
    ({"model_kwargs": {"separate_conv": True}}, "separate"),
    ({"model_kwargs": {"separate_encoder": True}}, "separate image"),
    ({"model_kwargs": {"add_adaptor": True}}, "adaptors"),
    ({"train_kwargs": {"video_clips": 3}}, "video clips"),
    ({"train_kwargs": {"temporal_consistency_weight": 0.1}}, "pose"),
    ({"vae_model_kwargs": {"use_int8": True}}, "int8 seg-VAE"),
    ({"image_vae_kwargs": {"decoder_enabled": True}}, "decoder"),
    ({"optimizer_zero_redundancy": True}, "ZeRO"),
    ({"tensor_parallel": True}, "tensor parallel"),
    ({"spatial_parallel": True}, "spatial parallel"),
    ({"train_kwargs": {"gradient_checkpointing": True,
                       "remat_policy": "save_only_these_names"}},
     "remat_policy"),
    ({"train_kwargs": {"image_descriptors": "learnable"}}, "learnable"),
    ({"train_kwargs": {"image_descriptors": "none"}}, "none"),
])
def test_trainer_names_what_is_not_ported(override, named):
    cfg = merge_dicts(DEFAULT_CONFIG, override)
    if named in NOW_PORTED:
        # ported since: the trainer builds what the key asks for
        trainer = TrainerDiffusion(cfg, device=torch.device("cpu"))
        assert NOW_PORTED[named](trainer)
        return
    with pytest.raises((NotImplementedError, ValueError), match=named):
        TrainerDiffusion(cfg, device=torch.device("cpu"))


# what a model axis of more than one rank does not take yet (ROADMAP queue
# 1), one case each: (config override, unet_config fields, name raised);
# the cases that MODEL_AXIS_NOW_PORTED names take effect instead
MODEL_AXIS_REFUSED = [
    ({"sampling_kwargs": {"int8_inference": True}}, {}, "int8_inference"),
    ({"image_vae_kwargs": {"use_int8": True}}, {},
     "image_vae_kwargs.use_int8"),
    ({"vae_model_kwargs": {"use_int8": True}}, {},
     "vae_model_kwargs.use_int8"),
    ({}, {"use_packed_attention": True}, "use_packed_attention"),
    ({}, {"use_absorbed_attention": True}, "use_absorbed_attention"),
    ({}, {"use_fused_projs": True}, "use_fused_projs"),
    ({"train_kwargs": {"image_descriptors": "none"}}, {},
     "image_descriptors 'none'"),
    ({"train_kwargs": {"image_descriptors": "learnable"}}, {},
     "image_descriptors 'learnable'"),
    ({"model_kwargs": {"separate_conv": True}}, {}, "separate_conv"),
    ({"model_kwargs": {"separate_encoder": True}}, {}, "separate_encoder"),
    ({"train_kwargs": {"temporal_consistency_weight": 0.1}}, {},
     "temporal_consistency_weight"),
    ({"optimizer_name": "adafactor"}, {}, "adafactor"),
    # an int8 UNet with an attention variant the model axis does not take
    ({"sampling_kwargs": {"int8_inference": True}},
     {"use_packed_attention": True},
     "use_packed_attention with sampling_kwargs.int8_inference"),
    ({"sampling_kwargs": {"int8_inference": True}},
     {"use_absorbed_attention": True},
     "use_absorbed_attention with sampling_kwargs.int8_inference"),
    ({"sampling_kwargs": {"int8_inference": True}},
     {"use_fused_projs": True},
     "use_fused_projs with sampling_kwargs.int8_inference"),
]


def _column_attn2(t):
    from ldmseg_torch.parallel import tp
    blk = t.unet.down_blocks[0].attentions[0].transformer_blocks[0]
    return (isinstance(blk.attn2.to_k, tp.ColumnLinear)
            and not blk.attn2.to_k.gather
            and isinstance(blk.attn2.to_out[0], tp.RowLinear))


def _spatial_s8(vae):
    from ldmseg_torch.parallel import sp
    convs = [m for m in vae.modules() if isinstance(m, QuantConv2d)]
    return convs and all(isinstance(m, sp.SpatialQuantConv2d)
                         and m.w_q is not None for m in convs)


def _attn1_cut(t, flag):
    # the masters' first attention: K14 between local q, k, v and a
    # row-parallel to_out, or K16's plain Linear layers of a rank's heads
    # with the model group
    from torch import nn

    from ldmseg_torch.parallel import tp
    a = t.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    if flag == "packed":
        return (a.packed and isinstance(a.to_q, tp.ColumnLinear)
                and not a.to_q.gather
                and isinstance(a.to_out[0], tp.RowLinear))
    return (a.absorbed and type(a.to_out[0]) is nn.Linear
            and isinstance(a.tp_group, tp.ModelGroup)
            and a.to_q.weight.shape[0] * 2 == a.to_q.weight.shape[1])


def _cut_int8_unet(t):
    from ldmseg_torch.parallel import tp
    u = t._unet_int8
    blk = u.down_blocks[0].attentions[0].transformer_blocks[0]
    lay, masters = tp.layout(u), tp.layout(t.unet)
    return (lay and all(masters[n] == cut for n, cut in lay.items())
            and isinstance(u.down_blocks[0].resnets[0].conv1,
                           tp.ColumnQuantConv2d)
            and isinstance(blk.attn1.tp_group, tp.ModelGroup)
            and isinstance(blk.ff.tp_group, tp.ModelGroup))


def _float_projs_cut(t):
    # the float UNet with use_fused_projs is cut as without it
    from ldmseg_torch.parallel import tp
    blk = t.unet.down_blocks[0].attentions[0]
    return bool(tp.layout(t.unet) and isinstance(blk.proj_in, tp.ColumnConv2d)
                and isinstance(blk.proj_out, tp.RowConv2d)
                and not blk.fused_projs)


def _fused_projs_grouped(t):
    from ldmseg_torch.models.unet import LNAttentionS8, LNFeedForwardS8
    from ldmseg_torch.parallel import tp
    blk = t._unet_int8.down_blocks[0].attentions[0]
    a, f = blk.transformer_blocks[0].attn1, blk.transformer_blocks[0].ff
    return (blk.fused_projs and type(a) is LNAttentionS8 and a.proj_in
            and type(f) is LNFeedForwardS8 and f.proj_out
            and isinstance(a.tp_group, tp.ModelGroup)
            and isinstance(f.tp_group, tp.ModelGroup))


# ported since (test_torch_port_model_axis_serving,
# test_torch_port_model_axis_context): with a model axis of 2 each takes
# effect on a small trainer (a mesh without a group: the cuts and the class
# swaps need no collective)
MODEL_AXIS_NOW_PORTED = {
    "int8_inference": _cut_int8_unet,
    "image_vae_kwargs.use_int8": lambda t: _spatial_s8(t.vae_img),
    "vae_model_kwargs.use_int8": lambda t: _spatial_s8(t.vae_seg),
    "image_descriptors 'none'": _column_attn2,
    "image_descriptors 'learnable'": lambda t: (
        _column_attn2(t) and "object_queries.weight" not in
        __import__("ldmseg_torch.parallel.tp",
                   fromlist=["layout"]).layout(t.unet)),
    # test_torch_port_model_axis_attention*
    "use_packed_attention": lambda t: _attn1_cut(t, "packed"),
    "use_absorbed_attention": lambda t: _attn1_cut(t, "absorbed"),
    "use_packed_attention with sampling_kwargs.int8_inference": lambda t: (
        _attn1_cut(t, "packed") and _cut_int8_unet(t)),
    "use_absorbed_attention with sampling_kwargs.int8_inference": lambda t: (
        _attn1_cut(t, "absorbed") and _cut_int8_unet(t)),
    # test_torch_port_model_axis_int8_options*: a float UNet takes the flag
    # as it is (it needs fused norms); the int8 one's K8 and K9 hold the
    # group, its 1x1 convs cut as the masters'
    "use_fused_projs": _float_projs_cut,
    "use_fused_projs with sampling_kwargs.int8_inference": lambda t: (
        _cut_int8_unet(t) and _fused_projs_grouped(t)),
}


@pytest.mark.parametrize("override,unet_kw,named", MODEL_AXIS_REFUSED,
                         ids=[c[2].split()[0] for c in MODEL_AXIS_REFUSED])
def test_model_axis_refuses_by_name(override, unet_kw, named):
    from ldmseg_torch.entry import DRYRUN_UNET, _dryrun_config
    from ldmseg_torch.models.descriptors import get_image_descriptors
    from ldmseg_torch.models.unet import UNetConfig
    from ldmseg_torch.parallel.mesh import Mesh
    if named in MODEL_AXIS_NOW_PORTED:
        cfg = merge_dicts(_dryrun_config(1, "cpu"), dict(
            override, tensor_parallel=True, spatial_parallel=True))
        spec = get_image_descriptors(cfg["train_kwargs"].get(
            "image_descriptors", "remove"))
        unet_config = UNetConfig(
            in_channels=12, use_cross_attention=spec.use_cross_attention,
            num_object_queries=spec.num_object_queries,
            **dict(DRYRUN_UNET, **unet_kw))
        trainer = TrainerDiffusion(cfg, unet_config=unet_config,
                                   device="cpu", mesh=Mesh(model=2))
        trainer.init_params(seed=0)
        assert MODEL_AXIS_NOW_PORTED[named](trainer)
        return
    cfg = merge_dicts(DEFAULT_CONFIG, dict(override, tensor_parallel=True,
                                           spatial_parallel=True))
    unet_config = UNetConfig(in_channels=12, **unet_kw) if unet_kw else None
    with pytest.raises(NotImplementedError, match=named):
        TrainerDiffusion(cfg, unet_config=unet_config, device="cpu",
                         mesh=Mesh(model=2))
    # without a model axis the option is taken as before
    TrainerDiffusion(cfg, unet_config=unet_config, device="cpu")


@pytest.mark.parametrize("call", ["attach_pose", "sample_panoptic_clip",
                                  "a clip batch"])
def test_model_axis_refuses_video_at_the_call(call):
    from ldmseg_torch.parallel.mesh import Mesh
    trainer = TrainerDiffusion(DEFAULT_CONFIG, device="cpu",
                               mesh=Mesh(model=2))
    clip = {"image": torch.zeros(1, 2, 32, 32, 3)}
    run = {"attach_pose": lambda: trainer.attach_pose(None),
           "sample_panoptic_clip": lambda: trainer.sample_panoptic_clip(clip),
           "a clip batch": lambda: trainer.forward_backward(clip)}[call]
    with pytest.raises(NotImplementedError, match=f"{call}.*video clips"):
        run()


# the conditioning slice's modules, one case each
CONDITIONING_MODULES = ["models.descriptors", "models.upscaler",
                        "models.unet", "models.convert",
                        "diffusion.sampler", "train.trainer_ldm",
                        "tools.main_ldm", "tools.predict"]


@pytest.mark.parametrize("module", CONDITIONING_MODULES)
def test_conditioning_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []
    importlib.import_module(f"ldmseg_torch.{module}")


def test_descriptors_import_transformers_only_in_the_clip_branches():
    tree = ast.parse((ROOT / "ldmseg_torch/models/descriptors.py")
                     .read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any((getattr(n, "module", None) or "").startswith(
        "transformers") or any(a.name.startswith("transformers")
                               for a in n.names) for n in top)


def test_trainer_accepts_int8_inference():
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True},
        "sampling_kwargs": {"int8_inference": True}})
    trainer = TrainerDiffusion(cfg, device=torch.device("cpu"))
    ucfg = trainer._unet_int8.config
    assert (ucfg.use_int8_conv and ucfg.use_fused_norms
            and ucfg.use_int8_ff and ucfg.use_fused_ff
            and ucfg.int8_act_scale == 0.05
            and ucfg.int8_attn_act_scale == 0.1
            and not ucfg.use_fused_attention
            and not ucfg.use_int8_attention)
    with pytest.raises(RuntimeError, match="init_params"):
        trainer.sample_panoptic({"image": torch.zeros(1, 32, 32, 3)})


def _int8_trainer(**sk):
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True},
        "sampling_kwargs": {"int8_inference": True, **sk}})
    return TrainerDiffusion(cfg, device=torch.device("cpu"))


def _blocks(trainer):
    from ldmseg_torch.models.unet import BasicTransformerBlock
    return [m for m in trainer._unet_int8.modules()
            if isinstance(m, BasicTransformerBlock)]


# the three int8 combinations off the default, (a) and (b) without fused
# norms, (c) without the fused FF: the JAX trainer's flags
# (trainer_ldm.py:163-176), each built from the modules that run it
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_trainer_accepts_int8_without_fused_norms_or_ff(variant):
    from ldmseg_torch.models.unet import (CrossAttention, FeedForwardS8,
                                          LNAttentionS8)
    sk = {"a": {"fused_norms": False},
          "b": {"fused_norms": False, "fused_ff": False},
          "c": {"fused_ff": False}}[variant]
    trainer = _int8_trainer(**sk)
    ucfg = trainer._unet_int8.config
    fused_norms = variant == "c"
    assert (ucfg.use_int8_conv and ucfg.use_int8_ff
            and ucfg.use_fused_norms == fused_norms
            and ucfg.use_int8_attention == (not fused_norms)
            and ucfg.use_fused_attention == (not fused_norms)
            and ucfg.use_fused_ff == (variant == "a")
            and ucfg.int8_act_scale == 0.05
            and ucfg.int8_attn_act_scale == 0.1)
    blocks = _blocks(trainer)
    assert len(blocks) == 16
    for blk in blocks:
        assert isinstance(blk.ff, FeedForwardS8)
        assert blk.ff.fused == (variant == "a")
        if fused_norms:
            assert blk.fuse_attn and isinstance(blk.attn1, LNAttentionS8)
            assert not blk.fuse_ff
        else:
            assert not blk.fuse_attn and not blk.fuse_ff
            assert isinstance(blk.attn1, CrossAttention)
            assert blk.attn1.int8 and blk.attn1.use_fused
            assert blk.attn1.int8_act_scale == 0.1
    with pytest.raises(RuntimeError, match="init_params"):
        trainer.sample_panoptic({"image": torch.zeros(1, 32, 32, 3)})


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1.6e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,t,h,d", [(2, 2048, 8, 40), (2, 512, 8, 80),
                                     (2, 128, 8, 160), (2, 32, 8, 160),
                                     (1, 100, 3, 8), (1, 1, 1, 64)])
def test_k1_kernel_matches_plain_version(cuda, b, t, h, d, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    before = A.fused_self_attention.launches
    out = A.fused_self_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert A.fused_self_attention.launches == before + 1
    ref = A.attention_reference(q, k, v, d ** -0.5)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.gpu
def test_k1_kernel_takes_strided_views(cuda):
    # q, k, v as views into one packed projection, as a fused QKV would give
    qkv = torch.randn(2, 64, 3, 4, 40, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = A.fused_self_attention(q, k, v, 0.2)
    ref = A.attention_reference(q, k, v, 0.2)
    assert (out.float() - ref.float()).abs().max().item() <= 1.6e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    # the VAE mid attention's D in fp32 (K1 takes D = 512 in bf16 only)
    ((1, 64, 1, 512), torch.float32),
    ((1, 64, 2, 40), torch.float16),
    ((1, 64, 2, 36), torch.bfloat16),
    ((1, 64, 1, 520), torch.bfloat16),   # above K1's widest class
])
def test_k1_wrapper_raises_instead_of_falling_back(cuda, shape, dtype):
    x = torch.randn(shape, device=cuda).to(dtype)
    with pytest.raises(ValueError):
        A.fused_self_attention(x, x, x, 0.1)


# K2 against its plain version, relative to each output's own max|ref|: two
# bf16 ulps (P and dS are rounded to bf16 on both sides, sums run in another
# order) and 1e-4 in fp32 (TF32 off)
K2_TOL = {torch.bfloat16: 1.6e-2, torch.float32: 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,h,d", [(2, 480, 8, 80), (2, 120, 8, 160),
                                     (2, 30, 8, 160), (1, 100, 3, 40),
                                     (1, 1, 1, 64), (1, 65, 2, 8)])
def test_k2_kernel_matches_plain_version(cuda, b, t, h, d, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    before = A.fused_self_attention_backward.launches
    grads = A.fused_self_attention_backward(q, k, v, do, d ** -0.5)
    torch.cuda.synchronize()
    assert A.fused_self_attention_backward.launches == before + 1
    refs = A.attention_backward_reference(q, k, v, do, d ** -0.5)
    for name, g, r in zip("qkv", grads, refs):
        assert g.dtype == dtype and g.shape == q.shape, name
        bound = K2_TOL[dtype] * r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= bound, f"d{name}: max abs err {err} > {bound}"


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((1, 64, 1, 512), torch.bfloat16),
    ((1, 64, 2, 40), torch.float16),
    ((1, 64, 2, 36), torch.bfloat16),
])
def test_k2_wrapper_raises_instead_of_falling_back(cuda, shape, dtype):
    x = torch.randn(shape, device=cuda).to(dtype)
    with pytest.raises(ValueError):
        A.fused_self_attention_backward(x, x, x, x, 0.1)


@pytest.mark.gpu
def test_fused_attention_differentiates_through_k1_and_k2(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn((2, 96, 4, 40), generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fwd, bwd = (A.fused_self_attention.launches,
                A.fused_self_attention_backward.launches)
    out = A.fused_self_attention(*leaves, 0.15)
    out.backward(do)
    assert A.fused_self_attention.launches == fwd + 1
    assert A.fused_self_attention_backward.launches == bwd + 1
    refs = A.attention_backward_reference(q, k, v, do, 0.15)
    direct = A.fused_self_attention_backward(q, k, v, do, 0.15)
    for leaf, ref, same in zip(leaves, refs, direct):
        assert torch.equal(leaf.grad, same)  # no atomics: deterministic
        bound = 1.6e-2 * ref.float().abs().max().item()
        assert (leaf.grad.float() - ref.float()).abs().max().item() <= bound
    # without autograd nothing is saved and no backward can run
    with torch.no_grad():
        plain = A.fused_self_attention(*leaves, 0.15)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


@pytest.mark.gpu
def test_unet_self_attention_weights_get_gradients_on_the_card(cuda):
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.models.unet import (CrossAttention, UNet2DCondition,
                                          UNetConfig)
    cfg = UNetConfig(in_channels=12, block_out_channels=(32, 64),
                     attn_down=(True, True), layers_per_block=1,
                     attention_head_dim=2, norm_num_groups=8,
                     use_fused_attention=True)
    unet = UNet2DCondition(cfg).to(cuda)
    init_random_(unet, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 12, 16, 16), generator=gen, device=cuda)
    bwd = A.fused_self_attention_backward.launches
    unet(x, torch.tensor([999, 19], device=cuda)).square().mean().backward()
    attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    assert len(attn) == 7  # 2 down, 1 mid, 4 up
    assert A.fused_self_attention_backward.launches == bwd + len(attn)
    for m in attn:
        g = m.to_q.weight.grad
        assert g is not None and bool(torch.isfinite(g).all())
        assert g.abs().max().item() > 0


# K3 and K4 against their plain versions on the card: max |err| within
# 1.6e-2 of max|ref| (two bf16 ulps; both round to bf16 and sum in another
# order) and mean |err| within 2.5e-3 of mean|ref| (a rare int8 code that
# the LN's summation order flips moves a few outputs by a code's worth)
def _pack_modules(cuda, c, heads, seed):
    from ldmseg_torch.models.layers import LayerNorm, init_random_
    from ldmseg_torch.models.unet import CrossAttention, FeedForward
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mods = [LayerNorm(c), CrossAttention(c, heads), LayerNorm(c),
            FeedForward(c)]
    for m in mods:
        m.to(cuda)
        init_random_(m, gen)
        with torch.no_grad():
            for p in m.parameters():  # not the init's unit norms, zero biases
                p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                          device=cuda))
    return mods


def _close_on_card(out, ref):
    err = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out).all())
    assert err.max().item() <= 1.6e-2 * ref.float().abs().max().item()
    assert err.mean().item() <= 2.5e-3 * ref.float().abs().mean().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", [(2, 2048, 320), (2, 512, 640),
                                   (2, 128, 1280), (2, 32, 1280),
                                   (1, 120, 320)])
def test_k3_kernel_matches_plain_version(cuda, b, t, c, dtype):
    norm1, attn, _, _ = _pack_modules(cuda, c, 8, 0)
    pack = K3.pack_ln_attention(norm1, attn, 8, 0.1)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(dtype)
    before = K3.ln_attention_s8.launches
    out = K3.ln_attention_s8(x, pack)
    torch.cuda.synchronize()
    assert K3.ln_attention_s8.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close_on_card(out, K3.ln_attention_s8_reference(x, pack).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("b,t,c", [(2, 2048, 320), (2, 512, 640),
                                   (2, 128, 1280), (2, 32, 1280),
                                   (1, 120, 320), (1, 1024, 320)])
def test_k4_kernel_matches_plain_version(cuda, b, t, c, static):
    _, _, norm3, ff = _pack_modules(cuda, c, 8, 2)
    pack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05,
                         0.02 if static else None)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(torch.bfloat16)
    before = K4.geglu_ln_s8.launches
    out = K4.geglu_ln_s8(x, pack)
    torch.cuda.synchronize()
    assert K4.geglu_ln_s8.launches == before + 1
    _close_on_card(out, K4.geglu_ln_s8_reference(x, pack))


@pytest.mark.gpu
def test_k3_k4_wrappers_raise_instead_of_falling_back(cuda):
    norm1, attn, norm3, ff = _pack_modules(cuda, 384, 2, 4)
    x = torch.randn((1, 64, 384), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):  # d = 192: the rule takes it, K3 not
        K3.ln_attention_s8(x, K3.pack_ln_attention(norm1, attn, 2, 0.1))
    pack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05)
    with pytest.raises(ValueError):
        K4.geglu_ln_s8(x.half(), pack)


# K13 and K12 against their plain versions on the card, at every shape of
# the unfused int8 UNet forward (batch 2, 32x64 latent) and a ragged T, with
# K3's and K4's tolerances: max |err| within 1.6e-2 of max|ref| (two bf16
# ulps), mean |err| within 2.5e-3 of mean|ref| (a code of e flips by one
# where exp differs by an ulp; the plain quantize multiplies by the
# reciprocal of a scale where the kernel divides)
@pytest.mark.gpu
@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("b,t,h,d", [(2, 2048, 8, 40), (2, 512, 8, 80),
                                     (2, 128, 8, 160), (2, 32, 8, 160),
                                     (1, 120, 8, 160), (1, 24, 2, 8)])
def test_k13_kernel_matches_plain_version(cuda, b, t, h, d, static):
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    act = 0.03 if static else None
    before = K13.fused_self_attention_s8.launches
    out = K13.fused_self_attention_s8(q, k, v, d ** -0.5, act)
    torch.cuda.synchronize()
    assert K13.fused_self_attention_s8.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close_on_card(out, K13.fused_self_attention_s8_reference(
        q, k, v, d ** -0.5, act))


@pytest.mark.gpu
def test_k13_kernel_takes_strided_views(cuda):
    qkv = torch.randn(2, 64, 3, 4, 40, device=cuda, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = K13.fused_self_attention_s8(q, k, v, 0.2, 0.03)
    _close_on_card(out, K13.fused_self_attention_s8_reference(
        q.contiguous(), k.contiguous(), v.contiguous(), 0.2, 0.03))


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("b,t,c", [(2, 2048, 320), (2, 512, 640),
                                   (2, 128, 1280), (2, 32, 1280),
                                   (1, 120, 320), (1, 1024, 320)])
def test_k12_kernel_matches_plain_version(cuda, b, t, c, static):
    _, _, norm3, ff = _pack_modules(cuda, c, 8, 2)
    pack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05,
                         0.02 if static else None)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(torch.bfloat16)
    before = K12.fused_geglu_s8.launches
    out = K12.fused_geglu_s8(x, pack)
    torch.cuda.synchronize()
    assert K12.fused_geglu_s8.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    _close_on_card(out, K12.geglu_s8_reference(x, pack))


@pytest.mark.gpu
def test_k13_k12_wrappers_raise_instead_of_falling_back(cuda):
    for shape, dtype in [((1, 64, 2, 192), torch.bfloat16),
                         ((1, 64, 2, 36), torch.bfloat16),
                         ((1, 64, 2, 40), torch.float16)]:
        x = torch.randn(shape, device=cuda).to(dtype)
        with pytest.raises(ValueError):
            K13.fused_self_attention_s8(x, x, x, 0.1, 0.1)
    _, _, norm3, ff = _pack_modules(cuda, 384, 2, 4)
    pack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05)
    x = torch.randn((1, 64, 384), device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):
        K12.fused_geglu_s8(x.half(), pack)


# K8, K9 and K11 against their plain versions on the card, at every shape
# of the int8 UNet forward (batch 2, 32x64 latent) and a ragged T, with
# K3's and K4's tolerances (_close_on_card)
def _proj_conv(cuda, c, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    conv = torch.nn.Conv2d(c, c, 1).to(cuda)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device=cuda) * c ** -0.5)
        conv.bias.copy_(0.05 * torch.randn(c, generator=gen, device=cuda))
    return conv


PADDED_SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280),
                 (2, 32, 1280), (1, 120, 320)]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["tokens", "channels"])
@pytest.mark.parametrize("b,t,c", PADDED_SHAPES)
def test_k8_kernel_matches_plain_version(cuda, b, t, c, layout):
    norm1, attn, _, _ = _pack_modules(cuda, c, 8, 0)
    pack = K3.with_proj_in(K3.pack_ln_attention(norm1, attn, 8, 0.1),
                           _proj_conv(cuda, c, 1))
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((b, c, t), generator=gen, device=cuda).to(
        torch.bfloat16).transpose(1, 2)      # the GroupNorm's NCHW tokens
    if layout == "tokens":
        x = x.contiguous()
    before = K3.ln_attention_s8_pin.launches
    out = K3.ln_attention_s8_pin(x, pack)
    torch.cuda.synchronize()
    assert K3.ln_attention_s8_pin.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    _close_on_card(out, K3.ln_attention_s8_pin_reference(x, pack))


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("b,t,c", PADDED_SHAPES + [(1, 1024, 320)])
def test_k9_kernel_matches_plain_version(cuda, b, t, c, static):
    _, _, norm3, ff = _pack_modules(cuda, c, 8, 2)
    pack = K4.with_proj_out(
        K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05,
                      0.02 if static else None), _proj_conv(cuda, c, 3))
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(torch.bfloat16)
    before = K4.geglu_ln_s8_pout.launches
    out = K4.geglu_ln_s8_pout(x, pack)
    torch.cuda.synchronize()
    assert K4.geglu_ln_s8_pout.launches == before + 1
    # the result is the tokens view of a channel-major [B, C, T] tensor
    assert out.shape == (b, t, c) and out.transpose(1, 2).is_contiguous()
    _close_on_card(out, K4.geglu_ln_s8_pout_reference(x, pack))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", PADDED_SHAPES)
def test_k11_kernel_matches_plain_version(cuda, b, t, c, dtype):
    _, attn, _, _ = _pack_modules(cuda, c, 8, 5)
    pack = K3.pack_padded_attention(attn, 8, 0.1)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(dtype)
    before = K3.padded_attention_s8.launches
    out = K3.padded_attention_s8(x, pack)
    torch.cuda.synchronize()
    assert K3.padded_attention_s8.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close_on_card(out, K3.padded_attention_s8_reference(x, pack).to(dtype))


@pytest.mark.gpu
def test_k8_k9_k11_wrappers_raise_instead_of_falling_back(cuda):
    norm1, attn, norm3, ff = _pack_modules(cuda, 384, 2, 4)
    conv = _proj_conv(cuda, 384, 5)
    x = torch.randn((1, 64, 384), device=cuda).to(torch.bfloat16)
    p8 = K3.with_proj_in(K3.pack_ln_attention(norm1, attn, 2, 0.1), conv)
    with pytest.raises(ValueError):  # d = 192: the rule takes it, K8 not
        K3.ln_attention_s8_pin(x, p8)
    norm1, attn, _, _ = _pack_modules(cuda, 384, 8, 4)
    p8 = K3.with_proj_in(K3.pack_ln_attention(norm1, attn, 8, 0.1), conv)
    with pytest.raises(ValueError):  # the bf16 prologue takes bf16 x only
        K3.ln_attention_s8_pin(x.float(), p8)
    with pytest.raises(ValueError):  # a K3 pack without proj_in
        K3.ln_attention_s8_pin(x, K3.pack_ln_attention(norm1, attn, 8, 0.1))
    p9 = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05)
    with pytest.raises(ValueError):  # a K4 pack without proj_out
        K4.geglu_ln_s8_pout(x, p9)
    with pytest.raises(ValueError):
        K4.geglu_ln_s8_pout(x.half(), K4.with_proj_out(p9, conv))
    _, attn, _, _ = _pack_modules(cuda, 384, 2, 4)
    with pytest.raises(ValueError):  # d = 192
        K3.padded_attention_s8(x, K3.pack_padded_attention(attn, 2, 0.1))


# the GroupNorm + SiLU slice's modules (K5, K6, K7), one case each
GN_MODULES = ["ops.groupnorm_silu", "ops.gn_silu_conv", "ops.quant",
              "models.layers", "models.unet", "tools.profile_sampling",
              "tools.profile_training", "tools.profile_gn",
              "tools.ablate_gn"]


@pytest.mark.parametrize("module", GN_MODULES)
def test_gn_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []
    importlib.import_module(f"ldmseg_torch.{module}")


def test_gn_sources_are_built_by_the_port():
    from ldmseg_torch.ops import _build
    assert {"groupnorm_silu", "gn_silu_conv"} <= set(_build.sources())
    assert (ROOT / "ldmseg_torch/csrc/gn_common.cuh").exists()
    k56 = (ROOT / "ldmseg_torch/csrc/groupnorm_silu.cu").read_text()
    assert 'extern "C" int ldmseg_group_norm_silu(' in k56
    assert 'extern "C" int ldmseg_group_norm_silu_quant(' in k56
    k7 = (ROOT / "ldmseg_torch/csrc/gn_silu_conv.cu").read_text()
    # the product is the kernel's own: gemm_sm90.cuh's TMA + wgmma product
    # over nine taps, no library call
    assert '#include "gemm_sm90.cuh"' in k7 and "launch_gemm_taps" in k7
    assert not any(lib in k7 for lib in ("cudnn", "cublas", "torch"))


def test_trainer_carries_the_gn_flags_into_the_int8_unet():
    from ldmseg_torch.models.unet import UNetConfig
    ucfg = UNetConfig(in_channels=12, use_fused_attention=True,
                      use_pallas_gn=True, int8_fuse_gn=True)
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True},
        "sampling_kwargs": {"int8_inference": True}})
    trainer = TrainerDiffusion(cfg, unet_config=ucfg,
                               device=torch.device("cpu"))
    int8_cfg = trainer._unet_int8.config
    assert int8_cfg.use_pallas_gn and int8_cfg.int8_fuse_gn
    assert int8_cfg.use_int8_conv and int8_cfg.use_fused_norms
    norms = [m for r in _resnet_blocks(trainer.unet) for m in (r.norm1,
                                                                r.norm2)]
    assert len(norms) == 44
    assert all(m.use_pallas and not m.quantize for m in norms)
    norms8 = [m for r in _resnet_blocks(trainer._unet_int8)
              for m in (r.norm1, r.norm2)]
    assert len(norms8) == 44 and all(m.quantize for m in norms8)
    # the parameter tree is the one without the flags
    plain = TrainerDiffusion(cfg, device=torch.device("cpu"))
    assert ({k: v.shape for k, v in plain.unet.state_dict().items()}
            == {k: v.shape for k, v in trainer.unet.state_dict().items()})


def _resnet_blocks(unet):
    from ldmseg_torch.models.layers import ResnetBlock
    return [m for m in unet.modules() if isinstance(m, ResnetBlock)]


# K5, K6 and K7 against their plain versions on the card, at the resnet norm
# shapes of the UNet (batch 2 on a 32x64 latent, batch 8 on 24x80) and a
# ragged shape that takes the scalar path. K5: max |err| within 1.6e-2 of
# max|ref| in bf16 (two bf16 ulps: both round to bf16, the sums run in
# another order) and 1e-5 in fp32; K6: every scale within rtol 1e-5, codes
# equal but for +-1 at no more than 1e-3 of the elements (a .5 tie that the
# summation order moves); K7: 2e-2 of max|ref| (sums over up to 9 x 2560
# bf16 products)
GN_SHAPES = [(2, 320, 32, 64), (2, 960, 32, 64), (2, 1920, 16, 32),
             (2, 2560, 4, 8), (8, 320, 24, 80), (8, 2560, 3, 10),
             (1, 64, 5, 7)]


def _gn_inputs(cuda, shape, dtype, seed, affine=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    c = shape[1]
    x = (1.5 * torch.randn(shape, generator=gen, device=cuda) + 0.3).to(
        dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(c, generator=gen, device=cuda)
    return x, scale.to(affine), bias.to(affine)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol,affine", [
    (torch.bfloat16, 1.6e-2, torch.float32),
    (torch.bfloat16, 1.6e-2, torch.bfloat16),   # the bf16 UNet's weights
    (torch.float32, 1e-5, torch.float32)])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_k5_kernel_matches_plain_version(cuda, shape, dtype, tol, affine):
    from ldmseg_torch.ops import groupnorm_silu as GN
    x, scale, bias = _gn_inputs(cuda, shape, dtype, 0, affine)
    before = GN.group_norm_silu.launches
    out = GN.group_norm_silu(x, scale, bias, 32, 1e-5)
    torch.cuda.synchronize()
    assert GN.group_norm_silu.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = GN.group_norm_silu_reference(x, scale, bias, 32, 1e-5)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,affine", [
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32)])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_k6_kernel_matches_plain_version(cuda, shape, dtype, affine):
    from ldmseg_torch.ops import groupnorm_silu as GN
    x, scale, bias = _gn_inputs(cuda, shape, dtype, 1, affine)
    before = GN.group_norm_silu_quant.launches
    q, s = GN.group_norm_silu_quant(x, scale, bias, 32, 1e-6)
    torch.cuda.synchronize()
    assert GN.group_norm_silu_quant.launches == before + 1
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.dtype == torch.float32 and s.shape == (shape[0],)
    rq, rs = GN.group_norm_silu_quant_reference(x, scale, bias, 32, 1e-6)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=0)
    diff = (q.int() - rq.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= 1e-3 * q.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout", [
    ((2, 320, 32, 64), 320), ((2, 640, 32, 64), 320),
    ((2, 1920, 16, 32), 640), ((2, 2560, 4, 8), 1280),
    ((1, 40, 5, 7), 24)])  # Cin % 16: the scalar weight loads
def test_k7_kernel_matches_plain_version(cuda, shape, cout):
    from ldmseg_torch.ops import gn_silu_conv as GC
    x, scale, bias = _gn_inputs(cuda, shape, torch.bfloat16, 2)
    groups = 8 if shape[1] == 40 else 32
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = (torch.randn((cout, shape[1], 3, 3), generator=gen, device=cuda)
         / (9 * shape[1]) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(cout, generator=gen, device=cuda)).to(
        torch.bfloat16)
    before = GC.gn_silu_conv.launches
    out = GC.gn_silu_conv(x, scale, bias, w, b, groups, 1e-5)
    torch.cuda.synchronize()
    assert GC.gn_silu_conv.launches == before + 1
    assert out.dtype == torch.bfloat16
    assert out.shape == (shape[0], cout) + shape[2:]
    ref = GC.gn_silu_conv_reference(x, scale, bias, w, b, groups, 1e-5)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()


@pytest.mark.gpu
def test_gn_wrappers_raise_instead_of_falling_back(cuda):
    from ldmseg_torch.ops import gn_silu_conv as GC
    from ldmseg_torch.ops import groupnorm_silu as GN
    x, scale, bias = _gn_inputs(cuda, (2, 64, 8, 8), torch.bfloat16, 4)
    w = torch.zeros((16, 64, 3, 3), device=cuda, dtype=torch.bfloat16)
    b = torch.zeros(16, device=cuda)
    for fn in (GN.group_norm_silu, GN.group_norm_silu_quant):
        with pytest.raises(ValueError):            # dtype
            fn(x.half(), scale, bias, 32)
        with pytest.raises(ValueError):            # C % groups
            fn(x, scale, bias, 24)
        with pytest.raises(ValueError):            # not contiguous
            fn(x.transpose(2, 3), scale, bias, 32)
    with pytest.raises(ValueError):                # bf16 only
        GC.gn_silu_conv(x.float(), scale, bias, w, b, 32)
    with pytest.raises(ValueError):
        GC.gn_silu_conv(x, scale, bias, w, b, 24)
    with pytest.raises(ValueError):
        GC.gn_silu_conv(x.transpose(2, 3), scale, bias, w, b, 32)


@pytest.mark.gpu
def test_gn_counters_count_launches_and_fallbacks(cuda):
    from ldmseg_torch.ops import gn_silu_conv as GC
    from ldmseg_torch.ops import groupnorm_silu as GN
    x, scale, bias = _gn_inputs(cuda, (2, 64, 8, 8), torch.bfloat16, 5)
    w = torch.randn((32, 64, 3, 3), device=cuda).to(torch.bfloat16) * 0.05
    b = torch.zeros(32, device=cuda)
    for fn, args in ((GN.group_norm_silu, ()),
                     (GN.group_norm_silu_quant, ()),
                     (GC.gn_silu_conv, (w, b))):
        before = (fn.launches, fn.fallbacks)
        fn(x, scale, bias, *args, 32)
        fn(x, scale, bias, *args, 32, max_tile_bytes=64)
        torch.cuda.synchronize()
        assert (fn.launches, fn.fallbacks) == (before[0] + 1,
                                               before[1] + 1), fn.__name__


@pytest.mark.gpu
def test_k5_and_k7_differentiate_on_the_card(cuda):
    from ldmseg_torch.ops import gn_silu_conv as GC
    from ldmseg_torch.ops import groupnorm_silu as GN
    x, scale, bias = _gn_inputs(cuda, (2, 64, 8, 8), torch.float32, 6)
    w = 0.05 * torch.randn((32, 64, 3, 3), device=cuda)
    b = 0.1 * torch.randn(32, device=cuda)
    g = torch.randn((2, 64, 8, 8), device=cuda)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    before = GN.group_norm_silu.launches
    GN.group_norm_silu(*leaves, 32).backward(g)
    assert GN.group_norm_silu.launches == before + 1
    ref = [t.clone().requires_grad_() for t in (x, scale, bias)]
    GN.gn_silu_reference(*ref, 32, 1e-5).backward(g)
    for a, r in zip(leaves, ref):
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-5, atol=1e-5)
    xb = x.to(torch.bfloat16).requires_grad_()
    wb = w.to(torch.bfloat16).requires_grad_()
    out = GC.gn_silu_conv(xb, scale, bias, wb, b, 32)
    out.float().sum().backward()
    assert xb.grad is not None and wb.grad is not None
    assert bool(torch.isfinite(xb.grad.float()).all())


# the packed-attention slice's modules (K14, K15, K10), one case each
PACKED_MODULES = ["ops.attention", "ops.attention_s8", "models.unet",
                  "ops.quant", "train.trainer_ldm", "tools.profile_sampling",
                  "tools.profile_training"]


@pytest.mark.parametrize("module", PACKED_MODULES)
def test_packed_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []
    importlib.import_module(f"ldmseg_torch.{module}")


def test_port_and_chip_smoke_load_no_jax():
    # a fresh interpreter that imports every module of the port and
    # chip_smoke.py: neither JAX nor the JAX package may be loaded
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (ROOT / "ldmseg_torch").rglob("*.py"))
    code = ("import sys, runpy; "
            + "; ".join(f"import {m}" for m in mods)
            + "; import chip_smoke"
            + f"; bad = {{m.split('.')[0] for m in sys.modules}}"
            f" & {set(FORBIDDEN)!r}; print(bad, file=sys.stderr)"
            "; sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_packed_sources_are_built_by_the_port():
    fwd = (ROOT / "ldmseg_torch/csrc/attention_fwd.cu").read_text()
    s8 = (ROOT / "ldmseg_torch/csrc/attention_s8.cu").read_text()
    ln = (ROOT / "ldmseg_torch/csrc/attention_ln_s8.cu").read_text()
    assert 'extern "C" int ldmseg_attention_fwd_packed(' in fwd   # K14
    assert 'extern "C" int ldmseg_attention_packed_s8(' in s8     # K15
    assert 'extern "C" int ldmseg_attention_ln_padded_s8(' in s8  # K10
    assert 'extern "C" int ldmseg_attention_ln_s8_rowmajor(' in ln


def test_trainer_carries_the_packed_flag_into_both_unets():
    from ldmseg_torch.models.unet import CrossAttention, UNetConfig
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True},
        "sampling_kwargs": {"int8_inference": True, "fused_norms": False}})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(
        in_channels=12, use_fused_attention=True, use_packed_attention=True),
        device=torch.device("cpu"))
    for unet, int8 in ((trainer.unet, False), (trainer._unet_int8, True)):
        attn = [m for m in unet.modules() if isinstance(m, CrossAttention)]
        assert len(attn) == 16
        assert all(m.packed and m.int8 == int8 for m in attn)


# K14 against its plain version on the card at the serving (batch 2, 32x64)
# and training (batch 8, 24x80) shapes: K1's tolerances, two bf16 ulps and
# 1e-4 in fp32
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 1.6e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,t,c", [(2, 2048, 320), (2, 512, 640),
                                   (2, 128, 1280), (2, 32, 1280),
                                   (8, 1920, 320), (8, 480, 640),
                                   (8, 120, 1280)])
def test_k14_kernel_matches_plain_version(cuda, b, t, c, dtype, atol):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((b, t, c), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    scale = (c // 8) ** -0.5
    before = (A.fused_self_attention_packed.launches,
              A.fused_self_attention.launches)
    out = A.fused_self_attention_packed(q, k, v, 8, scale)
    torch.cuda.synchronize()
    # its own counter: K1's does not move
    assert (A.fused_self_attention_packed.launches,
            A.fused_self_attention.launches) == (before[0] + 1, before[1])
    assert out.dtype == dtype and out.shape == q.shape
    ref = A.packed_attention_reference(q, k, v, 8, scale)
    assert (out.float() - ref.float()).abs().max().item() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", [(8, 480, 640), (8, 120, 1280),
                                   (1, 64, 320)])
def test_k14_differentiates_through_k2_on_the_card(cuda, b, t, c, dtype):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn((b, t, c), generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    scale = (c // 8) ** -0.5
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    fwd, bwd = (A.fused_self_attention_packed.launches,
                A.fused_self_attention_backward.launches)
    A.fused_self_attention_packed(*leaves, 8, scale).backward(do)
    assert (A.fused_self_attention_packed.launches,
            A.fused_self_attention_backward.launches) == (fwd + 1, bwd + 1)
    refs = A.attention_backward_reference(
        *(x.unflatten(-1, (8, c // 8)) for x in (q, k, v, do)), scale)
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == (b, t, c)
        bound = K2_TOL[dtype] * ref.float().abs().max().item()
        err = (leaf.grad.float() - ref.reshape(b, t, c).float()).abs()
        assert err.max().item() <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(2, 2048, 320), (2, 512, 640),
                                   (2, 128, 1280), (2, 32, 1280),
                                   (8, 1920, 320), (1, 24, 64)])
def test_k15_kernel_matches_plain_version(cuda, b, t, c):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((b, t, c), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    heads = 8
    scale = (c // heads) ** -0.5
    before = K13.fused_self_attention_packed_s8.launches
    out = K13.fused_self_attention_packed_s8(q, k, v, heads, scale)
    torch.cuda.synchronize()
    assert K13.fused_self_attention_packed_s8.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close_on_card(out, K13.fused_self_attention_packed_s8_reference(
        q, k, v, heads, scale))


@pytest.mark.gpu
@pytest.mark.parametrize("v_bf16", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", [(2, 2048, 320), (2, 512, 640),
                                   (2, 128, 1280), (2, 32, 1280),
                                   (1, 120, 320)])
def test_k10_kernel_matches_plain_version(cuda, b, t, c, dtype, v_bf16):
    norm1, attn, _, _ = _pack_modules(cuda, c, 8, 10)
    pack = K3.pack_ln_attention_rowmajor(norm1, attn, 8, 0.1)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(dtype)
    before = K3.ln_attention_s8_rowmajor.launches
    out = K3.ln_attention_s8_rowmajor(x, pack, v_bf16)
    torch.cuda.synchronize()
    assert K3.ln_attention_s8_rowmajor.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close_on_card(out, K3.ln_attention_s8_rowmajor_reference(
        x, pack, v_bf16).to(dtype))


@pytest.mark.gpu
def test_packed_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn((1, 64, 384), device=cuda).to(torch.bfloat16)
    for heads in (2, 96):   # d = 192 and d = 4: the rule takes both
        with pytest.raises(ValueError):
            A.fused_self_attention_packed(x, x, x, heads, 0.1)
        with pytest.raises(ValueError):
            K13.fused_self_attention_packed_s8(x, x, x, heads, 0.1)
    with pytest.raises(ValueError):
        A.fused_self_attention_packed(x.half(), x.half(), x.half(), 8, 0.1)
    with pytest.raises(ValueError):   # unit stride on C
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        A.fused_self_attention_packed(xt, xt, xt, 8, 0.1)
    norm1, attn, _, _ = _pack_modules(cuda, 384, 2, 4)
    pack = K3.pack_ln_attention_rowmajor(norm1, attn, 2, 0.1)
    for v_bf16 in (True, False):   # d = 192
        with pytest.raises(ValueError):
            K3.ln_attention_s8_rowmajor(x, pack, v_bf16)


@pytest.mark.gpu
def test_packed_unet_launches_k14_k15_and_no_other(cuda):
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig
    from ldmseg_torch.ops import quant
    kw = dict(in_channels=12, block_out_channels=(64, 128),
              attn_down=(True, True), layers_per_block=1,
              attention_head_dim=8, norm_num_groups=8,
              use_fused_attention=True, use_packed_attention=True)
    unet = UNet2DCondition(UNetConfig(**kw)).to(cuda)
    init_random_(unet, torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn((2, 12, 16, 16), device=cuda)
    t = torch.tensor([999, 19], device=cuda)
    counters = (A.fused_self_attention, A.fused_self_attention_packed,
                A.fused_self_attention_backward,
                K13.fused_self_attention_s8,
                K13.fused_self_attention_packed_s8)
    before = [f.launches for f in counters]
    # T = 256 and 64, 7 blocks: 7 K14 forward, 7 K2 backward, 0 K1
    unet(x, t).square().mean().backward()
    assert [f.launches - n for f, n in zip(counters, before)] == [
        0, 7, 7, 0, 0]
    int8 = UNet2DCondition(UNetConfig(
        **kw, use_int8_conv=True, int8_act_scale=0.05,
        use_int8_attention=True, use_int8_ff=True, use_fused_ff=True,
        int8_attn_act_scale=0.1)).to(cuda, torch.bfloat16)
    quant.prepare_int8_unet(int8, unet)
    before = [f.launches for f in counters]
    with torch.no_grad():
        out = int8(x.to(torch.bfloat16), t)
    assert bool(torch.isfinite(out).all())
    assert [f.launches - n for f, n in zip(counters, before)] == [
        0, 0, 0, 0, 7]


# the absorbed-attention slice's modules (K16, K17, K18), one case each
ABSORBED_MODULES = ["ops.attention", "ops.attention_s8", "ops.quant",
                    "models.unet", "train.trainer_ldm",
                    "tools.profile_sampling", "tools.profile_training"]


@pytest.mark.parametrize("module", ABSORBED_MODULES)
def test_absorbed_module_imports_no_jax(module):
    path = ROOT / "ldmseg_torch" / (module.replace(".", "/") + ".py")
    assert [n for n in _imported_roots(path) if n in FORBIDDEN] == []
    importlib.import_module(f"ldmseg_torch.{module}")


def test_absorbed_sources_are_built_by_the_port():
    fwd = (ROOT / "ldmseg_torch/csrc/attention_fwd.cu").read_text()
    s8 = (ROOT / "ldmseg_torch/csrc/attention_s8.cu").read_text()
    assert 'extern "C" int ldmseg_attention_absorbed(' in fwd      # K16
    assert 'extern "C" int ldmseg_attention_absorbed_s8(' in s8    # K17
    assert 'extern "C" int ldmseg_attention_absorbed_fullc_s8(' in s8  # K18
    # one entry a kernel: the model axis's modes are its arguments (K15's
    # stage, K16's and K17's inner width and partial flag)
    assert fwd.count('extern "C" int ldmseg_attention_absorbed') == 1
    assert s8.count('extern "C" int ldmseg_attention_absorbed') == 2
    assert s8.count('extern "C" int ldmseg_attention_packed_s8') == 1
    # and so are K3's, K8's, K9's and K11's (their inner width, partial
    # flag, K9's proj_out stage alone)
    ln = (ROOT / "ldmseg_torch/csrc/attention_ln_s8.cu").read_text()
    geglu = (ROOT / "ldmseg_torch/csrc/geglu_ln_s8.cu").read_text()
    # K3, K8 and K10's entries, no K3 partial one
    assert ln.count('extern "C" int ldmseg_attention_ln_s8') == 3
    assert "_partial(" not in ln
    assert s8.count('extern "C" int ldmseg_attention_padded_s8') == 1
    assert geglu.count('extern "C" int ldmseg_geglu_ln_s8_pout') == 1


def test_trainer_carries_the_absorbed_flag_into_both_unets():
    from ldmseg_torch.models.unet import (AbsorbedAttentionS8,
                                          BasicTransformerBlock,
                                          CrossAttention, UNetConfig)
    cfg = merge_dicts(DEFAULT_CONFIG, {
        "train_kwargs": {"self_condition": True},
        "sampling_kwargs": {"int8_inference": True, "fused_norms": False}})
    trainer = TrainerDiffusion(cfg, unet_config=UNetConfig(
        in_channels=12, use_fused_attention=True,
        use_absorbed_attention=True), device=torch.device("cpu"))
    for unet, kind in ((trainer.unet, CrossAttention),
                       (trainer._unet_int8, AbsorbedAttentionS8)):
        attn = [m.attn1 for m in unet.modules()
                if isinstance(m, BasicTransformerBlock)]
        assert len(attn) == 16
        assert all(type(m) is kind and m.absorbed for m in attn)


def _absorbed_case(cuda, b, t, c, dtype, seed):
    """x and four [C, C] weights on the card, the weights at the scale of
    a trained projection (std 0.05) so that the scores stay near 1."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(dtype)
    ws = [(0.05 * torch.randn((c, c), generator=gen, device=cuda)).to(dtype)
          for _ in range(4)]
    return x, ws


ABSORBED_SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280),
                   (2, 32, 1280), (8, 1920, 320), (8, 480, 640),
                   (8, 120, 1280)]


# K16 against its plain version on the card at the serving (batch 2, 32x64)
# and training (batch 8, 24x80) shapes: two bf16 ulps of max|ref| (q, k, v,
# P, oh and the output round at the same points; the sums run in another
# order) and 1e-4 of max|ref| in fp32
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1.6e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,t,c", ABSORBED_SHAPES)
def test_k16_kernel_matches_plain_version(cuda, b, t, c, dtype, tol):
    x, ws = _absorbed_case(cuda, b, t, c, dtype, 12)
    scale = (c // 8) ** -0.5
    before = (A.absorbed_self_attention.launches,
              A.fused_self_attention.launches,
              A.fused_self_attention_packed.launches)
    out = A.absorbed_self_attention(x, *ws, 8, scale)
    torch.cuda.synchronize()
    # its own counter: K1's and K14's do not move
    assert (A.absorbed_self_attention.launches,
            A.fused_self_attention.launches,
            A.fused_self_attention_packed.launches) == (
                before[0] + 1, before[1], before[2])
    assert out.dtype == dtype and out.shape == x.shape
    ref = A.absorbed_attention_reference(x, *ws, 8, scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", [(8, 480, 640), (8, 120, 1280),
                                   (1, 64, 320)])
def test_k16_differentiates_through_k2_on_the_card(cuda, b, t, c, dtype):
    x, ws = _absorbed_case(cuda, b, t, c, dtype, 13)
    g = torch.randn((b, t, c), generator=torch.Generator(
        device=cuda).manual_seed(14), device=cuda).to(dtype)
    scale = (c // 8) ** -0.5
    leaves = [z.clone().requires_grad_(True) for z in (x, *ws)]
    fwd, bwd = (A.absorbed_self_attention.launches,
                A.fused_self_attention_backward.launches)
    A.absorbed_self_attention(*leaves, 8, scale).backward(g)
    assert (A.absorbed_self_attention.launches,
            A.fused_self_attention_backward.launches) == (fwd + 1, bwd + 1)
    # autograd through the plain version (its softmax's backward in fp32)
    plain = [z.clone().requires_grad_(True) for z in (x, *ws)]
    A.absorbed_attention_reference(*plain, 8, scale).backward(g)
    for leaf, ref in zip(leaves, plain):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == leaf.shape
        bound = 2 * K2_TOL[dtype] * ref.grad.float().abs().max().item()
        assert (leaf.grad.float() - ref.grad.float()).abs().max().item() \
            <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("fullc", [False, True])
@pytest.mark.parametrize("b,t,c", [(2, 2048, 320), (2, 512, 640),
                                   (2, 128, 1280), (2, 32, 1280),
                                   (1, 24, 64)])
def test_k17_k18_kernels_match_plain_version(cuda, b, t, c, fullc):
    from ldmseg_torch.ops import quant
    x, ws = _absorbed_case(cuda, b, t, c, torch.bfloat16, 15)
    heads = 8
    qfn = (quant.quantize_fullc_weights if fullc else
           lambda *w: quant.quantize_head_weights(*w, heads))
    q8, k8, v8, o8, sc = qfn(*(w.float() for w in ws))
    w_qkv = torch.cat([q8, k8, v8]).contiguous()
    fn = (K13.absorbed_fullc_self_attention_s8 if fullc
          else K13.absorbed_self_attention_s8)
    scale = (c // heads) ** -0.5
    before = fn.launches
    out = fn(x, w_qkv, o8, sc, heads, scale, 0.1)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    _close_on_card(out, K13.absorbed_attention_s8_reference(
        x, w_qkv, o8, sc, heads, scale, 0.1, per_image=fullc))


@pytest.mark.gpu
def test_absorbed_wrappers_raise_instead_of_falling_back(cuda):
    from ldmseg_torch.ops import quant
    x, ws = _absorbed_case(cuda, 1, 64, 384, torch.bfloat16, 16)
    with pytest.raises(ValueError):      # d = 192: the rule takes it
        A.absorbed_self_attention(x, *ws, 2, 0.1)
    with pytest.raises(ValueError):      # float16
        A.absorbed_self_attention(x.half(), *(w.half() for w in ws), 8, 0.1)
    with pytest.raises(ValueError):      # mixed dtypes
        A.absorbed_self_attention(x, *(w.float() for w in ws), 8, 0.1)
    q8, k8, v8, o8, sc = quant.quantize_head_weights(
        *(w.float() for w in ws), 2)
    w_qkv = torch.cat([q8, k8, v8])
    with pytest.raises(ValueError):      # d = 192
        K13.absorbed_self_attention_s8(x, w_qkv, o8, sc, 2, 0.1, 0.1)
    with pytest.raises(ValueError):      # per-tensor scales for K17
        K13.absorbed_self_attention_s8(x, w_qkv, o8, sc[:, 0], 2, 0.1, 0.1)
    with pytest.raises(ValueError):      # per-head scales for K18
        K13.absorbed_fullc_self_attention_s8(x, w_qkv, o8, sc, 2, 0.1, 0.1)


@pytest.mark.gpu
def test_absorbed_unet_launches_k16_k17_and_no_other(cuda):
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig
    from ldmseg_torch.ops import quant
    kw = dict(in_channels=12, block_out_channels=(64, 128),
              attn_down=(True, True), layers_per_block=1,
              attention_head_dim=8, norm_num_groups=8,
              use_fused_attention=True, use_absorbed_attention=True,
              use_packed_attention=True)
    unet = UNet2DCondition(UNetConfig(**kw)).to(cuda)
    init_random_(unet, torch.Generator(device=cuda).manual_seed(0))
    x = torch.randn((2, 12, 16, 16), device=cuda)
    t = torch.tensor([999, 19], device=cuda)
    counters = (A.fused_self_attention, A.fused_self_attention_packed,
                A.absorbed_self_attention, A.fused_self_attention_backward,
                K13.fused_self_attention_s8,
                K13.fused_self_attention_packed_s8,
                K13.absorbed_self_attention_s8)
    before = [f.launches for f in counters]
    # T = 256 and 64, 7 blocks: 7 K16 forward, 7 K2 backward, 0 K1 / K14;
    # every attention weight gets a gradient
    unet(x, t).square().mean().backward()
    assert [f.launches - n for f, n in zip(counters, before)] == [
        0, 0, 7, 7, 0, 0, 0]
    for name, p in unet.named_parameters():
        if ".attn1." in name:
            assert p.grad is not None and p.grad.abs().max().item() > 0, name
    for dtype in (torch.bfloat16, torch.float32):
        with torch.no_grad():
            bf = unet.to(dtype)(x.to(dtype), t)
        assert bool(torch.isfinite(bf).all())
    int8 = UNet2DCondition(UNetConfig(
        **kw, use_int8_conv=True, int8_act_scale=0.05,
        use_int8_attention=True, use_int8_ff=True, use_fused_ff=True,
        int8_attn_act_scale=0.1)).to(cuda, torch.bfloat16)
    quant.prepare_int8_unet(int8, unet)
    before = [f.launches for f in counters]
    with torch.no_grad():
        out = int8(x.to(torch.bfloat16), t)
    assert bool(torch.isfinite(out).all())
    assert [f.launches - n for f, n in zip(counters, before)] == [
        0, 0, 0, 0, 0, 0, 7]
