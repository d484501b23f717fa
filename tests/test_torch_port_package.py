"""Rules of the PyTorch port that need no JAX, and its tests on the card.

This file imports no JAX, so that the ``gpu`` tests run on a machine that
has none:

    python -m pytest --noconftest -m gpu tests/test_torch_port_*.py

(the other ``test_torch_port_*`` files skip themselves there). A ``gpu``
test decides inside the ``cuda`` fixture whether a card is present and skips
without one.
"""

import ast
import pathlib

import pytest
import torch

from ldmseg_torch.ops import attention as A
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


@pytest.mark.parametrize("override,named", [
    ({"train_kwargs": {"image_descriptors": "clip_text"}}, "descriptors"),
    ({"sampling_kwargs": {"int8_inference": True}}, "int8"),
    ({"sampling_kwargs": {"sampler": "dpmpp_2m"}}, "DPM-Solver"),
    ({"ema_on": True}, "EMA"),
    ({"model_kwargs": {"separate_conv": True}}, "separate"),
    ({"vae_model_kwargs": {"num_mid_blocks": 1}}, "mid blocks"),
])
def test_trainer_names_what_is_not_ported(override, named):
    cfg = merge_dicts(DEFAULT_CONFIG, override)
    with pytest.raises(NotImplementedError, match=named):
        TrainerDiffusion(cfg, device=torch.device("cpu"))


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
    ((1, 64, 1, 512), torch.bfloat16),   # the VAE mid attention's D
    ((1, 64, 2, 40), torch.float16),
    ((1, 64, 2, 36), torch.bfloat16),
])
def test_k1_wrapper_raises_instead_of_falling_back(cuda, shape, dtype):
    x = torch.randn(shape, device=cuda).to(dtype)
    with pytest.raises(ValueError):
        A.fused_self_attention(x, x, x, 0.1)
