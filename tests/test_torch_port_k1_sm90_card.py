"""K1's bf16 kernel on Hopper (``attention_fwd_kernel_sm90``) on the card.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_*.py

Every case holds the kernel against its plain PyTorch version at
``BF16_ATOL`` (two bf16 ulps at 1.0: P and O are rounded to bf16 on both
sides, the sums run in another order) and checks that the wrapper's launch
counter moved by exactly one per call. Without a card each test skips in
the ``cuda`` fixture.
"""

import pytest
import torch

from ldmseg_torch.ops import attention as A

BF16_ATOL = 1.6e-2
HEAD_DIMS = list(range(8, 161, 8))
EDGE_T = (1, 30, 63, 64, 65, 100, 127, 128, 129)
# (B, T, H, D) of K1 on the sampling path (batch 2, 32x64 latent) and the
# training path (batch 8, 24x80 latent)
PATH_SHAPES = [(2, 2048, 8, 40), (2, 512, 8, 80), (2, 128, 8, 160),
               (2, 32, 8, 160), (8, 1920, 8, 40), (8, 480, 8, 80),
               (8, 120, 8, 160), (8, 30, 8, 160)]
# (B, T, C) of K14 and K16 at 8 heads, sampling and training
PACKED_SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280),
                 (2, 32, 1280), (8, 1920, 320), (8, 480, 640),
                 (8, 120, 1280)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(
        torch.bfloat16)


def _check_k1(q, k, v, scale):
    before = A.fused_self_attention.launches
    out = A.fused_self_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert A.fused_self_attention.launches == before + 1
    ref = A.attention_reference(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= BF16_ATOL, f"{tuple(q.shape)}: max abs err {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k1_sm90_every_head_dim_at_the_tile_edges(cuda, d):
    for t in EDGE_T:
        q, k, v = (_randn((1, t, 2, d), seed=t * 3 + i) for i in range(3))
        _check_k1(q, k, v, d ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_sm90_at_the_path_shapes(cuda, shape):
    q, k, v = (_randn(shape, seed=i) for i in range(3))
    _check_k1(q, k, v, shape[3] ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PACKED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k14_sm90_on_the_packed_view(cuda, shape):
    q, k, v = (_randn(shape, seed=10 + i) for i in range(3))
    scale = (shape[2] // 8) ** -0.5
    before = A.fused_self_attention_packed.launches
    out = A.fused_self_attention_packed(q, k, v, 8, scale)
    torch.cuda.synchronize()
    assert A.fused_self_attention_packed.launches == before + 1
    ref = A.packed_attention_reference(q, k, v, 8, scale)
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(2, 512, 640), (1, 100, 320)])
def test_k1_sm90_reads_column_slices_of_one_qkv_buffer(cuda, b, t, c):
    # q, k, v as the three column slices of a fused [B, T, 3C] projection
    qkv = _randn((b, t, 3 * c), seed=7)
    q, k, v = (x.unflatten(-1, (8, c // 8)) for x in qkv.split(c, dim=-1))
    assert not q.is_contiguous()
    _check_k1(q, k, v, (c // 8) ** -0.5)


@pytest.mark.gpu
def test_k1_sm90_reads_a_head_major_view(cuda):
    # [B, H, T, D] storage seen as [B, T, H, D]: the T stride is below H's
    q, k, v = (_randn((2, 8, 128, 40), seed=20 + i).transpose(1, 2)
               for i in range(3))
    _check_k1(q, k, v, 40 ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_k1_sm90_scores_near_80_stay_finite(cuda, sign):
    # q = 4 k on unit rows: logits of about +-80 after the scale
    shape = (1, 256, 2, 64)
    k = _randn(shape, seed=30)
    k = (k.float() / k.float().norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    q = (sign * 8.0 * k.float()).to(torch.bfloat16)
    v = _randn(shape, seed=31)
    _check_k1(q, k, v, 10.0)


@pytest.mark.gpu
def test_k1_sm90_takes_a_negative_scale(cuda):
    q, k, v = (_randn((1, 200, 2, 40), seed=40 + i) for i in range(3))
    _check_k1(q, k, v, -40 ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PACKED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k16_sm90_attention_stage(cuda, shape):
    b, t, c = shape
    x = _randn(shape, seed=50)
    ws = [_randn((c, c), seed=51 + i, scale=0.05) for i in range(4)]
    before = A.absorbed_self_attention.launches
    out = A.absorbed_self_attention(x, *ws, 8, (c // 8) ** -0.5)
    torch.cuda.synchronize()
    assert A.absorbed_self_attention.launches == before + 1
    ref = A.absorbed_attention_reference(x, *ws, 8, (c // 8) ** -0.5)
    rmax = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= BF16_ATOL * rmax
