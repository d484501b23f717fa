"""K1's wide class on the card: head dim 512, the image VAE's mid attention
(``csrc/attention_fwd.cu:attention_fwd_kernel_sm90_wide``).

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_k1_d512_card.py

The kernel is held against its plain PyTorch version
(``ops/attention.py:attention_reference``) at the shapes the image VAE
gives it: O within ``REL_TOL`` of max|O| (P and O are rounded to bf16 on
both sides, the sums run in another order), P itself (V = I at T = D =
512, so O is the rounded P) equal but for ``P_FLIPS`` of its entries, each
one bf16 ulp off, and two calls bit-equal. Without a card each test skips
in the ``cuda`` fixture.
"""

import math

import pytest
import torch

from ldmseg_torch.ops import attention as A

REL_TOL = 1.6e-2
P_FLIPS = 2e-4
# (B, T, H, D): the encode at 256x512 (a 32x64 map at the mid block), the
# bench's batch 16, and KITTI's 192x640 at the training batch 8
SHAPES = [(2, 2048, 1, 512), (16, 2048, 1, 512), (8, 1920, 1, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES + [(1, 100, 1, 512),
                                            (1, 65, 2, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_d512_matches_its_plain_version(cuda, shape):
    q, k, v = (_randn(shape, seed=i) for i in range(3))
    scale = 1.0 / math.sqrt(shape[3])
    before = (A.fused_self_attention.launches,
              A.fused_self_attention.wide_launches)
    out = A.fused_self_attention(q, k, v, scale)
    again = A.fused_self_attention(q, k, v, scale)
    torch.cuda.synchronize()
    # the wide class counts apart from K1's other classes
    assert (A.fused_self_attention.launches,
            A.fused_self_attention.wide_launches) == (before[0],
                                                      before[1] + 2)
    assert torch.equal(out, again)
    ref = A.attention_reference(q, k, v, scale)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    err = (out.float() - ref.float()).abs().max().item()
    peak = ref.float().abs().max().item()
    assert err <= REL_TOL * peak, f"{shape}: err {err}, max|O| {peak}"


@pytest.mark.gpu
def test_k1_d512_rounds_p_where_the_plain_version_does(cuda):
    t = d = 512
    q, k = (_randn((1, t, 1, d), seed=5 + i) for i in range(2))
    eye = torch.eye(t, device="cuda", dtype=torch.bfloat16)[None, :, None]
    scale = 1.0 / math.sqrt(d)
    p = A.fused_self_attention(q, k, eye, scale).float()
    p_ref = A.attention_reference(q, k, eye, scale).float()
    differ = p != p_ref
    ulp = torch.exp2(torch.floor(torch.log2(p_ref.clamp_min(1e-38))) - 7)
    assert bool(((p - p_ref).abs()[differ] <= ulp[differ] * 1.0001).all())
    assert int(differ.sum()) <= P_FLIPS * t * t


@pytest.mark.gpu
def test_k1_d512_refuses_a_backward_and_fp32(cuda):
    q, k, v = (_randn((1, 64, 1, 512), seed=i) for i in range(3))
    with pytest.raises(NotImplementedError, match="K2 takes up to 160"):
        A.fused_self_attention(q.requires_grad_(), k, v, 0.04)
    with pytest.raises(ValueError, match="up to 160"):
        A.fused_self_attention(q.detach().float(), k.float(), v.float(), 0.04)


@pytest.mark.gpu
def test_attention_block_2d_runs_k1_at_512_channels(cuda):
    from ldmseg_torch.models.layers import AttentionBlock2D, init_random_
    gen = torch.Generator(device="cuda").manual_seed(0)
    fused = AttentionBlock2D(512, use_fused=True).to(cuda)
    init_random_(fused, gen)
    fused = fused.to(torch.bfloat16).eval()
    plain = AttentionBlock2D(512).to(cuda).to(torch.bfloat16).eval()
    plain.load_state_dict(fused.state_dict())
    x = _randn((2, 512, 32, 64), seed=9)
    before = A.fused_self_attention.wide_launches
    with torch.no_grad():
        y = fused(x)
        y_plain = plain(x)
    torch.cuda.synchronize()
    assert A.fused_self_attention.wide_launches == before + 1
    assert torch.isfinite(y).all()
    err = (y.float() - y_plain.float()).abs().max().item()
    assert err <= REL_TOL * y_plain.float().abs().max().item(), err
