"""K16's projections and K8's ``proj_in`` prologue on the Hopper product
(``csrc/gemm_sm90.cuh``) on the card: K16's Q, K and V in one launch over
three weight maps and its ``to_out``, K8's prologue with x as tokens and
channel-major.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_k16k8_sm90_card.py

K16 is held to its plain version with ``chip_smoke.py``'s tolerance (two
bf16 ulps of max|ref|: q, k, v, P, oh and the output round at the same
points, the sums run in another order; fp32 1e-4), its gradients through
K2 to autograd through the plain version at twice that; K8 to its plain
version with K3's (``INT8_MAX_TOL`` of max|ref|, ``INT8_MEAN_TOL`` of
mean|ref|); the prologue alone to ``torch.matmul`` in fp32 with TF32 off
within 1e-4 of max|ref| (the products of bf16 values are exact in fp32,
the sums run in another order). Two calls must be bit-equal and each
wrapper's launch counter must move by one per call. Without a card each
test skips in the ``cuda`` fixture.
"""

import ctypes

import pytest
import torch

from ldmseg_torch.ops import attention as A
from ldmseg_torch.ops import attention_s8 as S8
from ldmseg_torch.ops import gemm as G

BF16_TOL, FP32_TOL = 1.6e-2, 1e-4
INT8_MAX_TOL, INT8_MEAN_TOL = 1.6e-2, 2.5e-3
# (B, T, C) of K16's calls: the sampling forward and the training forward
K16_SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280),
              (8, 1920, 320), (8, 480, 640), (8, 120, 1280)]
# (B, T, C) of K8's calls in one int8 forward, and a T = 120 (the KITTI
# latent's third level) and another T = 32 whose last row tile is part empty
K8_SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280),
             (3, 120, 320), (1, 32, 640)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _absorbed_case(cuda, b, t, c, dtype, seed):
    """x and four [C, C] weights at the scale of a trained projection."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(dtype)
    ws = [(0.05 * torch.randn((c, c), generator=gen, device=cuda)).to(dtype)
          for _ in range(4)]
    return x, ws


def _within(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    bound = tol * want.float().abs().max().item()
    assert bool(torch.isfinite(got).all()) and err <= bound, (err, bound)


# ---- K16 -------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", K16_SHAPES)
def test_k16_bf16_matches_plain_version_and_repeats(cuda, b, t, c):
    x, ws = _absorbed_case(cuda, b, t, c, torch.bfloat16, 21)
    scale = (c // 8) ** -0.5
    before = A.absorbed_self_attention.launches
    got = A._absorbed_forward(x, *ws, 8, scale)
    torch.cuda.synchronize()
    assert A.absorbed_self_attention.launches == before + 1
    want = A._absorbed_reference_parts(x, *ws, 8, scale)
    # out, then q, k, v (each bf16 of its fp32 sum) and oh
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == x.shape
        _within(g, w, BF16_TOL)
    # q, k, v and oh: four views of one allocation
    q, oh = got[1], got[4]
    assert q.untyped_storage().data_ptr() == oh.untyped_storage().data_ptr()
    again = A._absorbed_forward(x, *ws, 8, scale)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(2, 512, 640), (8, 120, 1280),
                                   (1, 64, 80)])
def test_k16_fp32_matches_plain_version(cuda, b, t, c):
    heads = 8 if c % 64 == 0 else 2
    x, ws = _absorbed_case(cuda, b, t, c, torch.float32, 22)
    scale = (c // heads) ** -0.5
    out = A.absorbed_self_attention(x, *ws, heads, scale)
    _within(out, A.absorbed_attention_reference(x, *ws, heads, scale),
            FP32_TOL)


@pytest.mark.gpu
def test_k16_bf16_with_column_tiles_cut_short(cuda):
    # C = 80 (2 heads of 40): no tile width divides it, so each map's last
    # column tile is masked
    x, ws = _absorbed_case(cuda, 2, 64, 80, torch.bfloat16, 23)
    got = A._absorbed_forward(x, *ws, 2, 40 ** -0.5)
    want = A._absorbed_reference_parts(x, *ws, 2, 40 ** -0.5)
    for g, w in zip(got, want):
        _within(g, w, BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(8, 480, 640), (8, 120, 1280),
                                   (2, 128, 1280), (1, 64, 320)])
def test_k16_differentiates_through_k2(cuda, b, t, c):
    x, ws = _absorbed_case(cuda, b, t, c, torch.bfloat16, 24)
    g = torch.randn((b, t, c), generator=torch.Generator(
        device=cuda).manual_seed(25), device=cuda).to(torch.bfloat16)
    scale = (c // 8) ** -0.5
    leaves = [z.clone().requires_grad_(True) for z in (x, *ws)]
    fwd, bwd = (A.absorbed_self_attention.launches,
                A.fused_self_attention_backward.launches)
    A.absorbed_self_attention(*leaves, 8, scale).backward(g)
    assert (A.absorbed_self_attention.launches,
            A.fused_self_attention_backward.launches) == (fwd + 1, bwd + 1)
    plain = [z.clone().requires_grad_(True) for z in (x, *ws)]
    A.absorbed_attention_reference(*plain, 8, scale).backward(g)
    for leaf, ref in zip(leaves, plain):
        assert leaf.grad.dtype == torch.bfloat16
        _within(leaf.grad, ref.grad, 2 * BF16_TOL)


@pytest.mark.gpu
def test_k16_raises_on_what_it_refuses(cuda):
    x, ws = _absorbed_case(cuda, 1, 64, 384, torch.bfloat16, 26)
    with pytest.raises(ValueError):      # d = 192
        A.absorbed_self_attention(x, *ws, 2, 0.1)
    with pytest.raises(ValueError):      # float16
        A.absorbed_self_attention(x.half(), *(w.half() for w in ws), 8, 0.1)
    with pytest.raises(ValueError):      # a weight of another shape
        A.absorbed_self_attention(x, *ws[:3], ws[3][:, :320], 8, 0.1)
    # a plan the C side refuses: an error code, no launch
    plans = list(A._absorbed_plans_c(1, 64, 384, 8))
    plans[9 + 8] += 1                     # the Q/K/V product's grid_y
    bufs = [torch.empty_like(x) for _ in range(5)]
    err = A._absorbed_kernel()(
        1, x.device.index, x.data_ptr(), *(w.data_ptr() for w in ws),
        *(z.data_ptr() for z in bufs), 1, 64, 384, 8, 0.1,
        (ctypes.c_int * len(plans))(*plans),
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


# ---- K8 --------------------------------------------------------------------
def _k8_pack(cuda, c, seed, proj_scale=1.0):
    """K8's pack from a block's seeded LayerNorm and attention (the init
    plus 0.05 noise on every parameter) and a 1x1 ``proj_in`` of weight
    std ``proj_scale`` / sqrt(C) and bias std 0.05, as the K3/K4 card
    tests build them."""
    from ldmseg_torch.models.layers import LayerNorm, init_random_
    from ldmseg_torch.models.unet import CrossAttention
    gen = torch.Generator(device=cuda).manual_seed(seed)
    norm, attn = LayerNorm(c), CrossAttention(c, 8)
    for m in (norm, attn):
        m.to(cuda)
        init_random_(m, gen)
        with torch.no_grad():
            for p in m.parameters():   # not the init's unit scales, 0 biases
                p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                          device=cuda))
    conv = torch.nn.Conv2d(c, c, 1).to(cuda)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device=cuda) * proj_scale * c ** -0.5)
        conv.bias.copy_(0.05 * torch.randn(c, generator=gen, device=cuda))
    return S8.with_proj_in(S8.pack_ln_attention(norm, attn, 8, 0.1), conv)


def _x_bct(cuda, b, t, c, seed):
    """The GroupNorm's tokens view: [B, T, C] over a contiguous [B, C, T]."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((b, c, t), generator=gen, device=cuda).to(
        torch.bfloat16).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["channels", "tokens"])
@pytest.mark.parametrize("b,t,c", K8_SHAPES)
def test_k8_matches_plain_version(cuda, b, t, c, layout):
    pack = _k8_pack(cuda, c, 31)
    x = _x_bct(cuda, b, t, c, 32)
    if layout == "tokens":
        x = x.contiguous()
    before = S8.ln_attention_s8_pin.launches
    out = S8.ln_attention_s8_pin(x, pack)
    torch.cuda.synchronize()
    assert S8.ln_attention_s8_pin.launches == before + 1
    ref = S8.ln_attention_s8_pin_reference(x, pack)
    err = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out).all())
    assert err.max().item() <= INT8_MAX_TOL * ref.float().abs().max().item()
    assert err.mean().item() <= INT8_MEAN_TOL * ref.float().abs().mean(
    ).item()
    assert torch.equal(out, S8.ln_attention_s8_pin(x, pack))


# At twice that proj_in scale the residual stream xf is twice as large, and
# the fp32 summation order of the prologue (1e-6 of max|xf|) flips LN +
# quantize codes whose effect, amplified through the block, reaches 0.28 of
# max|ref| 16.1 at (2, 128, 1280): 238 outputs above 0.1, the mean within
# INT8_MEAN_TOL; the parent's wmma prologue gives the same numbers. The
# kernel is held there to the plain steps fed its own xf, where the
# summation order of the prologue is no longer in the comparison.
@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(2, 128, 1280), (2, 32, 1280)])
def test_k8_at_a_larger_proj_in_matches_plain_steps_on_its_xf(cuda, b, t, c):
    pack = _k8_pack(cuda, c, 37, proj_scale=2.0)
    x = _x_bct(cuda, b, t, c, 38)
    out = S8.ln_attention_s8_pin(x, pack)
    xf = S8.proj_in_f32(x, pack)
    ref = S8.ln_attention_s8_reference(xf.reshape(b, t, c), pack)
    err = (out.float() - ref.float()).abs()
    assert err.max().item() <= INT8_MAX_TOL * ref.float().abs().max().item()
    assert err.mean().item() <= INT8_MEAN_TOL * ref.float().abs().mean(
    ).item()


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["channels", "tokens"])
@pytest.mark.parametrize("b,t,c", K8_SHAPES + [(8, 1920, 320),
                                               (8, 480, 640)])
def test_k8_prologue_alone_matches_matmul_in_fp32(cuda, b, t, c, layout):
    pack = _k8_pack(cuda, c, 33)
    x = _x_bct(cuda, b, t, c, 34)
    if layout == "tokens":
        x = x.contiguous()
    xf = S8.proj_in_f32(x, pack)
    ref = (torch.matmul(x.float().reshape(b * t, c), pack.wpi.float().t())
           + pack.bpi)
    assert xf.shape == (b * t, c) and xf.dtype == torch.float32
    _within(xf, ref, FP32_TOL)
    assert torch.equal(xf, S8.proj_in_f32(x, pack))


@pytest.mark.gpu
def test_k8_raises_on_what_it_refuses(cuda):
    pack = _k8_pack(cuda, 320, 35)
    x = _x_bct(cuda, 1, 64, 320, 36)
    with pytest.raises(ValueError):      # the prologue's operand is bf16
        S8.ln_attention_s8_pin(x.float(), pack)
    with pytest.raises(ValueError):      # a pack without proj_in
        S8.ln_attention_s8_pin(x, S8.LNAttentionPack(
            **{**pack.__dict__, "wpi": None, "bpi": None}))
    with pytest.raises(ValueError):
        S8.proj_in_f32(x.float(), pack)
    # a plan the C side refuses: an error code, no launch
    plan = list(G.plans_c(S8.proj_in_plan(1, 64, 320, True)))
    plan[7] += 1                          # grid_x
    xf = torch.empty((64, 320), dtype=torch.float32, device=cuda)
    err = S8._proj_in_kernel()(
        1, x.data_ptr(), pack.wpi.data_ptr(), pack.bpi.data_ptr(),
        xf.data_ptr(), 1, 64, 320, (ctypes.c_int * 9)(*plan),
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
