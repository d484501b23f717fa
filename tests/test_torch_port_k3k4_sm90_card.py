"""K3 and K4 on Hopper (the TMA + ``wgmma`` products of
``csrc/gemm_sm90.cuh`` and K3's ``attn_s8_kernel_sm90``) on the card, with
K8, K9, K10 and K12, which run the same launch functions.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_k3k4_sm90_card.py

The products' int32 sums must equal ``torch._int_mm``'s bit for bit (int8
sums are exact), their fp32 sums ``torch.matmul``'s of the same bf16 values
within 1e-4 of max|ref| (another summation order). The blocks are held to
their plain versions with the tolerances of ``chip_smoke.py``
(``INT8_MAX_TOL`` 1.6e-2 of max|ref|, two bf16 ulps: the exponentials and
the summation orders differ; ``INT8_MEAN_TOL`` 2.5e-3 of mean|ref|: a rare
int8 code that a summation order flips moves a few outputs by a code's
worth), two calls must be bit-equal, and each wrapper's launch counter must
move by one per call. Without a card each test skips in the ``cuda``
fixture.
"""

import dataclasses

import pytest
import torch

from ldmseg_torch.ops import attention_s8 as K3
from ldmseg_torch.ops import geglu as K4
from ldmseg_torch.ops import gemm as G
from ldmseg_torch.ops.quant import int8_matmul

INT8_MAX_TOL, INT8_MEAN_TOL = 1.6e-2, 2.5e-3
# (B, T, C) of K3's and K4's launches in one int8 UNet forward (batch 2,
# 32x64 latent, 8 heads)
PATH_SHAPES = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280),
               (2, 32, 1280)]
# ragged T: 30 and 100 (T % 8) go to the fallbacks; 120, 1920 and 1024
# take the kernels where each rule does (K4's: T % min(512, T))
RAGGED = [(1, 30, 320), (1, 100, 320), (3, 120, 320), (1, 1920, 320),
          (1, 1024, 320), (3, 32, 640)]
# [rows, n, k] of every one-operand product of K3 and K4 at the path shapes
# (and K4's up over its 2M rows as one operand), and ragged ones
PRODUCT_SHAPES = [(4096, 960, 320), (1024, 1920, 640), (256, 3840, 1280),
                  (64, 3840, 1280), (4096, 2560, 320), (1024, 5120, 640),
                  (256, 10240, 1280), (64, 10240, 1280), (4096, 320, 1280),
                  (1024, 640, 2560), (256, 1280, 5120), (64, 1280, 5120),
                  (4096, 320, 320), (1024, 640, 640), (256, 1280, 1280),
                  (100, 136, 48), (17, 8, 16), (4100, 968, 336),
                  (3, 24, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _modules(cuda, c, heads, seed):
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


def _conv(cuda, c, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    conv = torch.nn.Conv2d(c, c, 1).to(cuda)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen,
                                      device=cuda) * c ** -0.5)
        conv.bias.copy_(0.05 * torch.randn(c, generator=gen, device=cuda))
    return conv


def _x(cuda, shape, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=cuda).to(dtype)


def _close(out, ref):
    err = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out).all())
    emax, rmax = err.max().item(), ref.float().abs().max().item()
    emean, rmean = err.mean().item(), ref.float().abs().mean().item()
    assert emax <= INT8_MAX_TOL * rmax, f"max err {emax} of {rmax}"
    assert emean <= INT8_MEAN_TOL * rmean, f"mean err {emean} of {rmean}"


def _run(fn, x, pack, ref_fn, fallback_fn, takes):
    """One call of the wrapper ``fn``: a launch (held to ``ref_fn``) where
    the rule takes the shape, else a fallback (held to ``fallback_fn``)."""
    before = (fn.launches, fn.fallbacks)
    out = fn(x, pack)
    torch.cuda.synchronize()
    if takes:
        assert (fn.launches, fn.fallbacks) == (before[0] + 1, before[1])
        _close(out, ref_fn(x, pack).to(out.dtype))
    else:
        assert (fn.launches, fn.fallbacks) == (before[0], before[1] + 1)
        torch.testing.assert_close(out, fallback_fn(x, pack))
    return out


# ---- the product -----------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", PRODUCT_SHAPES)
def test_gemm_s8_equals_int_mm(cuda, rows, n, k):
    gen = torch.Generator(device=cuda).manual_seed(rows + n + k)
    a = torch.randint(-127, 128, (rows, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    before = G.gemm_s8.launches
    out = G.gemm_s8(a, w)
    torch.cuda.synchronize()
    assert G.gemm_s8.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (rows, n)
    # torch._int_mm on w's transposed view, as ops/quant.py runs it (rows
    # <= 16 padded there)
    assert torch.equal(out, int8_matmul(a, w))


# [rows, n, k] of K4's up product at the path shapes (n = M: two operands,
# W1's h and gate rows, 2M rows in all), and ragged ones
UP_SHAPES = [(4096, 1280, 320), (1024, 2560, 640), (256, 5120, 1280),
             (64, 5120, 1280), (100, 136, 48), (4100, 968, 336), (3, 24, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", UP_SHAPES)
def test_gemm_s8_two_operands_equals_int_mm(cuda, rows, n, k):
    gen = torch.Generator(device=cuda).manual_seed(rows + n + k)
    a = torch.randint(-127, 128, (rows, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (2 * n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    assert G.sm90_gemm_plan(rows, n, k, "int8", 2).operands == 2
    out = G.gemm_s8(a, w, operands=2)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32 and out.shape == (rows, 2 * n)
    assert torch.equal(out, int8_matmul(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", [(4096, 320, 320), (1024, 640, 640),
                                      (256, 1280, 1280), (64, 1280, 1280),
                                      (100, 136, 48), (3, 24, 8)])
def test_gemm_bf16_matches_matmul(cuda, rows, n, k):
    a = _x(cuda, (rows, k), 1)
    w = _x(cuda, (n, k), 2)
    out = G.gemm_bf16(a, w)
    ref = a.float() @ w.float().t()
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item()


@pytest.mark.gpu
def test_gemm_wrappers_raise_on_shapes_the_plan_refuses(cuda):
    a = torch.zeros((64, 40), dtype=torch.int8, device=cuda)  # k % 16
    with pytest.raises(ValueError):
        G.gemm_s8(a, torch.zeros((64, 40), dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError):   # n % 8
        G.gemm_bf16(torch.zeros((64, 64), dtype=torch.bfloat16, device=cuda),
                    torch.zeros((12, 64), dtype=torch.bfloat16, device=cuda))


# ---- K3, K8, K10 -----------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", PATH_SHAPES + RAGGED)
def test_k3_matches_plain_version(cuda, b, t, c, dtype):
    norm1, attn, _, _ = _modules(cuda, c, 8, 0)
    pack = K3.pack_ln_attention(norm1, attn, 8, 0.1)
    x = _x(cuda, (b, t, c), 1, dtype)
    takes = K3.absorbed_takes_kernel(t, c, 8)
    out = _run(K3.ln_attention_s8, x, pack, K3.ln_attention_s8_reference,
               K3.ln_attention_s8_fallback, takes)
    assert out.dtype == dtype and out.shape == x.shape


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH_SHAPES + [(3, 120, 320),
                                                 (1, 1920, 320)])
def test_k8_and_k10_match_plain_versions(cuda, b, t, c):
    norm1, attn, _, _ = _modules(cuda, c, 8, 0)
    p8 = K3.with_proj_in(K3.pack_ln_attention(norm1, attn, 8, 0.1),
                         _conv(cuda, c, 1))
    x = _x(cuda, (b, c, t), 2).transpose(1, 2)   # the GroupNorm's tokens
    _run(K3.ln_attention_s8_pin, x, p8, K3.ln_attention_s8_pin_reference,
         None, True)
    p10 = K3.pack_ln_attention_rowmajor(norm1, attn, 8, 0.1)
    xt = x.contiguous()
    before = K3.ln_attention_s8_rowmajor.launches
    out = K3.ln_attention_s8_rowmajor(xt, p10, True)
    torch.cuda.synchronize()
    assert K3.ln_attention_s8_rowmajor.launches == before + 1
    _close(out, K3.ln_attention_s8_rowmajor_reference(xt, p10, True))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH_SHAPES)
def test_k3_two_calls_bit_equal(cuda, b, t, c):
    norm1, attn, _, _ = _modules(cuda, c, 8, 3)
    pack = K3.pack_ln_attention(norm1, attn, 8, 0.1)
    x = _x(cuda, (b, t, c), 4)
    assert torch.equal(K3.ln_attention_s8(x, pack),
                       K3.ln_attention_s8(x, pack))


@pytest.mark.gpu
def test_k3_wrappers_raise_on_what_the_kernels_refuse(cuda):
    norm1, attn, _, _ = _modules(cuda, 320, 8, 5)
    pack = K3.pack_ln_attention(norm1, attn, 8, 0.1)
    x = _x(cuda, (1, 64, 320), 6)
    for bad in (0.0, -0.1):
        with pytest.raises(ValueError):   # the int32 row max needs scale > 0
            K3.ln_attention_s8(x, dataclasses.replace(pack, score_scale=bad))
    norm1, attn, _, _ = _modules(cuda, 24, 3, 5)   # d = 8, C % 16 != 0
    with pytest.raises(ValueError):
        K3.ln_attention_s8(_x(cuda, (1, 64, 24), 6),
                           K3.pack_ln_attention(norm1, attn, 3, 0.1))


# ---- K4, K9, K12 -----------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("b,t,c", PATH_SHAPES + RAGGED)
def test_k4_and_k12_match_plain_versions(cuda, b, t, c, static, dtype):
    _, _, norm3, ff = _modules(cuda, c, 8, 2)
    pack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05,
                         0.02 if static else None)
    x = _x(cuda, (b, t, c), 3, dtype)
    takes = K4.takes_kernel(t)
    out = _run(K4.geglu_ln_s8, x, pack, K4.geglu_ln_s8_reference,
               K4.geglu_ln_s8_fallback, takes)
    assert out.dtype == dtype and out.shape == x.shape
    _run(K4.fused_geglu_s8, x, pack, K4.geglu_s8_reference,
         K4.geglu_s8_fallback, takes)


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("b,t,c", PATH_SHAPES + [(3, 120, 320)])
def test_k9_matches_plain_version(cuda, b, t, c, static):
    _, _, norm3, ff = _modules(cuda, c, 8, 2)
    pack = K4.with_proj_out(
        K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05,
                      0.02 if static else None), _conv(cuda, c, 3))
    _run(K4.geglu_ln_s8_pout, _x(cuda, (b, t, c), 4), pack,
         K4.geglu_ln_s8_pout_reference, None, True)


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("b,t,c", PATH_SHAPES)
def test_k4_two_calls_bit_equal(cuda, b, t, c, static):
    _, _, norm3, ff = _modules(cuda, c, 8, 7)
    pack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05,
                         0.02 if static else None)
    x = _x(cuda, (b, t, c), 8)
    assert torch.equal(K4.geglu_ln_s8(x, pack), K4.geglu_ln_s8(x, pack))


@pytest.mark.gpu
def test_k4_wrappers_raise_on_what_the_products_refuse(cuda):
    _, _, norm3, ff = _modules(cuda, 24, 3, 5)   # C % 16 != 0
    pack = K4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05)
    x = _x(cuda, (1, 64, 24), 6)
    with pytest.raises(ValueError):
        K4.geglu_ln_s8(x, pack)
    with pytest.raises(ValueError):
        K4.fused_geglu_s8(x, pack)
