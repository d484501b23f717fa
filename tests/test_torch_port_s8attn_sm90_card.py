"""K13's attention stage on Hopper (``attn_s8pv_kernel_sm90``: the skeleton
of ``csrc/attention_sm90.cuh`` with an s8 e8·V product) and the products of
K11, K10 without ``v_bf16``, K17 and K18 on ``csrc/gemm_sm90.cuh``, on the
card: K13, K15, K11, K10, K17 and K18 through their wrappers.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_s8attn_sm90_card.py

Each entry point is held to its plain version at the int8 paths' shapes
and a ragged T with the tolerances of ``chip_smoke.py`` (``INT8_MAX_TOL``
1.6e-2 of max|ref|, two bf16 ulps; ``INT8_MEAN_TOL`` 2.5e-3 of mean|ref|: a
code e8 that ``ex2.approx`` flips next to a half, or a summation order,
moves a few outputs by a code's worth); two calls must be bit-equal; each
wrapper's counter moves by one per call. The new products' int32 sums must
equal ``torch._int_mm(a, w.t())``'s bit for bit at every shape the blocks
launch, and the per-head product its plain version's (the fp32 promotion
repeated in PyTorch, h = 0 first). Without a card each test skips in the
``cuda`` fixture.
"""

import pytest
import torch

from ldmseg_torch.ops import attention_s8 as S8
from ldmseg_torch.ops import gemm as G
from ldmseg_torch.ops import quant

from test_torch_port_gn_sm90_card import _true_div, check_code_flips

INT8_MAX_TOL, INT8_MEAN_TOL = 1.6e-2, 2.5e-3
HEADS = 8
# (B, T, C) of the int8 paths' launches in one UNet forward (batch 2, 32x64
# latent, 8 heads) and ragged ones the rules still send to the kernels
PATH = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280)]
RAGGED = [(1, 120, 320), (3, 24, 640), (1, 120, 1280), (2, 1000, 320)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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


def _twice(fn, *args):
    """Two calls of ``fn``, bit-equal, each moving its counter by one."""
    counter = fn.launches
    out = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == counter + 2
    assert torch.equal(out, again), "two calls differ"
    return out


def _attn(cuda, c, seed, heads=HEADS):
    from ldmseg_torch.models.layers import LayerNorm, init_random_
    from ldmseg_torch.models.unet import CrossAttention
    gen = torch.Generator(device=cuda).manual_seed(seed)
    mods = [LayerNorm(c), CrossAttention(c, heads)]
    for m in mods:
        m.to(cuda)
        init_random_(m, gen)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                          device=cuda))
    return mods


# ---- K13 and K15 -------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH + RAGGED)
@pytest.mark.parametrize("act", [0.1, None])
def test_k13_matches_plain_version(cuda, b, t, c, act):
    d = c // HEADS
    q, k, v = (_x(cuda, (b, t, HEADS, d), 7 + i) for i in range(3))
    if not S8.s8_takes_kernel(t):
        pytest.skip(f"T={t}: K13's rule sends it to the fallback")
    out = _twice(S8.fused_self_attention_s8, q, k, v, d ** -0.5, act)
    _close(out, S8.fused_self_attention_s8_reference(q, k, v, d ** -0.5,
                                                     act))


@pytest.mark.gpu
def test_k13_on_strided_head_views(cuda):
    # q, k, v as column slices of one [B, T, 3, H, D] buffer, fp32
    qkv = _x(cuda, (2, 512, 3, HEADS, 80), 3, torch.float32)
    q, k, v = qkv.unbind(2)
    out = _twice(S8.fused_self_attention_s8, q, k, v, 80 ** -0.5, None)
    _close(out, S8.fused_self_attention_s8_reference(q, k, v, 80 ** -0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH + RAGGED[:3])
def test_k15_matches_plain_version(cuda, b, t, c):
    q, k, v = (_x(cuda, (b, t, c), 17 + i) for i in range(3))
    scale = (c // HEADS) ** -0.5
    out = _twice(S8.fused_self_attention_packed_s8, q, k, v, HEADS, scale)
    _close(out, S8.fused_self_attention_packed_s8_reference(q, k, v, HEADS,
                                                            scale))


# ---- K11 and K10 -------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH + RAGGED)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k11_matches_plain_version(cuda, b, t, c, dtype):
    _, attn = _attn(cuda, c, t + c)
    pack = S8.pack_padded_attention(attn, HEADS, 0.05)
    x = _x(cuda, (b, t, c), 5, dtype)
    out = _twice(S8.padded_attention_s8, x, pack)
    _close(out, S8.padded_attention_s8_reference(x, pack).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH + RAGGED[:2])
def test_k10_s8_matches_plain_version(cuda, b, t, c):
    """K10 without ``v_bf16`` on random LN rows. Its LN + quantize
    (``s8_common.cuh:ln_quant``, K3's, K4's, K8's and K9's too) takes the
    plain version's rounding points but sums in a warp's order, so a code
    whose ``hn / xs`` lies next to a .5 may differ by one, and through the
    int8 ``to_out`` one code moves a row (2.5% of max|ref| at (2, 512,
    640), ``ROADMAP.md`` F2). So the codes are held to the plain ones per
    code (``check_code_flips``: +-1, at no more than ``LN_CODE_FLIPS`` of
    them, each within ``LN_TIE_ULPS`` ulps of a .5) and the output to the
    plain steps fed the kernel's own codes, at the tolerances above."""
    norm, attn = _attn(cuda, c, t + c + 1)
    pack = S8.pack_ln_attention_rowmajor(norm, attn, HEADS, 0.05)
    ln = pack.ln
    x = _x(cuda, (b, t, c), 6)
    out = _twice(S8.ln_attention_s8_rowmajor, x, pack, False)
    x8 = S8.ln_quant_s8(x, ln.ln_w, ln.ln_b, pack.padded.xs, ln.eps)
    hn = S8._layer_norm(x.float(), ln.ln_w, ln.ln_b, ln.eps)
    check_code_flips(x8, S8.ln_quant_reference(x, ln.ln_w, ln.ln_b,
                                               pack.padded.xs, ln.eps),
                     _true_div(hn, pack.padded.xs))
    _close(out, S8.ln_attention_s8_rowmajor_reference(x, pack, False, x8))


# ---- K17 and K18 -------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH + RAGGED)
@pytest.mark.parametrize("fullc", [False, True])
def test_k17_k18_match_plain_version(cuda, b, t, c, fullc):
    _, attn = _attn(cuda, c, t + c + 2)
    ws = [m.weight.float() for m in (attn.to_q, attn.to_k, attn.to_v,
                                     attn.to_out[0])]
    q8, k8, v8, o8, sc = (quant.quantize_fullc_weights(*ws) if fullc else
                          quant.quantize_head_weights(*ws, HEADS))
    w_qkv = torch.cat([q8, k8, v8]).contiguous()
    fn = (S8.absorbed_fullc_self_attention_s8 if fullc
          else S8.absorbed_self_attention_s8)
    x = _x(cuda, (b, t, c), 8)
    scale = (c // HEADS) ** -0.5
    wo_p = S8.head_padded_wo(o8, HEADS)
    out = _twice(fn, x, w_qkv, o8, sc, HEADS, scale, 0.1, wo_p)
    # the wrapper pads to_out itself when no pack hands it in
    assert torch.equal(out, fn(x, w_qkv, o8, sc, HEADS, scale, 0.1))
    _close(out, S8.absorbed_attention_s8_reference(
        x, w_qkv, o8, sc, HEADS, scale, 0.1, per_image=fullc))


# ---- the products ------------------------------------------------------------
def _products(b, t, c):
    """[rows, n, k] of the new one-operand s8 products at (B, T, C): K11's
    Q/K projection, its swapped V projection, its to_out, K17's
    projection."""
    rows = b * t
    return [(rows, 2 * c, c), (c, rows, c), (rows, c, c), (rows, 3 * c, c)]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n,k", sorted({s for b, t, c in PATH + RAGGED
                                             for s in _products(b, t, c)}))
def test_new_products_equal_int_mm(cuda, rows, n, k):
    gen = torch.Generator(device=cuda).manual_seed(rows + n + k)
    a = torch.randint(-127, 128, (rows, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    out = G.gemm_s8(a, w)
    assert torch.equal(out, torch._int_mm(a, w.t()))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", PATH + RAGGED)
def test_per_head_product_equals_plain_version(cuda, b, t, c):
    gen = torch.Generator(device=cuda).manual_seed(b + t + c)
    dp = S8.head_padded_width(c // HEADS)
    a = torch.randint(-127, 128, (b * t, HEADS * dp), generator=gen,
                      device=cuda, dtype=torch.int8)
    w = S8.head_padded_wo(torch.randint(-127, 128, (c, c), generator=gen,
                                        device=cuda, dtype=torch.int8), HEADS)
    f = torch.rand((b, HEADS), generator=gen, device=cuda) * 1e-3
    before = G.gemm_s8_heads.launches
    out = G.gemm_s8_heads(a, w, f, HEADS)
    assert G.gemm_s8_heads.launches == before + 1
    # each head's int32 sums as torch._int_mm gives them, promoted in order
    ref = torch.zeros_like(out)
    fr = f.repeat_interleave(t, dim=0)
    for h in range(HEADS):
        c32 = torch._int_mm(a[:, h * dp:(h + 1) * dp].contiguous(),
                            w[:, h * dp:(h + 1) * dp].contiguous().t())
        ref = ref + c32.float() * fr[:, h:h + 1]
    assert torch.equal(out, ref)


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    q = _x(cuda, (1, 64, 2, 192), 1)
    with pytest.raises(ValueError):       # d = 192 > 160
        S8.fused_self_attention_s8(q, q, q, 0.1, 0.1)
    q = _x(cuda, (1, 64, 2, 64), 1)
    with pytest.raises(ValueError):       # a negative scale
        S8.fused_self_attention_s8(q, q, q, -0.1, 0.1)
    _, attn = _attn(cuda, 72, 3, 1)       # C = 72: not a multiple of 16
    pack = S8.pack_padded_attention(attn, 1, 0.05)
    with pytest.raises(ValueError):
        S8.padded_attention_s8(_x(cuda, (1, 64, 72), 2), pack)
