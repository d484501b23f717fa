"""K5 and K6 on Hopper (one thread-block cluster per (image, group) span,
``csrc/groupnorm_silu.cu``), K7 beside them, and the int8 blocks' LN +
quantize stage (``csrc/s8_common.cuh:ln_quant_kernel``, fault F2) on the
card.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gn_sm90_card.py

K5 is held to its plain version within 1.6e-2 of max|ref| in bf16 (two bf16
ulps: the sums run in another order) and 1e-5 in fp32, K6's scale within
rtol 1e-5 and its codes equal but for +-1 at no more than 1e-3 of them (a
.5 tie that the summation order moves), K7 within 2e-2 (``chip_smoke.py``'s
gates), at every shape class of the UNet's 44 resnet norms (batch 2 on a
32x64 latent, batch 8 on 24x80), on the scalar path and at every cluster
size the plan picks; two calls bit-equal; the trace shows one kernel per K5
call and two per K6 call.

The LN + quantize stage (``ops/attention_s8.py:ln_quant_s8``) on random LN
rows of K3's, K4's and K10's packs: its codes equal
:func:`ln_quant_warp_model` (the kernel's order of the sums in PyTorch) bit
for bit; given the kernel's variance, ``torch.rsqrt`` gives the kernel's r
bit for bit; against the plain version (PyTorch's order of the sums) a code
differs by one at no more than ``LN_CODE_FLIPS`` of them, and only where the
plain ``hn / xs`` lies within ``LN_TIE_ULPS`` ulps of a .5. Without a card
each test skips in the ``cuda`` fixture.
"""

import pytest
import torch

from ldmseg_torch.ops import attention_s8 as S8
from ldmseg_torch.ops import geglu as G4
from ldmseg_torch.ops import gn_silu_conv as GC
from ldmseg_torch.ops import groupnorm_silu as GN

GN_BF16_TOL, GN_FP32_TOL, GN_CONV_TOL, GN_CODE_FLIPS = 1.6e-2, 1e-5, 2e-2, 1e-3
# the LN + quantize codes against the plain version: the share of codes a
# summation order flips, and how near a .5 the plain hn / xs must lie
LN_CODE_FLIPS, LN_TIE_ULPS = 1e-4, 8
# (B, C, H, W) of every shape class of the 44 resnet norms of one UNet
# forward at batch 2 on a 32x64 latent, and of a train step's at batch 8 on
# 24x80 (tools/profile_gn.py:site_shapes), and ragged ones on the scalar
# path (C/G * H * W = 70 and 189: no 16-byte access)
SAMPLING = [(2, 320, 32, 64), (2, 640, 32, 64), (2, 960, 32, 64),
            (2, 320, 16, 32), (2, 640, 16, 32), (2, 960, 16, 32),
            (2, 1280, 16, 32), (2, 1920, 16, 32), (2, 640, 8, 16),
            (2, 1280, 8, 16), (2, 1920, 8, 16), (2, 2560, 8, 16),
            (2, 1280, 4, 8), (2, 2560, 4, 8)]
TRAINING = [(8, c, 24 * h // 32, 80 * w // 64) for _, c, h, w in SAMPLING]
SCALAR = [(1, 64, 5, 7), (2, 96, 7, 9)]
# one image whose spans the plan gives 6, 7 and 8 CTAs (the others' sizes,
# 1 to 5 and 8, come with the UNet's shapes); the last at the 8 MiB rule's
# edge, C * H * W = 2^21
CLUSTERS = [(1, 1408, 32, 32), (1, 1664, 32, 32), (1, 2048, 32, 32)]
SHAPES = SAMPLING + TRAINING + SCALAR + CLUSTERS
DTYPES = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]
# (B, T, C) of K3's, K4's and K10's launches in one int8 UNet forward
INT8_PATH = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gn_inputs(dev, shape, dtype, affine, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = (1.5 * torch.randn(shape, generator=gen, device=dev) + 0.3).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x, scale.to(affine), bias.to(affine)


def _twice(fn, *args):
    """Two calls of ``fn`` bit-equal, its counter moved by two."""
    before = fn.launches
    out = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    for a, b in zip(*((o if isinstance(o, tuple) else (o,))
                      for o in (out, again))):
        assert torch.equal(a, b), "two calls differ"
    return out


# ---- K5 and K6 --------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,affine", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_k5_matches_plain_version(cuda, shape, dtype, affine):
    x, scale, bias = _gn_inputs(cuda, shape, dtype, affine, 0)
    out = _twice(GN.group_norm_silu, x, scale, bias, 32, 1e-5)
    assert out.dtype == dtype and out.shape == x.shape
    ref = GN.group_norm_silu_reference(x, scale, bias, 32, 1e-5)
    tol = GN_BF16_TOL if dtype == torch.bfloat16 else GN_FP32_TOL
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,affine", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_k6_matches_plain_version(cuda, shape, dtype, affine):
    x, scale, bias = _gn_inputs(cuda, shape, dtype, affine, 1)
    q, s = _twice(GN.group_norm_silu_quant, x, scale, bias, 32, 1e-6)
    assert q.dtype == torch.int8 and q.shape == x.shape
    assert s.dtype == torch.float32 and s.shape == (shape[0],)
    rq, rs = GN.group_norm_silu_quant_reference(x, scale, bias, 32, 1e-6)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=0)
    diff = (q.int() - rq.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= GN_CODE_FLIPS * q.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,affine", DTYPES[:1] + DTYPES[2:3])
@pytest.mark.parametrize("groups", [16, 8])
def test_k5_k6_take_rounds_where_a_span_outgrows_the_cluster(cuda, groups,
                                                             dtype, affine):
    """At the 8 MiB rule's edge with fewer than 32 groups a span outgrows
    8 CTAs' registers: each CTA holds its slice in rounds (the plan's
    ``rounds`` > 1) and reads it twice."""
    shape = (1, 2048, 32, 32)
    assert GN.sm90_gn_plan(1, 2048, 1024, groups, dtype).rounds > 1
    x, scale, bias = _gn_inputs(cuda, shape, dtype, affine, 7)
    out = _twice(GN.group_norm_silu, x, scale, bias, groups, 1e-5)
    ref = GN.group_norm_silu_reference(x, scale, bias, groups, 1e-5)
    tol = GN_BF16_TOL if dtype == torch.bfloat16 else GN_FP32_TOL
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    q, s = _twice(GN.group_norm_silu_quant, x, scale, bias, groups, 1e-5)
    rq, rs = GN.group_norm_silu_quant_reference(x, scale, bias, groups, 1e-5)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=0)
    diff = (q.int() - rq.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= GN_CODE_FLIPS * q.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_k6_on_a_misaligned_view_take_the_scalar_path(cuda, dtype):
    shape = (2, 320, 16, 32)
    x, scale, bias = _gn_inputs(cuda, shape, dtype, torch.float32, 2)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    view = buf[1:].view(shape).copy_(x)   # contiguous, not 16-byte aligned
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    out = _twice(GN.group_norm_silu, view, scale, bias, 32, 1e-5)
    ref = GN.group_norm_silu_reference(x, scale, bias, 32, 1e-5)
    tol = GN_BF16_TOL if dtype == torch.bfloat16 else GN_FP32_TOL
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err
    q, s = _twice(GN.group_norm_silu_quant, view, scale, bias, 32, 1e-5)
    rq, rs = GN.group_norm_silu_quant_reference(x, scale, bias, 32, 1e-5)
    torch.testing.assert_close(s, rs, rtol=1e-5, atol=0)
    diff = (q.int() - rq.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() <= GN_CODE_FLIPS * q.numel()


def _kernels_per_call(fn, calls=5):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    return names, calls


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 960, 32, 64), (2, 1280, 4, 8)])
def test_the_trace_shows_one_k5_and_two_k6_kernels_a_call(cuda, shape):
    x, scale, bias = _gn_inputs(cuda, shape, torch.bfloat16, torch.bfloat16,
                                3)
    names, calls = _kernels_per_call(
        lambda: GN.group_norm_silu(x, scale, bias, 32))
    if names:  # a trace without device events says nothing
        assert len(names) == calls and all("gn_cluster_kernel" in n
                                           for n in names), names
    names, calls = _kernels_per_call(
        lambda: GN.group_norm_silu_quant(x, scale, bias, 32))
    if names:
        assert len(names) == 2 * calls, names
        assert sum("gn_cluster_kernel" in n for n in names) == calls
        assert sum("gn_quant_kernel" in n for n in names) == calls


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout", [
    ((2, 320, 32, 64), 320), ((2, 640, 32, 64), 320),
    ((2, 1920, 16, 32), 640), ((2, 2560, 4, 8), 1280)])
def test_k7_within_its_gate(cuda, shape, cout):
    x, scale, bias = _gn_inputs(cuda, shape, torch.bfloat16, torch.float32, 4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = (torch.randn((cout, shape[1], 3, 3), generator=gen, device=cuda)
         / (9 * shape[1]) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(cout, generator=gen, device=cuda)).to(
        torch.bfloat16)
    before = GC.gn_silu_conv.launches
    out = GC.gn_silu_conv(x, scale, bias, w, b, 32, 1e-5)
    torch.cuda.synchronize()
    assert GC.gn_silu_conv.launches == before + 1
    ref = GC.gn_silu_conv_reference(x, scale, bias, w, b, 32, 1e-5)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= GN_CONV_TOL * ref.float().abs().max().item()


# ---- F2: the LN + quantize stage --------------------------------------------
def _true_div(a, d):
    return a / torch.full((), float(d), device=a.device)


def ln_quant_warp_model(x, w, b, xs, eps):
    """``ln_quant_kernel``'s arithmetic in PyTorch, in its order: lane l of
    a row's warp adds columns l, l + 32, ... in turn, a butterfly over the
    lanes (lane i adds lane i ^ o's value, o = 16, 8, 4, 2, 1), ``mu =
    sum / c`` and the centred squares the same way, ``r = rsqrt(var +
    eps)``, ``hn = ((x - mu)·r)·w + b``, x8 = ``clip(rint(hn / xs))``;
    every step one rounding. Returns ``(x8, mu, var, r)``, rows flattened;
    on the card its codes are the kernel's bit for bit."""
    c = x.shape[-1]
    xf = x.float().reshape(-1, c)
    rows = xf.shape[0]
    steps = -(-c // 32)
    valid = torch.arange(steps * 32, device=x.device) < c
    lane = torch.arange(32, device=x.device)

    def warp_sum(vals):                      # [rows, steps * 32], 0 masked
        v = vals.reshape(rows, steps, 32)
        acc = torch.zeros(rows, 32, device=x.device)
        for j in range(steps):
            acc = acc + v[:, j]
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lane ^ o]
        return acc[:, :1]

    padded = torch.zeros(rows, steps * 32, device=x.device)
    padded[:, :c] = xf
    mu = _true_div(warp_sum(padded), c)
    d = padded - mu
    var = _true_div(warp_sum(torch.where(valid, d * d, 0.0)), c)
    r = torch.rsqrt(var + eps)
    hn = ((xf - mu) * r) * w + b
    x8 = S8.quantize_s8(hn, torch.tensor(xs, device=x.device))
    return x8.reshape(x.shape), mu[:, 0], var[:, 0], r[:, 0]


def check_code_flips(x8, ref8, hn_over_xs, share=LN_CODE_FLIPS,
                     ulps=LN_TIE_ULPS):
    """Codes equal but for +-1 at no more than ``share`` of them, and each
    flip where the plain ``hn / xs`` lies within ``ulps`` ulps of a .5.
    Returns the number of flips and the largest such distance in ulps."""
    d = (x8.int() - ref8.int()).abs()
    assert d.max().item() <= 1, d.max().item()
    flipped = d > 0
    n = int(flipped.sum().item())
    assert n <= share * x8.numel(), (n, x8.numel())
    if n == 0:
        return 0, 0.0
    t = hn_over_xs[flipped].abs()
    ulp = torch.nextafter(t, torch.full_like(t, float("inf"))) - t
    dist = ((t - (torch.floor(t) + 0.5)).abs() / ulp).max().item()
    assert dist <= ulps, dist
    return n, dist


def _ln_rows(dev, c, seed):
    """Random LN rows (not the init's ones and zeros)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = 1.0 + 0.3 * torch.randn(c, generator=gen, device=dev)
    b = 0.3 * torch.randn(c, generator=gen, device=dev)
    return w, b


def _ln_packs(dev, c, seed):
    """(name, ln_w, ln_b, xs, eps) of K3's, K4's and K10's packs built
    from one block's modules with random LN rows."""
    from ldmseg_torch.models.layers import LayerNorm, init_random_
    from ldmseg_torch.models.unet import CrossAttention, FeedForward
    gen = torch.Generator(device=dev).manual_seed(seed)
    norm1, attn, norm3, ff = (LayerNorm(c), CrossAttention(c, 8),
                              LayerNorm(c), FeedForward(c))
    for m in (norm1, attn, norm3, ff):
        m.to(dev)
        init_random_(m, gen)
    with torch.no_grad():
        for norm in (norm1, norm3):
            w, b = _ln_rows(dev, c, seed + c)
            norm.weight.copy_(w)
            norm.bias.copy_(b)
    k3 = S8.pack_ln_attention(norm1, attn, 8, 0.05)
    k4 = G4.pack_geglu(norm3, ff.net[0].proj, ff.net[2], 0.05)
    k10 = S8.pack_ln_attention_rowmajor(norm1, attn, 8, 0.05)
    return [("K3", k3.ln_w, k3.ln_b, k3.xs, k3.eps),
            ("K4", k4.ln_w, k4.ln_b, k4.xs, k4.eps),
            ("K10", k10.ln.ln_w, k10.ln.ln_b, k10.padded.xs, k10.ln.eps)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c", INT8_PATH + [(1, 120, 320), (3, 24, 640)])
def test_ln_quant_codes_on_random_ln_rows(cuda, b, t, c, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t + c)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(dtype)
    for name, w, bias, xs, eps in _ln_packs(cuda, c, t):
        before = S8.ln_quant_s8.launches
        x8, st = S8.ln_quant_s8(x, w, bias, xs, eps, stats=True)
        again = S8.ln_quant_s8(x, w, bias, xs, eps)
        torch.cuda.synchronize()
        assert S8.ln_quant_s8.launches == before + 2
        assert torch.equal(x8, again)
        # the kernel's order of the sums, modelled: the same codes
        m8, mu, var, r = ln_quant_warp_model(x, w, bias, xs, eps)
        assert torch.equal(st[:, 0], mu) and torch.equal(st[:, 1], var), name
        assert torch.equal(x8, m8), name
        # r is torch.rsqrt's of the kernel's variance
        assert torch.equal(st[:, 2], torch.rsqrt(st[:, 1] + eps)), name
        # PyTorch's order of the sums: a code off by one next to a .5
        ref8 = S8.ln_quant_reference(x, w, bias, xs, eps)
        hn = S8._layer_norm(x.float(), w, bias, eps)
        check_code_flips(x8, ref8, _true_div(hn, xs))


@pytest.mark.gpu
def test_ln_quant_raises_on_what_it_does_not_take(cuda):
    x = torch.randn((4, 64), device=cuda)
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):
        S8.ln_quant_s8(x.half(), w, b, 0.1, 1e-5)
    with pytest.raises(ValueError):
        S8.ln_quant_s8(x.t(), w[:4], b[:4], 0.1, 1e-5)
    with pytest.raises(ValueError):
        S8.ln_quant_s8(x, w.to(torch.bfloat16), b, 0.1, 1e-5)
