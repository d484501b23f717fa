"""K9's ``proj_out`` and K7 on Hopper (``csrc/gemm_sm90.cuh``) on the card.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_k9k7_sm90_card.py

K7 (``csrc/gn_silu_conv.cu``: GN + SiLU into a padded channel-last
scratch, the 3x3 conv as one product over nine shifted taps, split-K at the
deep levels) is held to its plain version within ``GN_CONV_TOL`` of
max|ref| (``chip_smoke.py``'s gate: sums over up to 9 x 2560 bf16 products
in another order, rounded to bf16) at every shape class of the 43 resnet
halves it takes in a sampling forward, at ragged shapes (Cin not a
multiple of 64, Cout not a multiple of 128, W = 8, an odd W) and at the
two shapes of ``K7_REPAIRED`` (Cin 36 in 4 groups; 320 channels at 64x64
in one group, whose slice is read twice, in chunks), two calls
bit-equal (the split's partials are summed in a fixed order), and the
trace shows the launches its plan names. K9 (K4's kernels, then the bf16
``proj_out`` product with its operands swapped, stored channel-major) is
held to its plain version within the int8 blocks' tolerances
(``INT8_MAX_TOL`` two bf16 ulps of max|ref|, ``INT8_MEAN_TOL`` of
mean|ref|) at the four shapes of the int8 path and ragged ones, and the
trace shows its five kernels and no other. The traces are taken in a fresh
process each (:func:`_kernel_names`): late in a long process, as in a full
``-m gpu`` run, ``torch.profiler`` drops device events. Without a card
each test skips in the ``cuda`` fixture.

:func:`conv_taps_model` and :func:`pout_swapped_model`, K7's and K9's
decompositions in plain PyTorch, live here so that the CPU tests
(``tests/test_torch_port_k9k7_sm90.py``) hold them against the JAX
package.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from ldmseg_torch.ops import geglu as K4
from ldmseg_torch.ops import gn_silu_conv as GC
from ldmseg_torch.ops.groupnorm_silu import gn_silu_rows

GN_CONV_TOL = 2e-2
INT8_MAX_TOL, INT8_MEAN_TOL = 1.6e-2, 2.5e-3
# ((B, Cin, H, W), Cout, halves) of the 43 resnet halves K7 takes in one
# sampling forward (batch 2, 32x64 latent; tools/profile_gn.py:site_shapes;
# the 44th, (2, 960, 32, 64) -> 320, falls back by the 6 MiB rule)
K7_SITES = [((2, 320, 32, 64), 320, 7), ((2, 640, 32, 64), 320, 2),
            ((2, 320, 16, 32), 640, 1), ((2, 640, 16, 32), 640, 6),
            ((2, 960, 16, 32), 640, 1), ((2, 1280, 16, 32), 640, 1),
            ((2, 1920, 16, 32), 640, 1), ((2, 640, 8, 16), 1280, 1),
            ((2, 1280, 8, 16), 1280, 6), ((2, 1920, 8, 16), 1280, 1),
            ((2, 2560, 8, 16), 1280, 2), ((2, 1280, 4, 8), 1280, 11),
            ((2, 2560, 4, 8), 1280, 3)]
# ((B, Cin, H, W), Cout, groups): Cin not a multiple of 64, Cout not a
# multiple of 128, W = 8, odd widths (scalar loads and stores), one image
K7_RAGGED = [((1, 40, 5, 7), 24, 8), ((2, 96, 8, 8), 200, 32),
             ((1, 72, 6, 12), 48, 8), ((2, 200, 3, 9), 136, 8)]
# ((B, Cin, H, W), Cout, groups) that JAX's kernel takes and K7's plan
# refused before its repair: Cin 36, not a multiple of 8 (scratch and pack
# rows of 40 channels), and a CTA's slice of 320 channels x 8 rows of 64
# (329 KB: x read twice, the second time in chunks of 312 pixels)
K7_REPAIRED = [((2, 36, 32, 64), 64, 4), ((2, 320, 64, 64), 320, 1)]
# (B, T, C) of K9's launches in one fused-projs int8 forward, and ragged
# ones the rule takes (T = 120; C = 80, not a multiple of 64)
K9_PATH = [(2, 2048, 320), (2, 512, 640), (2, 128, 1280), (2, 32, 1280)]
K9_RAGGED = [(3, 120, 320), (1, 64, 80)]


# ---- the decompositions in plain PyTorch -----------------------------------
def padded_activation(x, scale, bias, groups, eps, wp):
    """K7's scratch: y = ``gn_silu_rows(x)`` rounded to x's dtype, channel-
    last, each image's rows framed by a zero row above and below and the
    columns ``[W, wp)`` zeros, ``[B·(H + 2)·wp, Cin]`` in fp32."""
    b, c, h, w = x.shape
    y = gn_silu_rows(x, scale, bias, groups, eps).to(x.dtype)
    pad = torch.zeros((b, h + 2, wp, c), dtype=torch.float32,
                      device=x.device)
    pad[:, 1:h + 1, :w] = y.permute(0, 2, 3, 1).float()
    return pad.reshape(-1, c)


def conv_taps_model(x, scale, bias, w, b, groups, eps, plan):
    """K7's decomposition (``csrc/gn_silu_conv.cu``) in plain PyTorch, fp32
    sums: the padded scratch (:func:`padded_activation`), read as the
    product's W operand through a window of zeros past either end (TMA's
    zeros); each stage kt = (tap t, channel block cb) the 64-wide A box of
    the packed weights (in x's dtype; ``cin8``, Cin rounded up to 8,
    columns a tap, zeros past Cin) at column ``t·cin8 + 64·cb`` (past Cin
    it holds zeros or the next tap's weights, which meet the scratch's
    zero channels) times the
    scratch's rows shifted by ``(t // 3 − 1)·wp + (t % 3 − 1)``; the stages
    summed in order within each split of ``plan.split_ranges()``, the
    splits' partials in split order, b added, the halo positions dropped,
    the result in x's dtype ``[B, Cout, H, W]``."""
    bsz, cin, h, wd = x.shape
    cout = w.shape[0]
    wp, n, cb64 = plan.wp, plan.n, 64 * plan.cblocks
    flat = padded_activation(x, scale, bias, groups, eps, wp)
    margin = wp + 1
    ext = torch.zeros((margin + n + margin, cb64), device=x.device)
    ext[margin:margin + plan.positions, :cin] = flat
    c8 = plan.cin8
    wk = torch.zeros((cout, 9 * c8 + 64), device=x.device)
    # the packed weights (pack_conv_weight's layout) in x's dtype
    wk[:, :9 * c8].view(cout, 9, c8)[..., :cin] = w.permute(
        0, 2, 3, 1).reshape(cout, 9, cin).to(x.dtype).float()

    def stage(kt):
        t, c = divmod(kt, plan.cblocks)
        shift = (t // 3 - 1) * wp + (t % 3 - 1)
        a = wk[:, t * c8 + 64 * c:t * c8 + 64 * c + 64]
        rows = ext[margin + shift:margin + shift + n, 64 * c:64 * c + 64]
        return a @ rows.t()                                   # [cout, n]

    total = None
    for lo, hi in plan.split_ranges():
        part = torch.zeros((cout, n), device=x.device)
        for kt in range(lo, hi):
            part = part + stage(kt)
        total = part if total is None else total + part
    out = total + b.float()[:, None]
    out = out[:, :plan.positions].reshape(cout, bsz, h + 2, wp)
    return out[:, :, 1:h + 1, :wd].permute(1, 0, 2, 3).to(x.dtype)


def pout_swapped_model(r, wpo, bpo, plan, b, t):
    """K9's ``proj_out`` as the swapped product runs it, in plain PyTorch:
    ``Wpo [C, C]·rᵀ`` over stages of 64 input channels summed in order in
    fp32 (rows: output channels, columns: the B·T tokens), ``b_po`` of the
    row added, rounded once to bf16, stored channel-major ``[B, C, T]``."""
    c = wpo.shape[0]
    rf, wf = r.reshape(b * t, -1).float(), wpo.float()
    acc = torch.zeros((c, b * t), device=r.device)
    for kt in range(plan.k_tiles):
        k = slice(64 * kt, 64 * kt + 64)
        acc = acc + wf[:, k] @ rf[:, k].t()
    out = (acc + bpo.float()[:, None]).to(torch.bfloat16)
    return out.reshape(c, b, t).permute(1, 0, 2).contiguous()


# ---- the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k7_inputs(dev, shape, cout, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[1]
    x = (1.5 * torch.randn(shape, generator=gen, device=dev) + 0.3).to(
        torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
    bias = 0.1 * torch.randn(c, generator=gen, device=dev)
    w = (torch.randn((cout, c, 3, 3), generator=gen, device=dev)
         / (9 * c) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn(cout, generator=gen, device=dev)).to(
        torch.bfloat16)
    return x, scale, bias, w, b


HERE = pathlib.Path(__file__).resolve().parent
_TRACE_CHILD = (
    "import json, sys; sys.path.insert(0, sys.argv[1]); "
    "import test_torch_port_k9k7_sm90_card as m; "
    "print(json.dumps(m.trace_case(json.loads(sys.argv[2]))))")


def trace_case(case, calls=4):
    """The device kernels' names of ``calls`` calls of a K7 (``["k7",
    shape, cout]``) or K9 (``["k9", static]``) case after one untraced
    call, traced in this process."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device("cuda")
    if case[0] == "k7":
        _, shape, cout = case
        x, scale, bias, w, b = _k7_inputs(cuda, tuple(shape), cout, 4)

        def fn():
            GC.gn_silu_conv(x, scale, bias, w, b, 32, 1e-5)
    else:
        pack = _k9_pack(cuda, 640, case[1], 8)
        x = torch.randn((2, 512, 640), device=cuda).to(torch.bfloat16)

        def fn():
            K4.geglu_ln_s8_pout(x, pack)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)], calls


def _kernel_names(case):
    """:func:`trace_case` in a fresh process (the kernels are built
    already): late in a long process ``torch.profiler`` drops device
    events."""
    proc = subprocess.run(
        [sys.executable, "-c", _TRACE_CHILD, str(HERE), json.dumps(case)],
        cwd=HERE.parent, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names, calls = json.loads(proc.stdout.strip().splitlines()[-1])
    return names, calls


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout,groups",
                         [(s, co, 32) for s, co, _ in K7_SITES] + K7_RAGGED
                         + K7_REPAIRED)
def test_k7_matches_plain_version_and_repeats_bit_equal(cuda, shape, cout,
                                                        groups):
    x, scale, bias, w, b = _k7_inputs(cuda, shape, cout, 2)
    before = GC.gn_silu_conv.launches
    out = GC.gn_silu_conv(x, scale, bias, w, b, groups, 1e-5)
    again = GC.gn_silu_conv(x, scale, bias, w, b, groups, 1e-5)
    torch.cuda.synchronize()
    assert GC.gn_silu_conv.launches == before + 2
    assert out.dtype == torch.bfloat16
    assert out.shape == (shape[0], cout) + shape[2:]
    assert torch.equal(out, again)
    ref = GC.gn_silu_conv_reference(x, scale, bias, w, b, groups, 1e-5)
    err = (out.float() - ref.float()).abs().max().item()
    assert bool(torch.isfinite(out.float()).all())
    assert err <= GN_CONV_TOL * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout,groups", [
    ((2, 320, 32, 64), 320, 32), ((2, 640, 16, 32), 640, 32),
    ((2, 1280, 8, 16), 1280, 32), ((2, 2560, 4, 8), 1280, 32),
    ((1, 40, 5, 7), 24, 8)] + K7_REPAIRED)
def test_k7_is_its_decomposition(cuda, shape, cout, groups):
    # the kernel against conv_taps_model on the card: the same y (both
    # round gn_silu to bf16; the statistics' sums in another order can move
    # a y by a bf16 ulp), the same stages and split order
    x, scale, bias, w, b = _k7_inputs(cuda, shape, cout, 3)
    out = GC.gn_silu_conv(x, scale, bias, w, b, groups, 1e-5)
    plan = GC.sm90_conv_plan(shape[0], shape[1], cout, shape[2], shape[3],
                             groups, x.data_ptr() % 16 == 0)
    model = conv_taps_model(x, scale, bias, w, b.float(), groups, 1e-5, plan)
    err = (out.float() - model.float()).abs().max().item()
    assert err <= GN_CONV_TOL * model.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout", [((2, 320, 32, 64), 320),
                                        ((2, 640, 16, 32), 640),
                                        ((2, 2560, 4, 8), 1280)])
def test_k7_launches_what_its_plan_names(cuda, shape, cout):
    plan = GC.sm90_conv_plan(shape[0], shape[1], cout, shape[2], shape[3],
                             32)
    names, calls = _kernel_names(["k7", list(shape), cout])
    if not names:  # a trace without device events says nothing
        return
    # each of the plan's kernels once a call and nothing else (no cast of
    # the bf16 bias: the wrapper keeps its fp32 copy); a trace may drop a
    # few events, never add one
    got = {k: sum(k in n for n in names)
           for k in ("gn_pad_kernel", "ConvEpi", "conv_sum_kernel")}
    want = {"gn_pad_kernel": calls, "ConvEpi": calls,
            "conv_sum_kernel": calls if plan.splits > 1 else 0}
    assert sum(got.values()) == len(names), names
    assert all(want[k] - 1 <= got[k] <= want[k] for k in want), (got, names)
    assert plan.launches == 2 + (want["conv_sum_kernel"] > 0)


@pytest.mark.gpu
def test_k7_raises_on_what_it_does_not_take(cuda):
    x, scale, bias, w, b = _k7_inputs(cuda, (1, 36, 6, 8), 16, 5)
    with pytest.raises(ValueError):   # Cin % groups
        GC.gn_silu_conv(x, scale, bias, w, b, 8, 1e-5)
    x, scale, bias, w, b = _k7_inputs(cuda, (1, 64, 6, 8), 16, 5)
    with pytest.raises(ValueError):   # w's shape
        GC.gn_silu_conv(x, scale, bias, w[:, :32], b, 32, 1e-5)


def _k9_pack(cuda, c, static, seed):
    from ldmseg_torch.models.layers import LayerNorm, init_random_
    from ldmseg_torch.models.unet import FeedForward
    gen = torch.Generator(device=cuda).manual_seed(seed)
    norm, ff = LayerNorm(c).to(cuda), FeedForward(c).to(cuda)
    conv = torch.nn.Conv2d(c, c, 1).to(cuda)
    for m in (norm, ff, conv):
        init_random_(m, gen)
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen,
                                          device=cuda))
    return K4.with_proj_out(
        K4.pack_geglu(norm, ff.net[0].proj, ff.net[2], 0.05,
                      0.02 if static else None), conv)


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("b,t,c", K9_PATH + K9_RAGGED)
def test_k9_matches_plain_version_and_its_swapped_model(cuda, b, t, c,
                                                        static):
    pack = _k9_pack(cuda, c, static, 6)
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((b, t, c), generator=gen, device=cuda).to(torch.bfloat16)
    before = K4.geglu_ln_s8_pout.launches
    out = K4.geglu_ln_s8_pout(x, pack)
    again = K4.geglu_ln_s8_pout(x, pack)
    torch.cuda.synchronize()
    assert K4.geglu_ln_s8_pout.launches == before + 2
    assert torch.equal(out, again)
    assert out.shape == (b, t, c) and out.transpose(1, 2).is_contiguous()
    ref = K4.geglu_ln_s8_pout_reference(x, pack)
    err = (out.float() - ref.float()).abs()
    assert bool(torch.isfinite(out.float()).all())
    assert err.max().item() <= INT8_MAX_TOL * ref.float().abs().max().item()
    assert err.mean().item() <= INT8_MEAN_TOL * ref.float().abs().mean().item()
    # the proj_out product on the plain block output: its swapped model
    r = K4.geglu_ln_s8_reference(x, pack)
    model = pout_swapped_model(r, pack.wpo, pack.bpo, K4.pout_plan(b, t, c),
                               b, t).transpose(1, 2)
    merr = (model.float() - ref.float()).abs().max().item()
    assert merr <= 2 ** -7 * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("static", [False, True])
def test_k9_launches_its_five_kernels(cuda, static):
    names, calls = _kernel_names(["k9", static])
    if not names:
        return
    stages = ("ln_quant_kernel", "GateEpi", "::quant_kernel(", "DownEpi",
              "ProjOutEpi")
    want = {s: calls for s in stages}
    if static:  # the static interior scale quantizes in the up epilogue
        want["::quant_kernel("] = 0
    got = {s: sum(s in n for n in names) for s in stages}
    # each stage once a call and no other kernel; a trace may drop a few
    # events, never add one
    assert sum(got.values()) == len(names), names
    assert all(want[s] - 1 <= got[s] <= want[s] or want[s] == got[s] == 0
               for s in stages), (got, names)
    assert not any("bf16_gemm_kernel" in n for n in names)
