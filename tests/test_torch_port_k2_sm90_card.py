"""K2's bf16 kernels on Hopper (``attention_bwd_stats_kernel`` and
``attention_bwd_main_kernel``) on the card.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_k2_sm90_card.py

Every case holds dQ, dK and dV against ``attention_backward_reference`` at
``BF16_ATOL`` times each gradient's own max|ref| (two bf16 ulps at its
largest value: P and dS are rounded to bf16 on both sides, the sums run in
another order), checks that the wrapper's launch counter moved by exactly
one per call, and that a second call gives the same bits (dQ's sum over
key blocks runs in a fixed order). Without a card each test skips in the
``cuda`` fixture.
"""

import threading

import pytest
import torch

from ldmseg_torch.ops import attention as A

BF16_ATOL = 1.6e-2
FP32_ATOL = 1e-4
HEAD_DIMS = list(range(8, 161, 8))
EDGE_T = (1, 30, 63, 64, 65, 100, 127, 128, 129)
# (B, T, H, D) of K2 on the training path (batch 8, 24x80 latent)
PATH_SHAPES = [(8, 1920, 8, 40), (8, 480, 8, 80), (8, 120, 8, 160),
               (8, 30, 8, 160)]
# (B, T, C) of K14's and K16's backward at 8 heads, training
PACKED_SHAPES = [(8, 1920, 320), (8, 480, 640), (8, 120, 1280)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, scale=1.0, dtype=torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(
        dtype)


def _check_k2(q, k, v, do, scale, atol=BF16_ATOL):
    before = A.fused_self_attention_backward.launches
    grads = A.fused_self_attention_backward(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert A.fused_self_attention_backward.launches == before + 1
    refs = A.attention_backward_reference(q, k, v, do, scale)
    for name, g, r in zip(("dQ", "dK", "dV"), grads, refs):
        assert g.dtype == q.dtype and g.shape == q.shape, name
        assert torch.isfinite(g).all(), name
        err = (g.float() - r.float()).abs().max().item()
        bound = atol * max(r.float().abs().max().item(), 1e-6)
        assert err <= bound, f"{tuple(q.shape)} {name}: {err} > {bound}"
    again = A.fused_self_attention_backward(q, k, v, do, scale)
    for name, g, h in zip(("dQ", "dK", "dV"), grads, again):
        assert torch.equal(g, h), f"{tuple(q.shape)} {name}: not repeatable"


@pytest.mark.gpu
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k2_sm90_every_head_dim_at_the_tile_edges(cuda, d):
    for t in EDGE_T:
        q, k, v, do = (_randn((1, t, 2, d), seed=t * 5 + i)
                       for i in range(4))
        _check_k2(q, k, v, do, d ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_sm90_at_the_path_shapes(cuda, shape):
    q, k, v, do = (_randn(shape, seed=i) for i in range(4))
    _check_k2(q, k, v, do, shape[3] ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PACKED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_sm90_on_the_head_views_of_k14_and_k16(cuda, shape):
    # the backward of K14 and K16 reads the head views [B, T, H, D] of
    # [B, T, C] buffers, dO included
    q, k, v, do = (A._heads(_randn(shape, seed=10 + i), 8) for i in range(4))
    _check_k2(q, k, v, do, (shape[2] // 8) ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,c", [(2, 512, 640), (1, 100, 320)])
def test_k2_sm90_reads_column_slices_of_one_qkv_buffer(cuda, b, t, c):
    qkv = _randn((b, t, 3 * c), seed=7)
    q, k, v = (x.unflatten(-1, (8, c // 8)) for x in qkv.split(c, dim=-1))
    assert not q.is_contiguous()
    do = _randn((b, t, 8, c // 8), seed=8)
    _check_k2(q, k, v, do, (c // 8) ** -0.5)


@pytest.mark.gpu
def test_k2_sm90_reads_a_head_major_view(cuda):
    # [B, H, T, D] storage seen as [B, T, H, D]: the T stride is below H's
    q, k, v, do = (_randn((2, 8, 128, 40), seed=20 + i).transpose(1, 2)
                   for i in range(4))
    _check_k2(q, k, v, do, 40 ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_k2_sm90_scores_near_80_stay_finite(cuda, sign):
    # q = 8 k on unit rows, scale 10: logits of about +-80
    shape = (1, 256, 2, 64)
    k = _randn(shape, seed=30)
    k = (k.float() / k.float().norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    q = (sign * 8.0 * k.float()).to(torch.bfloat16)
    v, do = _randn(shape, seed=31), _randn(shape, seed=32)
    _check_k2(q, k, v, do, 10.0)


@pytest.mark.gpu
def test_k2_sm90_takes_a_negative_scale(cuda):
    q, k, v, do = (_randn((1, 200, 2, 40), seed=40 + i) for i in range(4))
    _check_k2(q, k, v, do, -40 ** -0.5)


@pytest.mark.gpu
def test_k2_sm90_gives_dq_alone_right_across_many_key_blocks(cuda):
    # dQ sums 16 key blocks' partials (T = 2048, 64 heads: two consumer
    # warpgroups a block) through the workspace; dK and dV do not
    q, k, v, do = (_randn((8, 2048, 8, 40), seed=50 + i) for i in range(4))
    _check_k2(q, k, v, do, 40 ** -0.5)


@pytest.mark.gpu
def test_k2_fp32_path_unchanged(cuda):
    q, k, v, do = (_randn((1, 100, 2, 40), seed=60 + i, dtype=torch.float32)
                   for i in range(4))
    _check_k2(q, k, v, do, 40 ** -0.5, atol=FP32_ATOL)


@pytest.mark.gpu
def test_k1_and_k2_run_in_a_thread_that_made_no_cuda_call(cuda):
    # autograd runs a backward on its own worker thread; a new thread has
    # no current CUDA context until a call makes one, and the tensor maps'
    # encoder needs one
    q, k, v, do = (_randn((2, 96, 4, 40), seed=70 + i) for i in range(4))
    out, errors = [], []

    def run():
        try:
            out.append(A.fused_self_attention(q, k, v, 0.15))
            out.append(A.fused_self_attention_backward(q, k, v, do, 0.15))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    assert not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(out[0], A.fused_self_attention(q, k, v, 0.15))
    again = A.fused_self_attention_backward(q, k, v, do, 0.15)
    assert all(torch.equal(a, b) for a, b in zip(out[1], again))
