"""The packed and absorbed attentions' kernels on a model axis: K14, K15,
K16 and K17 on a rank's heads, on two gloo ranks of the port
(``tests/torch_dp_workers.py:attention_partials``, a ``(data=1,
model=2)`` mesh) against one process of the port, each through its plain
version (the kernel's arithmetic) or, at a shape the kernel does not take,
its fallback:

  * K14 on a rank's ``[B, T, C/2]`` with ``heads / 2`` heads, gathered,
    equals one rank's bit for bit (each head is its own attention);
  * K15's three dynamic scales on a rank's heads with the model group
    equal one rank's bit for bit (the group's maximum of the ranks'
    amaxes), and so does its output, gathered;
  * K16's and K17's partial modes (fp32, a rank's heads), summed over the
    group and rounded once, against the one-rank plain version: within the
    fp32 sums' reordering, a few ulps of the output plus 1e-5 of its
    largest value (one bf16 ulp more where the output rounds to bf16);
    the same for their fallbacks;
  * each rank's K17 pack (``w_qkv``, ``wo_q``, ``w_scale``, ``wo_p``) from
    the cut attention is the slice of one rank's pack bit for bit.
"""

import pytest
import torch

from ldmseg_torch.models.unet import CrossAttention
from ldmseg_torch.ops import attention as A
from ldmseg_torch.ops import attention_s8 as S8
from ldmseg_torch.parallel import tp
from ldmseg_torch.parallel.launch import run_ranks
from ldmseg_torch.parallel.mesh import Mesh
from ldmseg_torch.parallel.sp import model_axis

import torch_dp_workers as W

C, T = 64, 16


def _cases():
    """K14 and K15 at d = 8 (kernel) and a ragged T (fallback); K16 in
    fp32 and bf16 at d = 16 (kernel), at a ragged T and at d = 4
    (fallbacks); K17 at d = 16 and a ragged T."""
    gen = torch.Generator().manual_seed(26)

    def rand(*shape, dtype=torch.float32, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to(dtype)
    cases = []
    for kind in ("K14", "K15"):
        for t, dtype in ((T, torch.float32), (T, torch.bfloat16),
                         (12, torch.bfloat16)):
            cases.append({"kind": kind, "heads": 4, "scale": 8 ** -0.5,
                          "qkv": tuple(rand(2, t, 32, dtype=dtype)
                                       for _ in range(3))})
    for heads, t, dtype in ((4, T, torch.float32), (4, T, torch.bfloat16),
                            (4, 12, torch.float32), (16, T, torch.float32)):
        cases.append({"kind": "K16", "heads": heads,
                      "scale": (C // heads) ** -0.5,
                      "x": rand(2, t, C, dtype=dtype),
                      "w": tuple(rand(C, C, dtype=dtype, s=C ** -0.5)
                                 for _ in range(4))})
    for t in (T, 12):
        attn = CrossAttention(C, 4)
        with torch.no_grad():
            for p in attn.parameters():
                p.copy_(rand(*p.shape, s=0.2))
        cases.append({"kind": "K17", "heads": 4, "scale": 16 ** -0.5,
                      "xs": 0.03, "attn": attn,
                      "x": rand(2, t, C, dtype=torch.bfloat16)})
    return cases


def _one_rank(case):
    kind, heads = case["kind"], case["heads"]
    if kind == "K14":
        return A.fused_self_attention_packed(*case["qkv"], heads,
                                             case["scale"])
    if kind == "K15":
        return S8.fused_self_attention_packed_s8(*case["qkv"], heads,
                                                 case["scale"])
    if kind == "K16":
        return A.absorbed_self_attention(case["x"], *case["w"], heads,
                                         case["scale"])
    p = _whole_pack(case)
    return S8.absorbed_self_attention_s8(case["x"], p.w_qkv, p.wo_q,
                                         p.w_scale, heads, case["scale"],
                                         p.xs, p.wo_p)


def _whole_pack(case):
    return S8.pack_absorbed_attention(case["attn"], case["heads"],
                                      case["xs"])


@pytest.fixture(scope="module")
def runs():
    cases = _cases()
    ranks = run_ranks(W.attention_partials, 2, args=(cases,), device="cpu",
                      timeout_s=120)
    return {"cases": cases, "ranks": ranks}


def _ids():
    return [f"{c['kind']}-{i}" for i, c in enumerate(_cases())]


@pytest.mark.parametrize("i", range(len(_cases())), ids=_ids())
def test_a_ranks_heads_sum_to_one_rank(runs, i):
    case = runs["cases"][i]
    want = _one_rank(case)
    got = [r[i]["out"] for r in runs["ranks"]]
    assert got[0].shape == want.shape and got[0].dtype == want.dtype
    assert torch.equal(got[0], got[1])
    if case["kind"] in ("K14", "K15"):
        # whole heads on each rank, the same scales: bit for bit
        assert torch.equal(got[0], want)
        return
    want = want.float()
    # the ranks' fp32 partials add in another order than the one-rank
    # sums; where the output rounds to bf16, one bf16 ulp more
    bound = (4 * torch.finfo(torch.float32).eps * want.abs()
             + 1e-5 * want.abs().max())
    if got[0].dtype == torch.bfloat16:
        bound = bound + torch.finfo(torch.bfloat16).eps * want.abs()
    err = (got[0].float() - want).abs()
    assert bool((err <= bound).all()), float(err.max())
    # each rank's partial is fp32 and differs from the other's
    parts = [r[i]["partial"] for r in runs["ranks"]]
    assert parts[0].dtype == torch.float32
    assert not torch.equal(parts[0], parts[1])


@pytest.mark.parametrize("i", [i for i, c in enumerate(_cases())
                               if c["kind"] == "K15"])
def test_k15_scales_on_a_ranks_heads_equal_one_rank(runs, i):
    case = runs["cases"][i]
    h = case["heads"]
    whole = torch.stack(S8.s8_scales(*(z.unflatten(-1, (h, -1))
                                       for z in case["qkv"]), None))
    for r in runs["ranks"]:
        assert torch.equal(r[i]["scales"], whole)


@pytest.mark.parametrize("i", [i for i, c in enumerate(_cases())
                               if c["kind"] == "K17"])
def test_k17_pack_is_the_slice_of_one_rank(runs, i):
    whole = _whole_pack(runs["cases"][i])
    cuts = {"w_qkv": (0, 3), "wo_q": (1, 1), "w_scale": (1, 1),
            "wo_p": (1, 1)}
    for rank, r in enumerate(runs["ranks"]):
        ax = model_axis(Mesh(model=2, model_rank=rank))
        for f, (dim, pairs) in cuts.items():
            want = tp.local_tensor(getattr(whole, f), dim, ax, pairs)
            got = r[i]["pack"][f]
            assert got.dtype == want.dtype and torch.equal(got, want), f
