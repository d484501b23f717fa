"""K14, K15 and K10 of the port against the JAX package on the CPU.

K14 (``use_packed_attention``'s bf16 attention on ``[B, T, C]``), its
backward on K2's arithmetic, K15 (the int8 packed attention with dynamic
scales) and K10 (the row-major LN + int8 attention block, an op, in both
``v_bf16`` variants): each plain version against its Pallas kernel in
interpret mode, each fallback against the JAX wrapper on the CPU at a
ragged T; and K1's dispatch at the shapes JAX's rule sends to XLA. Inputs
are made with numpy from a seed and handed to both packages; each tolerance
is stated with its reason where it is used.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_torch.ops import attention as A  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402

from test_torch_port_int8 import (  # noqa: E402
    _attention_case, _kernel_close, _t)


def _btc(seed, b, t, c, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, t, c) * scale).astype(np.float32)
            for _ in range(3)]


def _rel_close(out, ref, tol):
    """max |out - ref| <= tol * max|ref|."""
    out, ref = (np.asarray(x, np.float32) for x in (out, ref))
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and err <= tol * scale, (err, tol * scale)


def _packed_pallas(q, k, v, heads, scale):
    """``_packed_impl`` in interpret mode: ``_attn_kernel_btc`` per image."""
    b, t, c = q.shape
    spec = pl.BlockSpec((1, t, c), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._attn_kernel_btc, heads=heads, scale=scale),
        grid=(b,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        interpret=True)(q, k, v)


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,heads,d", [(2, 64, 2, 40), (1, 32, 2, 16)])
def test_k14_plain_version_matches_pallas_kernel_in_interpret_mode(
        b, t, heads, d, dtype):
    c = heads * d
    q, k, v = _btc(b + t + d, b, t, c)
    scale = d ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = np.asarray(_packed_pallas(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                    heads, scale).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    # K1's tolerances (test_torch_port_attention.py): the one-hot selection
    # is exact, so only the softmax's summation order differs; in bf16 P
    # and o round on both sides, two bf16 ulps at 1.0
    atol = 1e-5 if dtype == "float32" else 1.6e-2
    before = (A.fused_self_attention_packed.launches,
              A.fused_self_attention_packed.fallbacks)
    for fn in (A.packed_attention_reference, A.fused_self_attention_packed):
        out = fn(tq, tk, tv, heads, scale)
        assert out.dtype == tdt and out.shape == (b, t, c)
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                                   atol=atol)
    # a CPU tensor at a kernel shape takes the plain version: no launch,
    # no fallback
    assert (A.fused_self_attention_packed.launches,
            A.fused_self_attention_packed.fallbacks) == before


@pytest.mark.parametrize("dtype,tol", [
    # fp32: K2's arithmetic against XLA's VJP; only the summation order
    ("float32", 1e-5),
    # bf16: _xla_btc rounds the scores to bf16 before the softmax (8 bits:
    # |s| ~ 3 moves by ~1e-2, P by ~1%), K2 keeps them in fp32, and each
    # side rounds P, dS and the gradients to bf16: 2e-2 of max|ref|
    # (measured 5.0e-3, 5.6e-3 and 8.3e-3 for dQ, dK, dV)
    ("bfloat16", 2e-2)])
def test_k14_backward_matches_jax_vjp_of_xla_btc(dtype, tol):
    b, t, heads, d = 2, 32, 2, 40
    c = heads * d
    q, k, v = _btc(5, b, t, c)
    do = _btc(6, b, t, c)[0]
    scale = d ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    _, vjp = jax.vjp(lambda a, e, f: jattn._xla_btc(a, e, f, heads, scale),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    refs = [np.asarray(r.astype(jnp.float32))
            for r in vjp(jnp.asarray(do, jdt))]
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
    out = A.fused_self_attention_packed(*leaves, heads, scale)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do).to(tdt))
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == tdt and leaf.grad.shape == (b, t, c)
        _rel_close(leaf.grad.float().numpy(), ref, tol)


def test_k14_plain_backward_passes_gradcheck():
    # float64 through the autograd Function on the CPU: forward on the
    # head views, backward attention_backward_reference on them
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(2, 8, 12)).requires_grad_(True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, e, f: A.fused_self_attention_packed(a, e, f, 3, 0.4),
        (q, k, v))


@pytest.mark.parametrize("t", [30, 20])   # T % 8: the rule's fallback
def test_k14_fallback_matches_jax_wrapper_on_cpu(t):
    b, heads, d = 2, 2, 8
    c = heads * d
    q, k, v = _btc(t, b, t, c)
    do = _btc(t + 1, b, t, c)[0]
    scale = d ** -0.5
    args = [jnp.asarray(x) for x in (q, k, v)]
    ref, vjp = jax.vjp(lambda a, e, f: jattn.fused_self_attention_packed(
        a, e, f, heads, scale), *args)
    grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = A.fused_self_attention_packed.fallbacks
    out = A.fused_self_attention_packed(*leaves, heads, scale)
    assert A.fused_self_attention_packed.fallbacks == before + 1
    out.backward(torch.from_numpy(do))
    # fp32 on both sides, XLA's autodiff against PyTorch's through the same
    # function: only the summation order differs
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    for leaf, g in zip(leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-6)


def test_k14_fallback_keeps_the_input_dtype_scores():
    # _xla_btc rounds the scores to bf16, and so does the fallback: on the
    # same bf16 inputs the two differ only by the bf16 einsums' fp32 sums
    # in another order (two bf16 ulps of max|ref|)
    b, t, heads, d = 1, 30, 2, 16
    q, k, v = _btc(11, b, t, heads * d, scale=2.0)
    ref = np.asarray(jattn.fused_self_attention_packed(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), heads,
        d ** -0.5).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = A.fused_self_attention_packed(tq, tk, tv, heads, d ** -0.5)
    assert out.dtype == torch.bfloat16
    _rel_close(out.float().numpy(), ref, 1.6e-2)


# ---------------------------------------------------------------------------
# K1's dispatch at the shapes JAX's rule sends to XLA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,h,d", [(1, 1920, 1, 40), (2, 30, 2, 160)])
def test_k1_keeps_fp32_scores_where_jax_takes_xla_bthd(b, t, h, d):
    # the 24x80 training shapes: JAX's fused_self_attention sends T = 1920
    # (T % 1024) and T = 30 (T % 8) to _xla_bthd, whose scores round to
    # bf16; the port runs K1 (on the CPU its plain version) with the
    # Pallas kernel's fp32 scores. The two stay within the bf16 scores' own
    # error: 2e-2 of max|ref| (measured 9.7e-3 at T = 1920, 7.8e-3 at 30)
    rng = np.random.RandomState(t)
    q, k, v = (rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    ref = np.asarray(jattn.fused_self_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        scale).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = A.fused_self_attention(tq, tk, tv, scale)
    assert out.dtype == torch.bfloat16
    _rel_close(out.float().numpy(), ref, 2e-2)
    # and the port's output is K1's arithmetic, not _xla_bthd's
    assert torch.equal(out, A.attention_reference(tq, tk, tv, scale))


# ---------------------------------------------------------------------------
# K15
# ---------------------------------------------------------------------------
def _packed_s8_pallas(q, k, v, heads, scale):
    """``fused_self_attention_packed_s8``'s kernel branch (:221-232) with
    ``_packed_s8_impl``'s pallas_call in interpret mode (the JAX wrapper
    has no interpret flag and takes XLA on the CPU)."""
    qs, ks, vs = (jnp.maximum(jnp.max(jnp.abs(x)), 1e-6).astype(jnp.float32)
                  / 127.0 for x in (q, k, v))

    def quant(x, s):
        return jnp.clip(jnp.round(x.astype(jnp.float32) / s), -127,
                        127).astype(jnp.int8)
    sc = jnp.zeros((8, 128), jnp.float32)
    sc = sc.at[0, 0].set(qs * ks * scale).at[0, 1].set(vs / 127.0)
    b, t, c = q.shape
    spec = pl.BlockSpec((1, t, c), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._attn_kernel_btc_s8, heads=heads),
        grid=(b,),
        in_specs=[spec, spec, spec, pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(q.shape, jnp.bfloat16),
        interpret=True,
    )(quant(q, qs), quant(k, ks), quant(v, vs), sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,heads,d", [(2, 64, 4, 8), (1, 24, 2, 40)])
def test_k15_plain_version_matches_pallas_kernel_in_interpret_mode(
        b, t, heads, d, dtype):
    c = heads * d
    q, k, v = _btc(3 * t + d, b, t, c)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    scale = d ** -0.5
    ref = np.asarray(_packed_s8_pallas(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), heads, scale),
        np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    out = S8.fused_self_attention_packed_s8_reference(tq, tk, tv, heads,
                                                      scale)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    # K13's rounding points on the same dynamic scales and codes: a code of
    # e flips by one where PyTorch's and XLA's exp differ by an ulp at a .5
    # boundary (K13's tolerance, test_torch_port_int8_unfused.py)
    _kernel_close(out.float().numpy(), ref, mean_tol=2.5e-3)
    before = (S8.fused_self_attention_packed_s8.launches,
              S8.fused_self_attention_packed_s8.fallbacks)
    wrapped = S8.fused_self_attention_packed_s8(tq, tk, tv, heads, scale)
    assert wrapped.dtype == tdt
    assert torch.equal(wrapped, out.to(tdt))
    assert (S8.fused_self_attention_packed_s8.launches,
            S8.fused_self_attention_packed_s8.fallbacks) == before


@pytest.mark.parametrize("t", [30, 2056])  # T % 8, T > 2048
def test_k15_fallback_matches_jax_wrapper_on_cpu(t):
    b, heads, d = 1, 2, 8
    q, k, v = _btc(t, b, t, heads * d)
    ref = jattn.fused_self_attention_packed_s8(
        *(jnp.asarray(x) for x in (q, k, v)), heads, d ** -0.5)
    before = S8.fused_self_attention_packed_s8.fallbacks
    out = S8.fused_self_attention_packed_s8(_t(q), _t(k), _t(v), heads,
                                            d ** -0.5)
    assert S8.fused_self_attention_packed_s8.fallbacks == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, t, heads * d)
    # float attention, unquantized, fp32 on both sides
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------
def _k10_pallas(x, g1, be1, bo, w8, scales, heads, act_scale, v_bf16):
    """``absorbed_padded_ln_self_attention_s8``'s row-major branch
    (:1140-1158): ``_abs_padded_prep``'s operands, then
    ``_abs_padded_ln_s8_impl`` in interpret mode."""
    c = x.shape[-1]
    d = c // heads
    wqp, wkp, wvp, wop, m, sc = jattn._abs_padded_prep(
        *w8, scales, heads, act_scale, 0.1, d ** -0.5)
    sc = sc.at[0, 2].set(jnp.float32(act_scale))
    if v_bf16:
        dp = wqp.shape[-1] // heads
        m = m.at[3].set(jnp.repeat(scales[:, 0, 2], dp)
                        * jnp.float32(act_scale))
        wop = (wop.astype(jnp.float32)
               * jnp.repeat(scales[:, 0, 3], dp)[:, None]).astype(
                   jnp.bfloat16)
    g = jnp.zeros((8, c), jnp.float32).at[0].set(g1).at[1].set(be1).at[
        2].set(bo)
    return jattn._abs_padded_ln_s8_impl(
        jnp.asarray(x), wqp, wkp, wvp, wop, m, g, sc, heads, 1e-6,
        v_bf16=v_bf16, interpret=True)


@pytest.mark.parametrize("v_bf16", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_plain_version_matches_pallas_kernel_in_interpret_mode(v_bf16,
                                                                   dtype):
    b, t, heads, d = 2, 32, 4, 8
    c = heads * d
    rng, norm, attn, (g1, be1, bo), w8, scales = _attention_case(
        41 + v_bf16, c, heads)
    x = rng.randn(b, t, c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    act_scale = 0.04
    ref = np.asarray(_k10_pallas(jnp.asarray(x, jdt), g1, be1, bo, w8,
                                 scales, heads, act_scale, v_bf16),
                     np.float32)
    p = S8.pack_ln_attention_rowmajor(norm, attn, heads, act_scale)
    tx = torch.from_numpy(x).to(tdt)
    out = S8.ln_attention_s8_rowmajor_reference(tx, p, v_bf16)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t, c)
    # the same rounding points, codes and int32 sums; the LN's rsqrt and
    # the bf16 P·V's fp32 sums in another order may move a code or a bf16
    # rounding (K3's tolerances, test_torch_port_int8.py)
    _kernel_close(out.float().numpy(), ref, mean_tol=2.5e-3)
    before = (S8.ln_attention_s8_rowmajor.launches,
              S8.ln_attention_s8_rowmajor.fallbacks)
    wrapped = S8.ln_attention_s8_rowmajor(tx, p, v_bf16)
    assert wrapped.dtype == tdt and torch.equal(wrapped, out.to(tdt))
    assert (S8.ln_attention_s8_rowmajor.launches,
            S8.ln_attention_s8_rowmajor.fallbacks) == before


@pytest.mark.parametrize("t,v_bf16,via_wrapper", [
    (30, True, True),     # T % 8: the rule sends it to the fallback
    (30, False, True),
    (32, False, False),   # a kernel shape, the fallback called directly
])
def test_k10_fallback_matches_jax_wrapper_on_cpu(t, v_bf16, via_wrapper):
    heads, d = 4, 8
    c = heads * d
    rng, norm, attn, (g1, be1, bo), w8, scales = _attention_case(9, c,
                                                                 heads)
    x = rng.randn(2, t, c).astype(np.float32)
    ref = jattn.absorbed_padded_ln_self_attention_s8(
        jnp.asarray(x), jnp.asarray(g1), jnp.asarray(be1), jnp.asarray(bo),
        *w8, scales, heads, d ** -0.5, 0.1, v_bf16=v_bf16,
        v_transposed=False)
    p = S8.pack_ln_attention_rowmajor(norm, attn, heads, 0.1)
    before = S8.ln_attention_s8_rowmajor.fallbacks
    if via_wrapper:
        out = S8.ln_attention_s8_rowmajor(_t(x), p, v_bf16)
        assert S8.ln_attention_s8_rowmajor.fallbacks == before + 1
    else:
        out = S8.ln_attention_s8_fallback(_t(x), p.ln)
    assert out.dtype == torch.float32 and out.shape == x.shape
    # fp32 on both sides: only the summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
