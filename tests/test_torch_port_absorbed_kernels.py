"""K16, K17 and K18 of the port against the JAX package on the CPU.

K16 (``use_absorbed_attention``'s attention with its four projections
inside), its backward on K2's arithmetic, K17 (the same on int8 weights
quantized per head, with dynamic scales per image and head) and K18 (an op:
per-tensor weight scales, the projections' scales per image): each plain
version against its Pallas kernel in interpret mode, each fallback against
the JAX wrapper on the CPU at a ragged T, and the weight quantizers' codes
and scales against JAX's. Inputs are made with numpy from a seed and handed
to both packages; each tolerance is stated with its reason where it is used.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from ldmseg_tpu.ops.pallas import attention as jattn  # noqa: E402
from ldmseg_torch.ops import attention as A  # noqa: E402
from ldmseg_torch.ops import attention_s8 as S8  # noqa: E402
from ldmseg_torch.ops import quant  # noqa: E402

from test_torch_port_int8 import _kernel_close, _t  # noqa: E402


def _case(seed, b, t, heads, d, w_std=0.2):
    """x [B, T, C] and four [C, C] weights in JAX's (in, out) layout."""
    rng = np.random.RandomState(seed)
    c = heads * d
    x = rng.randn(b, t, c).astype(np.float32)
    w = [(rng.randn(c, c) * w_std).astype(np.float32) for _ in range(4)]
    return x, w


def _hsplit(w, heads):
    """JAX's [C, C] (in, out) kernel -> the per-head [H, C, D] slices."""
    c = w.shape[0]
    return w.reshape(c, heads, c // heads).transpose(1, 0, 2)


def _torch_w(w, dtype=torch.float32):
    """The port's Linear layout (out, in) of a JAX kernel."""
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(dtype)


def _rel_close(out, ref, tol):
    """max |out - ref| <= tol * max|ref|."""
    out, ref = (np.asarray(x, np.float32) for x in (out, ref))
    err, scale = np.abs(out - ref).max(), np.abs(ref).max()
    assert scale > 0 and err <= tol * scale, (err, tol * scale)


def _dtypes(name):
    return ((jnp.float32, torch.float32) if name == "float32"
            else (jnp.bfloat16, torch.bfloat16))


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------
def _k16_pallas(x, wq, wk, wv, wo, heads, scale):
    """``_absorbed_impl`` in interpret mode, as
    ``tests/test_pallas_kernels.py:303-333`` runs it."""
    b, t, c = x.shape
    d = c // heads
    xspec = pl.BlockSpec((1, t, c), lambda i, j: (i, 0, 0))
    wspec = pl.BlockSpec((1, c, d), lambda i, j: (j, 0, 0))
    ospec = pl.BlockSpec((1, d, c), lambda i, j: (j, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._attn_kernel_absorbed, scale=scale,
                          heads=heads),
        grid=(b, heads), in_specs=[xspec, wspec, wspec, wspec, ospec],
        out_specs=xspec, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        scratch_shapes=[pltpu.VMEM((t, c), jnp.float32)],
        interpret=True)(x, _hsplit(wq, heads), _hsplit(wk, heads),
                        _hsplit(wv, heads), wo.reshape(heads, d, c))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,heads,d", [(2, 32, 4, 8), (1, 24, 2, 16)])
def test_k16_plain_version_matches_pallas_kernel_in_interpret_mode(
        b, t, heads, d, dtype):
    x, w = _case(b + t + d, b, t, heads, d)
    scale = d ** -0.5
    jdt, tdt = _dtypes(dtype)
    ref = np.asarray(_k16_pallas(
        jnp.asarray(x, jdt), *(jnp.asarray(wi, jdt) for wi in w), heads,
        scale).astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt)
    tw = [_torch_w(wi, tdt) for wi in w]
    # fp32: the same products in another summation order (to_out over the
    # whole depth, the kernel per head) and the softmax's; bf16: q, k, v,
    # P, oh and the output round to bf16 on both sides at the same points,
    # so a sum in another order moves a rounding by one ulp: two bf16 ulps
    # of max|ref|
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    before = (A.absorbed_self_attention.launches,
              A.absorbed_self_attention.fallbacks)
    for fn in (A.absorbed_attention_reference, A.absorbed_self_attention):
        out = fn(tx, *tw, heads, scale)
        assert out.dtype == tdt and out.shape == (b, t, heads * d)
        _rel_close(out.float().numpy(), ref, tol)
    # a CPU tensor at a kernel shape takes the plain version: no launch,
    # no fallback
    assert (A.absorbed_self_attention.launches,
            A.absorbed_self_attention.fallbacks) == before


def _xla_absorbed_grads(x, w, do, heads, scale, jdt):
    """``jax.vjp`` of ``_xla_absorbed`` for x and the four [C, C] kernels
    (JAX's ``_bwd_absorbed``, :330-338), each returned in the port's
    layout."""
    c = x.shape[-1]
    d = c // heads

    def fn(a, q_, k_, v_, o_):
        return jattn._xla_absorbed(a, _hsplit(q_, heads), _hsplit(k_, heads),
                                   _hsplit(v_, heads),
                                   o_.reshape(heads, d, c), scale)
    _, vjp = jax.vjp(fn, jnp.asarray(x, jdt),
                     *(jnp.asarray(wi, jdt) for wi in w))
    gx, *gw = (np.asarray(g.astype(jnp.float32))
               for g in vjp(jnp.asarray(do, jdt)))
    return [gx] + [g.T for g in gw]


@pytest.mark.parametrize("dtype,tol", [
    # fp32: K2's arithmetic and torch.matmul against XLA's VJP; only the
    # summation order differs
    ("float32", 1e-5),
    # bf16: _xla_absorbed rounds the scores to bf16 before the softmax,
    # K2 keeps them in fp32 (K14's case, test_torch_port_packed_kernels.py:
    # 8.3e-3 of max|ref| measured there), and each side rounds q, k, v, P,
    # dS and the gradients to bf16: 2e-2 of max|ref|
    ("bfloat16", 2e-2)])
def test_k16_backward_matches_jax_vjp_of_xla_absorbed(dtype, tol):
    b, t, heads, d = 2, 32, 2, 16
    x, w = _case(5, b, t, heads, d)
    do = np.random.RandomState(6).randn(b, t, heads * d).astype(np.float32)
    scale = d ** -0.5
    jdt, tdt = _dtypes(dtype)
    refs = _xla_absorbed_grads(x, w, do, heads, scale, jdt)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_(True)] + [
        _torch_w(wi, tdt).requires_grad_(True) for wi in w]
    out = A.absorbed_self_attention(*leaves, heads, scale)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do).to(tdt))
    for leaf, ref in zip(leaves, refs):
        assert leaf.grad.dtype == tdt and leaf.grad.shape == leaf.shape
        _rel_close(leaf.grad.float().numpy(), ref, tol)


def test_k16_plain_backward_passes_gradcheck():
    # float64 through the autograd Function on the CPU: the plain forward,
    # the backward attention_backward_reference on the saved head views
    # (fast mode: the Jacobian against random directions, which keeps the
    # test within a second)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 8, 16)).requires_grad_(True)
    w = [torch.from_numpy(rng.randn(16, 16) * 0.3).requires_grad_(True)
         for _ in range(4)]
    assert torch.autograd.gradcheck(
        lambda *a: A.absorbed_self_attention(*a, 2, 0.35), (x, *w),
        fast_mode=True)


@pytest.mark.parametrize("t,heads,d", [
    (30, 2, 8),    # T % 8
    (16, 4, 4),    # d % 8
])
def test_k16_fallback_matches_jax_wrapper_on_cpu(t, heads, d):
    b = 2
    x, w = _case(t + d, b, t, heads, d)
    do = np.random.RandomState(t).randn(b, t, heads * d).astype(np.float32)
    scale = d ** -0.5
    c = heads * d
    args = [jnp.asarray(x)] + [jnp.asarray(wi) for wi in w]
    ref, vjp = jax.vjp(lambda a, q_, k_, v_, o_: jattn.absorbed_self_attention(
        a, _hsplit(q_, heads), _hsplit(k_, heads), _hsplit(v_, heads),
        o_.reshape(heads, d, c), heads, scale), *args)
    gx, *gw = (np.asarray(g) for g in vjp(jnp.asarray(do)))
    leaves = [_t(x).requires_grad_(True)] + [
        _torch_w(wi).requires_grad_(True) for wi in w]
    before = A.absorbed_self_attention.fallbacks
    out = A.absorbed_self_attention(*leaves, heads, scale)
    assert A.absorbed_self_attention.fallbacks == before + 1
    out.backward(torch.from_numpy(do))
    # fp32 on both sides, XLA's autodiff against PyTorch's through the same
    # function: only the summation order differs
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for leaf, g in zip(leaves, [gx] + [g.T for g in gw]):
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5)


def test_k16_fallback_keeps_the_input_dtype_scores():
    # _xla_absorbed's projections, scores and to_out are bf16 einsums, and
    # so are the fallback's: on the same bf16 inputs the two differ only by
    # the fp32 sums in another order (two bf16 ulps of max|ref|)
    b, t, heads, d = 1, 30, 2, 16
    x, w = _case(11, b, t, heads, d)
    c = heads * d
    ref = np.asarray(jattn.absorbed_self_attention(
        jnp.asarray(x, jnp.bfloat16),
        *(jnp.asarray(_hsplit(wi, heads), jnp.bfloat16) for wi in w[:3]),
        jnp.asarray(w[3].reshape(heads, d, c), jnp.bfloat16), heads,
        d ** -0.5).astype(jnp.float32))
    out = A.absorbed_self_attention(
        torch.from_numpy(x).to(torch.bfloat16),
        *(_torch_w(wi, torch.bfloat16) for wi in w), heads, d ** -0.5)
    assert out.dtype == torch.bfloat16
    _rel_close(out.float().numpy(), ref, 1.6e-2)


# ---------------------------------------------------------------------------
# K17
# ---------------------------------------------------------------------------
def _port_head_codes(w, heads):
    """The port's ``quantize_head_weights`` on the torch layout of the JAX
    kernels ``w``: (w_qkv [3C, C], wo [C, C], scales [4, H])."""
    q8, k8, v8, o8, sc = quant.quantize_head_weights(
        *(_torch_w(wi) for wi in w), heads)
    return torch.cat([q8, k8, v8]), o8, sc


def test_quantize_head_weights_matches_jax_for_k17():
    heads, d = 4, 8
    c = heads * d
    _, w = _case(3, 1, 8, heads, d)
    jq, jk, jv, jo, jsc = (np.asarray(a) for a in jattn.quantize_head_weights(
        *(jnp.asarray(wi) for wi in w), heads))
    w_qkv, wo8, sc = _port_head_codes(w, heads)
    # JAX's [H, C, D] slices of the (in, out) kernel are the port's rows of
    # head h, transposed; its wo [H, D, C] is the (in, out) kernel by rows
    for i, j8 in enumerate((jq, jk, jv)):
        flat = j8.transpose(1, 0, 2).reshape(c, c)
        np.testing.assert_array_equal(w_qkv[i * c:(i + 1) * c].numpy(),
                                      flat.T)
    np.testing.assert_array_equal(wo8.numpy(), jo.reshape(c, c).T)
    np.testing.assert_array_equal(sc.numpy(), jsc[:, 0, :4].T)


def _k17_pallas(x, w, heads, scale, act_scale):
    """``absorbed_self_attention_s8``'s kernel branch (:493-497) with
    ``_absorbed_s8_impl``'s pallas_call in interpret mode (the JAX wrapper
    takes XLA on the CPU), on ``quantize_head_weights``' codes."""
    b, t, c = x.shape
    d = c // heads
    wq8, wk8, wv8, wo8, scales = jattn.quantize_head_weights(
        *(jnp.asarray(wi) for wi in w), heads)
    x8 = jnp.clip(jnp.round(x.astype(jnp.float32) / act_scale), -127,
                  127).astype(jnp.int8)
    sc = scales.at[:, 0, 4].set(jnp.float32(act_scale))
    xspec = pl.BlockSpec((1, t, c), lambda i, j: (i, 0, 0))
    wspec = pl.BlockSpec((1, c, d), lambda i, j: (j, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._attn_kernel_absorbed_s8, scale=scale,
                          heads=heads),
        grid=(b, heads),
        in_specs=[xspec, wspec, wspec, wspec,
                  pl.BlockSpec((1, d, c), lambda i, j: (j, 0, 0)),
                  pl.BlockSpec((1, 8, 128), lambda i, j: (j, 0, 0))],
        out_specs=xspec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((t, c), jnp.float32)],
        interpret=True)(x8, wq8, wk8, wv8, wo8, sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,heads,d", [(2, 32, 4, 8), (1, 24, 2, 16)])
def test_k17_plain_version_matches_pallas_kernel_in_interpret_mode(
        b, t, heads, d, dtype):
    x, w = _case(2 * t + d, b, t, heads, d)
    scale = d ** -0.5
    jdt, tdt = _dtypes(dtype)
    act_scale = 0.03
    ref = np.asarray(_k17_pallas(jnp.asarray(x, jdt), w, heads, scale,
                                 act_scale), np.float32)
    w_qkv, wo8, sc = _port_head_codes(w, heads)
    tx = torch.from_numpy(x).to(tdt)
    out = S8.absorbed_attention_s8_reference(tx, w_qkv, wo8, sc, heads,
                                             scale, act_scale)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    # the same codes, scales and int32 sums; PyTorch's and XLA's exp may
    # differ by an ulp, which flips a code of e at a .5 boundary and moves
    # a dynamic scale, so a few outputs move by a code's worth (K13's and
    # K15's tolerance)
    _kernel_close(out.float().numpy(), ref, mean_tol=2.5e-3)
    before = (S8.absorbed_self_attention_s8.launches,
              S8.absorbed_self_attention_s8.fallbacks)
    wrapped = S8.absorbed_self_attention_s8(tx, w_qkv, wo8, sc, heads, scale,
                                            act_scale)
    assert wrapped.dtype == tdt and torch.equal(wrapped, out.to(tdt))
    assert (S8.absorbed_self_attention_s8.launches,
            S8.absorbed_self_attention_s8.fallbacks) == before


@pytest.mark.parametrize("t,via_wrapper", [
    (30, True),     # T % 8: the rule sends it to the fallback
    (32, False),    # a kernel shape, the fallback called directly
])
def test_k17_fallback_matches_jax_wrapper_on_cpu(t, via_wrapper):
    heads, d = 2, 16
    x, w = _case(t + 1, 2, t, heads, d)
    scale = d ** -0.5
    jq, jk, jv, jo, jsc = jattn.quantize_head_weights(
        *(jnp.asarray(wi) for wi in w), heads)
    ref = jattn.absorbed_self_attention_s8(jnp.asarray(x), jq, jk, jv, jo,
                                           jsc, heads, scale, 0.1)
    w_qkv, wo8, sc = _port_head_codes(w, heads)
    before = S8.absorbed_self_attention_s8.fallbacks
    if via_wrapper:
        out = S8.absorbed_self_attention_s8(_t(x), w_qkv, wo8, sc, heads,
                                            scale, 0.1)
        assert S8.absorbed_self_attention_s8.fallbacks == before + 1
    else:
        out = S8.absorbed_attention_s8_fallback(_t(x), w_qkv, wo8, sc, heads,
                                                scale)
    assert out.dtype == torch.float32 and out.shape == x.shape
    # float attention on the same dequantized weights, fp32 on both sides:
    # only the summation order differs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# K18
# ---------------------------------------------------------------------------
def _port_fullc_codes(w):
    q8, k8, v8, o8, sc = quant.quantize_fullc_weights(
        *(_torch_w(wi) for wi in w))
    return torch.cat([q8, k8, v8]), o8, sc


def test_quantize_fullc_weights_matches_jax():
    heads, d = 4, 8
    c = heads * d
    _, w = _case(4, 1, 8, heads, d)
    jq, jk, jv, jwop, jsc = (np.asarray(a) for a in
                             jattn.quantize_fullc_weights(
                                 *(jnp.asarray(wi) for wi in w), heads))
    w_qkv, wo8, sc = _port_fullc_codes(w)
    for i, j8 in enumerate((jq, jk, jv)):
        np.testing.assert_array_equal(w_qkv[i * c:(i + 1) * c].numpy(),
                                      j8.T)
    # wop [H, 128, C]: head h's rows of the (in, out) kernel, then zeros
    assert jwop.shape == (heads, 128, c) and not jwop[:, d:].any()
    np.testing.assert_array_equal(wo8.numpy(),
                                  jwop[:, :d].reshape(c, c).T)
    np.testing.assert_array_equal(sc.numpy(), jsc[0, 1:5])


def _k18_pallas(x, w, heads, scale, act_scale):
    """``absorbed_fullc_self_attention_s8``'s kernel branch (:639-643) with
    ``_absorbed_fullc_s8_impl``'s pallas_call in interpret mode, as
    ``tests/test_pallas_kernels.py:562-615`` runs it."""
    b, t, c = x.shape
    wq8, wk8, wv8, wop8, sc = jattn.quantize_fullc_weights(
        *(jnp.asarray(wi) for wi in w), heads)
    x8 = jnp.clip(jnp.round(x.astype(jnp.float32) / act_scale), -127,
                  127).astype(jnp.int8)
    sc = sc.at[0, 0].set(jnp.float32(act_scale))
    wspec = pl.BlockSpec((1, c, c), lambda i: (0, 0, 0))
    return pl.pallas_call(
        functools.partial(jattn._attn_kernel_absorbed_fullc_s8, scale=scale,
                          heads=heads),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, t, c), lambda i: (i, 0, 0)),
                  wspec, wspec, wspec,
                  pl.BlockSpec((1,) + wop8.shape, lambda i: (0, 0, 0, 0)),
                  pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, t, c), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.bfloat16),
        interpret=True)(x8, wq8[None], wk8[None], wv8[None], wop8[None], sc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,heads,d", [(2, 32, 4, 8), (1, 24, 2, 16)])
def test_k18_plain_version_matches_pallas_kernel_in_interpret_mode(
        b, t, heads, d, dtype):
    x, w = _case(3 * t + d, b, t, heads, d)
    scale = d ** -0.5
    jdt, tdt = _dtypes(dtype)
    act_scale = 0.03
    ref = np.asarray(_k18_pallas(jnp.asarray(x, jdt), w, heads, scale,
                                 act_scale), np.float32)
    w_qkv, wo8, sc = _port_fullc_codes(w)
    tx = torch.from_numpy(x).to(tdt)
    out = S8.absorbed_attention_s8_reference(tx, w_qkv, wo8, sc, heads,
                                             scale, act_scale, per_image=True)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    # K17's tolerance: the same rounding points, per-image scales
    _kernel_close(out.float().numpy(), ref, mean_tol=2.5e-3)
    before = (S8.absorbed_fullc_self_attention_s8.launches,
              S8.absorbed_fullc_self_attention_s8.fallbacks)
    wrapped = S8.absorbed_fullc_self_attention_s8(tx, w_qkv, wo8, sc, heads,
                                                  scale, act_scale)
    assert wrapped.dtype == tdt and torch.equal(wrapped, out.to(tdt))
    assert (S8.absorbed_fullc_self_attention_s8.launches,
            S8.absorbed_fullc_self_attention_s8.fallbacks) == before
    # per-image scales are not K17's per-head ones: the check has teeth
    assert not torch.equal(out, S8.absorbed_attention_s8_reference(
        tx, w_qkv, wo8, sc, heads, scale, act_scale))


@pytest.mark.parametrize("t", [30, 2056])   # T % 8, T > 2048
def test_k18_fallback_matches_jax_wrapper_on_cpu(t):
    heads, d = 2, 8
    x, w = _case(t, 1, t, heads, d)
    scale = d ** -0.5
    ref = jattn.absorbed_fullc_self_attention_s8(
        jnp.asarray(x), *jattn.quantize_fullc_weights(
            *(jnp.asarray(wi) for wi in w), heads), heads, scale, 0.1)
    w_qkv, wo8, sc = _port_fullc_codes(w)
    before = S8.absorbed_fullc_self_attention_s8.fallbacks
    out = S8.absorbed_fullc_self_attention_s8(_t(x), w_qkv, wo8, sc, heads,
                                              scale, 0.1)
    assert S8.absorbed_fullc_self_attention_s8.fallbacks == before + 1
    assert out.dtype == torch.float32 and out.shape == x.shape
    # float attention on the same dequantized weights, fp32 on both sides
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
