"""K1 and K2 in the PyTorch port against the JAX Pallas kernels.

The port's plain versions (``attention_reference``,
``attention_backward_reference``) and its wrappers on CPU tensors (which
must take the plain versions) are compared with the JAX kernel bodies run in
interpret mode, as ``tests/test_pallas_kernels.py`` runs them: the forward
``_attn_kernel`` through ``pl.pallas_call(..., interpret=True)``, the
backward through ``_flash_bwd(..., interpret=True)``.
Tolerances: fp32 1e-5 (the same fp32 arithmetic, summed in another order);
bf16 1.6e-2, two bf16 ulps at 1.0, since both sides round P (and dS) to bf16
but sum in another order. Backward tolerances are relative to each
gradient's own max|ref|.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ldmseg_tpu.ops.pallas.attention import (  # noqa: E402
    _attn_kernel, _flash_bwd, _xla_reference)
from ldmseg_torch.ops import attention as port  # noqa: E402


def _pallas_interpret(q, k, v, scale, block_q=32):
    """The JAX kernel body over ``[BH, T, D]`` in interpret mode."""
    bh, t, d = q.shape
    bq = min(block_q, t)
    return pl.pallas_call(
        functools.partial(_attn_kernel, scale=scale),
        grid=(bh, t // bq),
        in_specs=[
            pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
            pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((1, t, d), lambda i, j: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, bq, d), lambda i, j: (i, j, 0)),
        out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
        interpret=True,
    )(q, k, v)


def _inputs(seed, b, t, h, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _flat(x):  # [B, T, H, D] -> [B*H, T, D]
    b, t, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, t, d)


# (B, H) split of BH=4 and BH=2; the (BH, T, D) shapes of the issue
SHAPES = [(2, 64, 2, 40), (1, 32, 2, 160)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k1_port_matches_pallas_interpret(shape, dtype):
    q, k, v = _inputs(0, *shape)
    scale = shape[-1] ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = _pallas_interpret(*(jnp.asarray(_flat(x), jdt) for x in (q, k, v)),
                            scale)
    ref = np.asarray(ref.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    atol = 1e-5 if dtype == "float32" else 1.6e-2

    before = port.fused_self_attention.launches
    for fn in (port.attention_reference, port.fused_self_attention):
        out = fn(tq, tk, tv, scale)
        assert out.dtype == tdt and out.shape == tq.shape
        np.testing.assert_allclose(_flat(out.float().numpy()), ref, rtol=0,
                                   atol=atol)
    # CPU tensors take the plain version: the kernel count does not move
    assert port.fused_self_attention.launches == before


# ---------------------------------------------------------------------------
# K2: the backward
# ---------------------------------------------------------------------------
def _unflat(x, b, h):  # [B*H, T, D] -> [B, T, H, D]
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).transpose(0, 2, 1, 3)


def _close_rel(out, ref, tol):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    assert scale > 0
    bound = tol * scale
    err = float(np.abs(np.asarray(out, np.float32) - ref).max())
    assert err <= bound, f"max abs diff {err} > {bound}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_port_matches_pallas_interpret(shape, dtype):
    b, t, h, d = shape
    q, k, v, do = _inputs(1, *shape) + _inputs(2, *shape)[:1]
    scale = d ** -0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    refs = _flash_bwd(*(jnp.asarray(_flat(x), jdt) for x in (q, k, v, do)),
                      scale, 16, interpret=True)
    refs = [_unflat(np.asarray(r.astype(jnp.float32)), b, h) for r in refs]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    tol = 1e-5 if dtype == "float32" else 1.6e-2

    before = port.fused_self_attention_backward.launches
    for fn in (port.attention_backward_reference,
               port.fused_self_attention_backward):
        for out, ref in zip(fn(tq, tk, tv, tdo, scale), refs):
            assert out.dtype == tdt and out.shape == tq.shape
            _close_rel(out.float().numpy(), ref, tol)
    assert port.fused_self_attention_backward.launches == before


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_k2_autograd_on_cpu_matches_xla_vjp(shape):
    # fp32: the CPU path of the autograd Function against jax.vjp of the
    # XLA reference, which the JAX custom_vjp uses on the CPU
    b, t, h, d = shape
    q, k, v, do = _inputs(3, *shape) + _inputs(4, *shape)[:1]
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda a, c, e: _xla_reference(a, c, e, scale),
                     *(jnp.asarray(_flat(x)) for x in (q, k, v)))
    refs = [_unflat(np.asarray(r), b, h) for r in vjp(jnp.asarray(_flat(do)))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = (port.fused_self_attention.launches,
              port.fused_self_attention_backward.launches)
    out = port.fused_self_attention(*leaves, scale)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    for leaf, ref in zip(leaves, refs):
        _close_rel(leaf.grad.numpy(), ref, 1e-5)
    assert (port.fused_self_attention.launches,
            port.fused_self_attention_backward.launches) == before


def test_k2_plain_version_passes_gradcheck():
    # float64 through the autograd Function on the CPU: forward
    # attention_reference, backward attention_backward_reference
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 5, 2, 8)).requires_grad_(True)
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, c, e: port.fused_self_attention(a, c, e, 0.4), (q, k, v))


def test_no_grad_attention_saves_nothing():
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _inputs(6, 1, 8, 2, 8))
    with torch.no_grad():
        out = port.fused_self_attention(q, k, v, 0.3)
    assert out.grad_fn is None
    np.testing.assert_array_equal(
        out.numpy(), port.attention_reference(q, k, v, 0.3).detach().numpy())
