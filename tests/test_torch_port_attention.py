"""K1 in the PyTorch port against the JAX Pallas kernel.

The port's plain version (``attention_reference``) and its wrapper on CPU
tensors (which must take the plain version) are compared with the JAX
kernel body ``_attn_kernel`` run through ``pl.pallas_call(...,
interpret=True)``, as ``tests/test_pallas_kernels.py`` runs it.
Tolerances: fp32 1e-5 (the same fp32 arithmetic, summed in another order);
bf16 1.6e-2, two bf16 ulps at 1.0, since both sides round P to bf16 but sum
in another order.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from ldmseg_tpu.ops.pallas.attention import _attn_kernel  # noqa: E402
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
