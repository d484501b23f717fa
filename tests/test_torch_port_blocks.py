"""The port's building blocks against their JAX counterparts on the CPU.

Each case initialises the Flax block, converts its parameters with the
port's converter helpers, runs both on the same numpy input in fp32 and
compares (NHWC against NCHW): rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models import layers as jl  # noqa: E402
from ldmseg_tpu.models import unet as ju  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models import layers as tl  # noqa: E402
from ldmseg_torch.models import unet as tu  # noqa: E402


def _strip(sd):
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def _load(module, fill, params):
    sd = {}
    fill(sd, "m", params)
    module.load_state_dict(_strip(sd), strict=True)
    return module


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _resnet():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 10, 8).astype(np.float32)
    temb = rng.randn(2, 12).astype(np.float32)
    jm = jl.ResnetBlock(16, groups=4, eps=1e-5)
    p = jm.init(jax.random.key(0), x, temb)["params"]
    ref = jm.apply({"params": p}, x, temb)
    tm = _load(tl.ResnetBlock(8, 16, 4, 1e-5, temb_channels=12),
               convert._resnet, p)
    return ref, tm(_nchw(x), torch.from_numpy(temb))


def _attention_block(use_fused):
    def run():
        x = np.random.RandomState(1).randn(2, 4, 6, 16).astype(np.float32)
        jm = jl.AttentionBlock2D(16, groups=4, use_fused=use_fused)
        p = jm.init(jax.random.key(1), x)["params"]
        ref = jm.apply({"params": p}, x)

        def fill(sd, pfx, node):
            convert._norm(sd, f"{pfx}.group_norm", node["group_norm"])
            convert._attention(sd, pfx, node)
        tm = _load(tl.AttentionBlock2D(16, groups=4, use_fused=use_fused),
                   fill, p)
        return ref, tm(_nchw(x))
    return run


def _transformer():
    x = np.random.RandomState(2).randn(2, 4, 6, 16).astype(np.float32)
    jm = ju.Transformer2D(16, 2, 16, groups=4, use_cross_attention=False,
                          use_fused_attention=True)
    p = jm.init(jax.random.key(2), x)["params"]
    ref = jm.apply({"params": p}, x)
    tm = _load(tu.Transformer2D(16, 2, groups=4, use_fused=True),
               convert._transformer, p)
    return ref, tm(_nchw(x))


def _downsample():
    x = np.random.RandomState(3).randn(2, 6, 10, 16).astype(np.float32)
    jm = ju.Downsample(16)
    p = jm.init(jax.random.key(3), x)["params"]
    ref = jm.apply({"params": p}, x)
    tm = _load(tu.Downsample(16),
               lambda sd, pfx, n: convert._conv(sd, f"{pfx}.conv", n["conv"]),
               p)
    return ref, tm(_nchw(x))


def _upsample(target_hw):
    def run():
        x = np.random.RandomState(4).randn(2, 3, 5, 16).astype(np.float32)
        jm = ju.Upsample(16)
        p = jm.init(jax.random.key(4), x, target_hw)["params"]
        ref = jm.apply({"params": p}, x, target_hw)
        tm = _load(tu.Upsample(16), lambda sd, pfx, n: convert._conv(
            sd, f"{pfx}.conv", n["conv"]), p)
        return ref, tm(_nchw(x), target_hw)
    return run


def _conv_transpose():
    x = np.random.RandomState(5).randn(2, 3, 5, 8).astype(np.float32)
    jm = jl.ConvTranspose2x(16)
    p = jm.init(jax.random.key(5), x)["params"]
    ref = jm.apply({"params": p}, x)
    tm = _load(tl.ConvTranspose2x(8, 16), convert._conv_transpose, p)
    return ref, tm(_nchw(x))


def _layernorm2d():
    x = np.random.RandomState(6).randn(2, 3, 5, 16).astype(np.float32)
    jm = jl.LayerNorm2d()
    p = {"ln": {"scale": np.random.RandomState(7).randn(16),
                "bias": np.random.RandomState(8).randn(16)}}
    ref = jm.apply({"params": p}, x)
    tm = _load(tl.LayerNorm2d(16),
               lambda sd, pfx, n: convert._norm(sd, pfx, n["ln"]), p)
    return ref, tm(_nchw(x))


CASES = {
    "resnet": _resnet,
    "attention_block": _attention_block(False),
    "attention_block_fused": _attention_block(True),
    "transformer2d_fused": _transformer,
    "downsample": _downsample,
    "upsample_2x": _upsample(None),
    "upsample_to_odd_skip": _upsample((7, 11)),
    "conv_transpose_2x": _conv_transpose,
    "layernorm2d": _layernorm2d,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    ref, out = CASES[name]()
    out = out.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 19, 999], dtype=np.int32)
    ref = jl.timestep_embedding(jnp.asarray(t), 32)
    out = tl.timestep_embedding(torch.from_numpy(t), 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
