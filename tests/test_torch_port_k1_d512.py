"""K1's wide class (head dim 512, the image VAE's mid attention) where no
card is.

``csrc/attention_fwd.cu:attention_fwd_kernel_sm90_wide`` runs only on the
card (``tests/test_torch_port_k1_d512_card.py``). What the CPU pins:

* the launch plan at the three shapes the card is held to and at a ragged
  T: shared memory within a block's 232,448 bytes, a consumer's registers
  for two score tiles, O and P within its 240, the grid of query tiles
  times V slices, and the C side's copies of the class, the slice and the
  rules (``struct Plan`` unchanged);
* the plain version (``attention_reference``) against ``_attn_kernel``
  through ``pl.pallas_call(..., interpret=True)`` at [1, 256, 512] (JAX's
  dispatch takes the Pallas kernel there on the TPU): O within 1.6e-2 of
  max|O| and P equal but for ``P_FLIPS`` of its entries, each one bf16
  ulp off; the kernel's two-pass blocked model at the wide class's 64-key
  tiles against the same Pallas run;
* ``AttentionBlock2D(use_fused=True)`` at C = 512 against JAX's in fp32
  (on the CPU JAX sends it to ``_xla_bthd``, the port to the plain
  version): within 1e-4 of max|ref|.
"""

import math
import pathlib
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.models.layers import AttentionBlock2D as JAttention  # noqa
from ldmseg_torch.models.layers import AttentionBlock2D  # noqa: E402
from ldmseg_torch.ops import attention as A  # noqa: E402

from test_torch_port_k1_sm90 import _bf16, _pallas, _two_pass_model  # noqa

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = [ROOT / "ldmseg_torch/csrc/attention_fwd.cu",
           ROOT / "ldmseg_torch/csrc/attention_sm90.cuh"]
# (B·H, T): the encode at 256x512 (a 32x64 mid block), the bench's batch
# 16, KITTI's 192x640 at batch 8, and a ragged T
PLAN_CASES = [(2, 2048), (16, 2048), (8, 1920), (1, 100)]
CONSUMER_REGS = 240
P_FLIPS = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bh,t", PLAN_CASES)
def test_wide_plan_fits_the_card(bh, t):
    plan = A.sm90_launch_plan(bh, t, 512)
    assert plan.head_class == A.SM90_WIDE_CLASS == 512
    assert (plan.block_q, plan.block_k, plan.box_d) == (64, 64, 64)
    assert plan.chunks * plan.box_d == 512  # Q and K across all of D
    assert plan.v_chunks * plan.box_d == A.SM90_WIDE_SLICE == 128
    assert plan.slices == 4 and plan.stages == 2
    assert plan.smem_bytes == A.sm90_smem_bytes(64, 64, 8, 2, 2) == 230440
    assert plan.smem_bytes <= A.SM90_SMEM_LIMIT
    # a consumer thread's registers: two 64 x 64 score tiles (32 each),
    # the 64 x 128 O slice (64) and P packed in pairs (16)
    scores = 2 * (64 * plan.block_k // 128)
    o_acc = 64 * A.SM90_WIDE_SLICE // 128
    p_regs = 64 * plan.block_k // 128 // 2
    assert scores + o_acc + p_regs <= CONSUMER_REGS - 64
    tiles, heads = plan.grid
    assert heads == bh and tiles == plan.slices * -(-t // 64)
    assert list(plan.as_c()) == [512, 64, 64, 2, 64, 8, 230440, tiles, bh]


def test_wide_plan_matches_the_kernel_source():
    src = "".join(p.read_text() for p in SOURCES)
    assert f"kWideClass = {A.SM90_WIDE_CLASS};" in src
    assert f"kWideN = {A.SM90_WIDE_SLICE};" in src
    # the C check's grid and tiles for the class
    assert "grid_x == slices * ((t + block_q - 1) / block_q)" in src
    assert "(block_q == 64 || (block_q == 128 && !wide))" in src
    assert re.search(r"v_chunks = wide \? attn90::kWideN / kBox : chunks",
                     src)
    assert "attn90::launch_as<K1WideKernel, attn90::kWideN, 1>" in src
    # the other classes keep their plan
    assert A.sm90_launch_plan(16, 2048, 160).head_class == 160
    assert A.sm90_launch_plan(16, 2048, 160).slices == 1


def test_head_dim_caps():
    # K2, K16 and fp32 stop at 160; K1 in bf16 at 512
    assert A.MAX_HEAD_DIM == 160 and A.MAX_FWD_HEAD_DIM == 512
    q = torch.zeros(1, 8, 1, 512)
    with pytest.raises(ValueError, match="up to 160"):
        A._check_kernel_inputs(q=q, k=q, v=q)
    A._check_kernel_inputs(512, q=q.bfloat16(), k=q.bfloat16(),
                           v=q.bfloat16())


def test_plain_version_keeps_attn_kernels_rounding_at_d512():
    t, d = 256, 512
    rng = np.random.RandomState(0)
    q, k, v = (_bf16(rng.randn(1, t, d)) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o_ref = np.asarray(_pallas(jq, jk, jv, scale, jnp.bfloat16)
                       .astype(jnp.float32))[0]
    eye = jnp.eye(t, dtype=jnp.bfloat16)[None]
    p_ref = np.asarray(_pallas(jq, jk, eye, scale, jnp.float32))[0]

    def port(x):  # [T, D] -> [1, T, 1, D] bf16
        return torch.from_numpy(x)[None, :, None].to(torch.bfloat16)
    o = A.attention_reference(port(q[0]), port(k[0]), port(v[0]),
                              scale)[0, :, 0].float().numpy()
    p = A.attention_reference(port(q[0]), port(k[0]),
                              torch.eye(t)[None, :, None].bfloat16(),
                              scale)[0, :, 0].float().numpy()
    assert np.abs(o - o_ref).max() <= 1.6e-2 * np.abs(o_ref).max()
    for got in (p, _two_pass_model(q[0], k[0], v[0], scale, 64)[1]):
        differ = got != p_ref
        ulp = np.exp2(np.floor(np.log2(np.maximum(p_ref, 1e-38))) - 7)
        assert np.all(np.abs(got - p_ref)[differ] <= ulp[differ] * 1.0001)
        assert differ.sum() <= P_FLIPS * t * t, differ.sum()
    # the kernel's model at the class's 64-key tiles: O as close
    o_model = _two_pass_model(q[0], k[0], v[0], scale, 64)[0]
    assert np.abs(o_model - o_ref).max() <= 1.6e-2 * np.abs(o_ref).max()


def test_attention_block_2d_at_512_channels_matches_jax():
    c, h, w = 512, 8, 16
    x = np.random.RandomState(1).randn(1, h, w, c).astype(np.float32)
    jmod = JAttention(c, groups=32, eps=1e-6, use_fused=True)
    params = jmod.init(jax.random.key(0), jnp.zeros((1, h, w, c)))
    rng = np.random.RandomState(2)
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * (0.05 if a.ndim == 2 else 0.1)
                   + (1.0 if a.ndim == 1 and a.shape == (c,) else 0.0)
                   ).astype(np.float32), params)
    ref = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    p = params["params"]
    port = AttentionBlock2D(c, use_fused=True)
    sd = {"group_norm.weight": p["group_norm"]["scale"],
          "group_norm.bias": p["group_norm"]["bias"]}
    for name, key in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                      ("to_out", "to_out.0")):
        sd[f"{key}.weight"] = np.asarray(p[name]["kernel"]).T
        sd[f"{key}.bias"] = p[name]["bias"]
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(v, np.float32))) for k, v in sd.items()})
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    out = out.permute(0, 2, 3, 1).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
