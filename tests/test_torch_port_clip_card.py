"""Clip sampling on the card: the DDIM pass and the ``ddim_refine`` tail
replayed as CUDA graphs.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu tests/test_torch_port_clip_card.py

At full width (the default deployment's SD-1.4 UNet, bf16,
self-conditioning, one clip of 3 frames of 256x512 with a full-size
``PoseExpNet`` attached), 4 DDIM steps and a refine tail of 2
(``refine_strength`` 0.5): 16 K1 a step of either pass on the counters,
x0 and logits bit-equal to the eager loop's at the same noise with the
same launches, the warp moving the frames; the first pass alone
(``pose_warp=False``) the same; and in the serving configuration's int8
path (``tools/bench.py:bench_config``) 16 K3 and 16 K4 a step and one K1
D=512 a call, graph bit-equal to eager. Without a card each test skips in
the ``cuda`` fixture.
"""

import numpy as np
import pytest
import torch

from ldmseg_torch.ops.counters import counted_wrappers
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

pytestmark = pytest.mark.gpu

STEPS, STRENGTH, TAIL = 4, 0.5, 2
T, HW = 3, (256, 512)
CFG = merge_dicts(DEFAULT_CONFIG, {"train_kwargs": {
    "self_condition": True, "weight_dtype": "bfloat16"}})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    out = {}
    for fn in counted_wrappers():
        for a in ("launches", "fallbacks", "wide_launches"):
            if hasattr(fn, a):
                out[(fn.__name__, a)] = getattr(fn, a)
    return out


def _delta(fn):
    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    after = _counts()
    return out, {k: after[k] - v for k, v in before.items() if after[k] != v}


def _trainer(cfg):
    from ldmseg_torch.models.layers import init_random_
    from ldmseg_torch.models.posenet import PoseExpNet
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    trainer = TrainerDiffusion(cfg)
    trainer.init_params(seed=0)
    pose = PoseExpNet(nb_ref_imgs=T - 1).to("cuda")
    init_random_(pose, torch.Generator(device="cuda").manual_seed(7))
    trainer.attach_pose(pose)
    return trainer


def _clip():
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    from ldmseg_torch.data.video import ClipDataset
    clip = ClipDataset(SyntheticDVPS(length=T, size=HW, num_bits=8,
                                     frames_per_scene=T), clip_len=T)[0]
    return {"image": clip["image"][None], "depth": clip["depth"][None],
            "meta": [clip["meta"]]}


def _graph_vs_eager(trainer, batch, **kw):
    def call(graph):
        return trainer.sample_panoptic_clip(
            batch, num_inference_steps=STEPS, refine_strength=STRENGTH,
            graph=graph, **kw)
    call(True)  # warm-up: the kernels build, their caches fill
    (logits, x0), graph = _delta(lambda: call(True))
    (logits_e, x0_e), eager = _delta(lambda: call(False))
    assert torch.equal(x0, x0_e) and torch.equal(logits, logits_e)
    assert graph == eager
    assert bool(torch.isfinite(logits).all())
    assert tuple(x0.shape) == (T, HW[0] // 8, HW[1] // 8, 4)
    return x0, graph


def test_bf16_clip_graph_equals_eager(cuda):
    trainer = _trainer(CFG)
    batch = _clip()
    x0, counts = _graph_vs_eager(trainer, batch)
    assert counts == {("fused_self_attention", "launches"):
                      16 * (STEPS + TAIL)}
    plain, counts = _graph_vs_eager(trainer, batch, pose_warp=False)
    assert counts == {("fused_self_attention", "launches"): 16 * STEPS}
    assert not torch.equal(x0, plain)  # the warp and the tail moved it


def test_serving_int8_clip_graph_equals_eager(cuda):
    from ldmseg_torch.tools.bench import bench_config
    trainer = _trainer(bench_config(True, "ddim"))
    _, counts = _graph_vs_eager(trainer, _clip())
    n = 16 * (STEPS + TAIL)
    assert counts == {("ln_attention_s8", "launches"): n,
                      ("geglu_ln_s8", "launches"): n,
                      ("fused_self_attention", "wide_launches"): 1}


def test_pose_net_and_warp_on_the_card(cuda):
    """The pose net's poses and the warp on the card against the same
    modules on the CPU (fp32, TF32 off)."""
    from ldmseg_torch.losses.pose_consistency import inverse_warp
    trainer = _trainer(CFG)
    batch = _clip()
    image = torch.from_numpy(batch["image"])
    poses, mid, refs = trainer._clip_poses(image.cuda())
    cpu_net = trainer.pose_model.to("cpu")
    with torch.no_grad():
        frames = image.permute(0, 1, 4, 2, 3)
        _, ref = cpu_net(frames[:, mid], [frames[:, i] for i in refs],
                         train=False)
    trainer.pose_model.to("cuda")
    np.testing.assert_allclose(poses.cpu().numpy(), ref.numpy(), rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    depth = torch.from_numpy(batch["depth"][:, mid])
    x = torch.randn((1, 4, HW[0], HW[1]))
    focal = torch.tensor([707.0])
    w, v = inverse_warp(x.cuda(), depth.cuda(), ref[:, 0].cuda(),
                        focal.cuda(), channels_last=False)
    w_ref, v_ref = inverse_warp(x, depth, ref[:, 0], focal,
                                channels_last=False)
    assert torch.equal(v.cpu(), v_ref)
    np.testing.assert_allclose((w.cpu() * v_ref).numpy(),
                               (w_ref * v_ref).numpy(), rtol=0, atol=1e-3)
