"""The DDIM loop replayed as a CUDA graph, on the card.

Imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m gpu \
        tests/test_torch_port_sampler_graph_card.py

For every UNet configuration that ``chip_smoke.py`` samples (bf16 on K1,
the int8 variants, the GN flags, fused projs, packed and absorbed
attention, and the K11 UNet through ``ddim_sample``) at full width (batch
2 of 256x512 frames, a 32x64 latent), 4 DDIM steps with self-conditioning
replayed as a graph give x0 bit-equal to the eager loop's at the same
noise, with the same kernel launch counts. An int8 UNet re-prepared with
calibrated scales is captured afresh, never replayed stale; a step that
reads a value back to the host fails its capture with an error. Without a
card each test skips in the ``cuda`` fixture.
"""

import numpy as np
import pytest
import torch

from ldmseg_torch.diffusion import ddim
from ldmseg_torch.diffusion.sampler import ddim_sample
from ldmseg_torch.ops.counters import counted_wrappers
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

STEPS = 4
CFG = merge_dicts(DEFAULT_CONFIG, {"train_kwargs": {
    "self_condition": True, "weight_dtype": "bfloat16"}})
# (name, sampling keys, unet_config_for flags)
CONFIGS = [
    ("bf16", {}, {}),
    ("int8", {"int8_inference": True}, {}),
    ("int8 a", {"int8_inference": True, "fused_norms": False}, {}),
    ("int8 b", {"int8_inference": True, "fused_norms": False,
                "fused_ff": False}, {}),
    ("int8 c", {"int8_inference": True, "fused_ff": False}, {}),
    ("gn", {}, {"gn": True}),
    ("gn int8", {"int8_inference": True}, {"gn": True}),
    ("projs int8", {"int8_inference": True}, {"projs": True}),
    ("packed", {}, {"packed": True}),
    ("packed int8 a", {"int8_inference": True, "fused_norms": False},
     {"packed": True}),
    ("absorbed", {}, {"absorbed": True}),
    ("absorbed int8 a", {"int8_inference": True, "fused_norms": False},
     {"absorbed": True}),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return {(fn.__name__, a): getattr(fn, a) for fn in counted_wrappers()
            for a in ("launches", "fallbacks") if hasattr(fn, a)}


def _delta(fn):
    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    after = _counts()
    return out, {k: after[k] - v for k, v in before.items() if after[k] != v}


def _trainer(sk, flags):
    from ldmseg_torch.tools.profile_sampling import unet_config_for
    from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
    cfg = merge_dicts(CFG, {"sampling_kwargs": sk})
    trainer = TrainerDiffusion(cfg, unet_config=unet_config_for(**flags))
    trainer.init_params(seed=0)
    return trainer


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return ({"image": rng.randn(2, 256, 512, 3).astype(np.float32)},
            rng.randn(2, 32, 64, 4).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("name,sk,flags", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_graph_equals_eager(cuda, name, sk, flags):
    trainer = _trainer(sk, flags)
    batch, noise = _batch()

    def sample(graph):
        return trainer.sample_panoptic(batch, init_noise=noise,
                                       num_inference_steps=STEPS,
                                       graph=graph)
    sample(False)           # builds the kernels and fills the caches
    (logits_e, x0_e), eager = _delta(lambda: sample(False))
    (logits_g, x0_g), graph = _delta(lambda: sample(True))
    assert torch.isfinite(x0_g).all()
    assert torch.equal(x0_g, x0_e), (
        f"{name}: graph x0 differs from eager by "
        f"{(x0_g - x0_e).abs().max().item()}")
    assert torch.equal(logits_g, logits_e)
    assert graph == eager, f"{name}: graph counted {graph}, eager {eager}"
    assert sum(v for (n, a), v in graph.items() if a == "launches") > 0


@pytest.mark.gpu
def test_k11_unet_graph_equals_eager(cuda):
    from ldmseg_torch.tools.profile_sampling import (PADDED_FLAGS,
                                                     int8_unet_from)
    trainer = _trainer({"int8_inference": True}, {})
    unet = int8_unet_from(trainer.unet, PADDED_FLAGS)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rgb = torch.randn((2, 4, 32, 64), generator=gen, device="cuda")
    init = torch.randn((2, 4, 32, 64), generator=gen, device="cuda")

    def model_fn(latents, condition, t):
        x = torch.cat([latents, rgb, condition], 1).to(torch.bfloat16)
        return unet(x, t).float()

    def run(graph):
        with torch.inference_mode():
            return ddim_sample(trainer.sched, model_fn, init, STEPS,
                               self_condition=True, graph=graph)
    run(False)
    eager_x0, eager = _delta(lambda: run(False))
    graph_x0, graph = _delta(lambda: run(True))
    assert torch.equal(graph_x0, eager_x0)
    assert graph == eager and graph[("padded_attention_s8", "launches")] \
        == 16 * STEPS


@pytest.mark.gpu
def test_recalibrated_int8_unet_is_not_replayed_stale(cuda):
    trainer = _trainer({"int8_inference": True}, {})
    batch, noise = _batch(1)

    def sample(graph):
        return trainer.sample_panoptic(batch, init_noise=noise,
                                       num_inference_steps=STEPS,
                                       graph=graph)[1]
    before = sample(True)
    trainer.calibrate_int8(batch, noise=noise)
    after_g, after_e = sample(True), sample(False)
    assert torch.equal(after_g, after_e)
    assert not torch.equal(after_g, before)
    # a changed master reaches the next call's graph too
    with torch.no_grad():
        trainer.unet.conv_out.bias.add_(0.5)
    moved_g, moved_e = sample(True), sample(False)
    assert torch.equal(moved_g, moved_e)
    assert not torch.equal(moved_g, after_g)


@pytest.mark.gpu
def test_bf16_retrained_weights_reach_the_graph(cuda):
    trainer = _trainer({}, {})
    batch, noise = _batch(2)

    def sample(graph):
        return trainer.sample_panoptic(batch, init_noise=noise,
                                       num_inference_steps=STEPS,
                                       graph=graph)[1]
    first = sample(True)
    with torch.no_grad():
        for p in trainer.unet.parameters():
            p.mul_(1.01)
    second_g, second_e = sample(True), sample(False)
    assert torch.equal(second_g, second_e)
    assert not torch.equal(second_g, first)


@pytest.mark.gpu
def test_failed_capture_raises(cuda):
    sched = ddim.make_ddim_schedule(**CFG["noise_scheduler_kwargs"],
                                    device="cuda")
    init = torch.randn((1, 4, 8, 8), device="cuda")

    def host_read(latents, condition, t):
        return latents * float(latents.abs().max().item())
    with pytest.raises(RuntimeError, match="capturing the DDIM step"):
        ddim_sample(sched, host_read, init, 3)
    # the eager loop takes the same model
    assert torch.isfinite(ddim_sample(sched, host_read, init, 3,
                                      graph=False)).all()
