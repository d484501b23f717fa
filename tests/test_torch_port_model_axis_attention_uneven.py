"""The packed and absorbed attentions on a model axis that does not divide
the heads: three gloo ranks of the port (``tests/torch_dp_workers.py:
uneven_axis``, a ``(data=1, model=3)`` mesh with ``tensor_parallel``)
against one process of the port, the UNet of
``test_torch_port_model_axis_uneven.py`` (4 heads; levels 48 and 64 wide)
with ``use_packed_attention`` or ``use_absorbed_attention``:

  * a packed attention gathers q, k and v (K14 or K15 on all the heads,
    ``to_out`` on a rank's channels of its input) and takes no model
    group; an absorbed one stays whole on every rank (no cut, no group);
  * a 2-step fp32 ``sample_panoptic`` on each rank equals the one-rank
    port's to the fp32 sums' reordering (1e-4 of max|x0|), and an int8
    one with ``fused_norms: False`` is within 2e-2 of max|x0| of it (the
    bound of the three-rank int8 tests).
"""

import numpy as np
import pytest
import torch

from ldmseg_torch.models.unet import UNetConfig
from ldmseg_torch.parallel.launch import run_ranks
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
from ldmseg_torch.utils.config import merge_dicts

import torch_dp_workers as W
from test_torch_port_model_axis_uneven import (B, RANKS, STEPS, UNET_KW,
                                               UNFUSED, _cfg)

FLAGS = {"packed": {"use_packed_attention": True},
         "absorbed": {"use_absorbed_attention": True}}
TRAINERS = {f"{flag} {kind}": (flag, over)
            for flag in FLAGS
            for kind, over in (("float", {}), ("int8", merge_dicts(
                UNFUSED, {"sampling_kwargs": {"int8_attn_act_scale": 0.1}})))}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(4)
    spec = {"model": RANKS, "seed": 3, "steps": STEPS,
            "image": rng.randn(B, 32, 64, 3).astype(np.float32),
            "init": rng.randn(B, 4, 8, 4).astype(np.float32)}
    kws = {k: dict(UNET_KW, **FLAGS[flag])
           for k, (flag, _) in TRAINERS.items()}
    spec.update(unet_kws=kws, trainers={k: _cfg(over, True)
                                        for k, (_, over) in TRAINERS.items()})
    ranks = run_ranks(W.uneven_axis, RANKS, args=(spec,), device="cpu",
                      timeout_s=240)
    out = {"ranks": {k: [r[k] for r in ranks] for k in TRAINERS}, "one": {}}
    for k, (_, over) in TRAINERS.items():
        tr = TrainerDiffusion(_cfg(over, False),
                              unet_config=UNetConfig(**kws[k]), device="cpu")
        tr.init_params(seed=spec["seed"])
        _, out["one"][k] = tr.sample_panoptic(
            {"image": spec["image"]}, init_noise=spec["init"],
            num_inference_steps=STEPS)
    return out


@pytest.mark.parametrize("key", sorted(TRAINERS))
def test_an_undivided_attention_gathers_or_stays_whole(runs, key):
    flag = TRAINERS[key][0]
    attn = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"
    for r in runs["ranks"][key]:
        assert not any(n.endswith((".attn1", ".attn2"))
                       for n in r["grouped"])
        cut = {n for n in r["cut"] if n.startswith(attn + ".")}
        if flag == "packed":
            # q, k, v column-parallel (gathered), to_out row-parallel
            assert f"{attn}.to_q.weight" in cut
            assert f"{attn}.to_out.0.weight" in cut
        else:
            assert not cut


@pytest.mark.parametrize("key", sorted(TRAINERS))
def test_sample_on_three_ranks_matches_one_rank(runs, key):
    want = runs["one"][key].numpy()
    assert np.isfinite(want).all()
    tol = 1e-4 if key.endswith("float") else 2e-2
    ranks = runs["ranks"][key]
    for r in ranks:
        x0 = r["x0"].numpy()
        assert x0.shape == want.shape
        err = np.abs(x0 - want).max()
        assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())
    for r in ranks[1:]:
        assert torch.equal(r["x0"], ranks[0]["x0"])
