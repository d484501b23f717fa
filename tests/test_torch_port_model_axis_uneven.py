"""A model axis that does not divide every width: an int8
``sample_panoptic`` on three gloo ranks of the port
(``tests/torch_dp_workers.py:uneven_axis``, a ``(data=1, model=3)`` mesh
with ``tensor_parallel``) against one process of the port. The UNet has two
levels, 48 and 64 wide, with 4 heads: the axis divides the first level's 4C
GEGLU columns (192) but not the mid block's (256), and no block's heads.

  * ``apply_tp`` gives the model group only to what it cut: the first
    level's feed-forwards (their K12 partials or row-parallel
    ``ff.net.2``), never the mid block's feed-forward, which stays whole,
    nor an attention (q, k and v gathered, K13 on all the heads);
  * the sample on each rank is within 2e-2 of max|x0| of the one-rank
    port's (the bound of the two-rank tests), with K12 and K13 on dynamic
    scales, and with the s8 linears around the gelu (``fused_ff`` off).
"""

import numpy as np
import pytest
import torch

from ldmseg_torch.models.unet import UNetConfig
from ldmseg_torch.parallel.launch import run_ranks
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts

import torch_dp_workers as W

B, STEPS, RANKS = 2, 2, 3
UNET_KW = dict(in_channels=12, out_channels=4, block_out_channels=(48, 64),
               attn_down=(True, False), layers_per_block=1,
               attention_head_dim=4, norm_num_groups=4,
               use_fused_attention=True)
# the dryrun's tiny VAEs (test_torch_port_sampling.CFG)
SMALL = {"vae_model_kwargs": {
             "in_channels": 10, "int_channels": 16, "out_channels": 24,
             "block_out_channels": [8, 8, 16, 16], "num_upscalers": 2,
             "upscale_channels": 16, "norm_num_groups": 8},
         "image_vae_kwargs": {"block_out_channels": [8, 8, 16, 16],
                              "groups": 8},
         "train_kwargs": {"self_condition": True, "weight_dtype": "float32",
                          "batch_size": B},
         "ignore_label": 0}
UNFUSED = {"sampling_kwargs": {"int8_inference": True, "fused_norms": False,
                               "int8_attn_act_scale": None}}
TRAINERS = {"unfused": UNFUSED,
            "unfused_ff": merge_dicts(UNFUSED, {"sampling_kwargs": {
                "fused_ff": False, "int8_act_scale": None}})}


def _cfg(over, parallel):
    cfg = merge_dicts(merge_dicts(DEFAULT_CONFIG, SMALL), over)
    return merge_dicts(cfg, {"tensor_parallel": True}) if parallel else cfg


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(3)
    spec = {"model": RANKS, "unet_kw": UNET_KW, "seed": 3, "steps": STEPS,
            "image": rng.randn(B, 32, 64, 3).astype(np.float32),
            "init": rng.randn(B, 4, 8, 4).astype(np.float32),
            "trainers": {k: _cfg(v, True) for k, v in TRAINERS.items()}}
    ranks = run_ranks(W.uneven_axis, RANKS, args=(spec,), device="cpu",
                      timeout_s=240)
    one = {}
    for key, over in TRAINERS.items():
        tr = TrainerDiffusion(_cfg(over, False),
                              unet_config=UNetConfig(**UNET_KW),
                              device="cpu")
        tr.init_params(seed=spec["seed"])
        _, one[key] = tr.sample_panoptic({"image": spec["image"]},
                                         init_noise=spec["init"],
                                         num_inference_steps=STEPS)
    return {"ranks": ranks, "one": one}


@pytest.mark.parametrize("key", sorted(TRAINERS))
def test_only_what_the_axis_cuts_takes_the_group(runs, key):
    first = "down_blocks.0.attentions.0.transformer_blocks.0"
    mid = "mid_block.attentions.0.transformer_blocks.0"
    for r in runs["ranks"]:
        grouped, cut = r[key]["grouped"], r[key]["cut"]
        assert f"{first}.ff.net.0.proj.weight" in cut
        assert f"{first}.ff.net.2.weight" in cut
        assert not any(n.startswith(f"{mid}.ff.") for n in cut)
        ffs = {n for n in grouped if n.endswith(".ff")}
        assert f"{first}.ff" in ffs and f"{mid}.ff" not in ffs
        assert not any(n.endswith((".attn1", ".attn2")) for n in grouped)
        # ff.net.2 row-parallel (its whole rows' scales from the group)
        # where the FF is cut, whole where it is not
        assert f"{first}.ff.net.2" in grouped
        assert f"{mid}.ff.net.2" not in grouped


@pytest.mark.parametrize("key", sorted(TRAINERS))
def test_int8_sample_on_three_ranks_matches_one_rank(runs, key):
    want = runs["one"][key].numpy()
    assert np.isfinite(want).all()
    for r in runs["ranks"]:
        x0 = r[key]["x0"].numpy()
        assert x0.shape == want.shape
        err = np.abs(x0 - want).max()
        assert err <= 2e-2 * np.abs(want).max(), (err, np.abs(want).max())
    for r in runs["ranks"][1:]:
        assert torch.equal(r[key]["x0"], runs["ranks"][0][key]["x0"])
