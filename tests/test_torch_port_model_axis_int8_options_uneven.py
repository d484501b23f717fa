"""The int8 options on a model axis that does not divide the heads: three
gloo ranks of the port (``tests/torch_dp_workers.py:int8_options``, a
``(data=1, model=3)`` mesh with ``tensor_parallel``) against one process
of the port, on the UNet of ``test_torch_port_model_axis_uneven.py`` (4
heads; levels 48 and 64 wide: the axis divides the first level's channels
and 4C GEGLU columns, not the mid block's, and no block's heads):

  * fused norms: K3 whole on every rank (no model group; its pack made
    from the masters' cut attention gathered whole, equal to one rank's
    bit for bit), K4 on a rank's columns where the axis divides them;
  * ``use_fused_projs``: K8 whole the same way, its ``proj_in`` gathered;
    K9 on a rank's third of the first level's columns, whole in the mid
    block;
  * K11 without fused norms: whole on every rank, its projections whole
    in the int8 UNet while the masters hold a cut (``prepare_int8_unet``
    gathers them);
  * each calibrated 2-step int8 sample (K11: ``ddim_sample`` on the UNet),
    on one rank's scales, within 2e-2 of max|x0| of one rank's, with the
    fallbacks one rank takes (the first level's heads of 12 channels).
"""

import numpy as np
import pytest
import torch

from ldmseg_torch.parallel.launch import run_ranks
from ldmseg_torch.parallel.mesh import Mesh
from ldmseg_torch.parallel.sp import model_axis
from ldmseg_torch.tools.profile_sampling import PADDED_FLAGS

import torch_dp_workers as W
from test_torch_port_model_axis_int8_options import INT8, check_packs, cfg
from test_torch_port_model_axis_uneven import B, RANKS, STEPS, UNET_KW

OPTIONS = {"fused_norms": (INT8, {}),
           "use_fused_projs": (INT8, {"use_fused_projs": True}),
           "k11": ({}, {})}
FIRST = "down_blocks.0.attentions.0.transformer_blocks.0"
MID = "mid_block.attentions.0.transformer_blocks.0"


def _runs(parallel, scales=None):
    out = {}
    for key, (over, kw) in OPTIONS.items():
        run = {"cfg": cfg(over, parallel), "unet_kw": dict(UNET_KW, **kw)}
        if key == "k11":
            run["k11"] = dict(PADDED_FLAGS)
        if scales is not None or key == "k11":
            run["scales"] = (scales or {}).get(key)
        out[key] = run
    return out


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(6)
    spec = {"seed": 3, "steps": STEPS, "model": RANKS,
            "image": rng.randn(B, 32, 64, 3).astype(np.float32),
            "calib_noise": rng.randn(B, 4, 8, 4).astype(np.float32),
            "init": rng.randn(B, 4, 8, 4).astype(np.float32),
            "rgb": rng.randn(B, 4, 8, 4).astype(np.float32),
            "forward": (rng.randn(B, 12, 4, 8).astype(np.float32),
                        np.array([500, 20]))}
    one = W.int8_option_runs(None, dict(spec, runs={
        k: r for k, r in _runs(False).items() if k != "k11"}))
    scales = {k: one[k]["scales"] for k in one}
    scales["k11"] = scales["fused_norms"]
    one.update(W.int8_option_runs(None, dict(spec, runs={
        "k11": dict(_runs(False)["k11"], scales=scales["k11"])})))
    ranks = run_ranks(W.int8_options, RANKS, args=(dict(
        spec, runs=_runs(True, scales)),), device="cpu", timeout_s=240)
    return {"ranks": ranks, "one": one}


@pytest.mark.parametrize("key", sorted(OPTIONS))
def test_undivided_heads_run_whole_and_divided_columns_cut(runs, key):
    for rank, r in enumerate(runs["ranks"]):
        res = r[key]
        assert not any(n.endswith(".attn1") for n in res["grouped"])
        assert f"{FIRST}.ff" in res["grouped"]
        assert f"{MID}.ff" not in res["grouped"]
        if key == "k11":
            # whole in the int8 UNet, cut in the masters
            assert f"{FIRST}.attn1.to_q.weight" not in res["cut"]
        check_packs(runs["one"][key]["packs"], res["packs"], res["grouped"],
                    model_axis(Mesh(model=RANKS, model_rank=rank)))


@pytest.mark.parametrize("key", sorted(OPTIONS))
def test_int8_sample_on_three_ranks_matches_one_rank(runs, key):
    want = runs["one"][key]["x0"]
    assert bool(torch.isfinite(want).all())
    ranks = runs["ranks"]
    for r in ranks:
        x0 = r[key]["x0"]
        assert x0.shape == want.shape
        err = float((x0 - want).abs().max())
        assert err <= 2e-2 * float(want.abs().max()), err
        # the first level's heads of 12 channels take the fallback of K3,
        # K8 or K11 (d % 8), on one rank and on each rank alike
        assert r[key]["fallbacks"] == runs["one"][key]["fallbacks"]
    for r in ranks[1:]:
        assert torch.equal(r[key]["x0"], ranks[0][key]["x0"])
