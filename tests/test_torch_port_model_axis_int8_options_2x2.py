"""Serving with both a data and a model axis: four gloo ranks of the port
(``tests/torch_dp_workers.py:int8_options``, a ``(data=2, model=2)``
mesh with ``tensor_parallel``; rank = data index x 2 + model index), each
data index sampling its row of the batch with K3/K8 and K4/K9 on a rank's
heads and GEGLU columns: a calibrated 2-step int8 ``sample_panoptic``
with fused norms and ``use_fused_projs``, on the one-rank port's scales
(calibrated on the whole batch), against the one-rank port on that data
rank's row: within 1% of the quantization's effect (one rank's int8 x0
against its float x0 on the row), the two model ranks of a data index
equal, no fallback; and each model rank's packs the slice of one rank's.
One rank's sample of the whole batch is not the reference: the Down- and
Upsample s8 convs' dynamic per-tensor amax spans the rows one process
holds (the test prints how far that moves a row).
"""

import numpy as np
import pytest
import torch

from ldmseg_torch.parallel.launch import run_ranks
from ldmseg_torch.parallel.mesh import Mesh
from ldmseg_torch.parallel.sp import model_axis

import torch_dp_workers as W
from test_torch_port_model_axis_int8_options import (INT8, UNET_KW, B,
                                                      STEPS, check_packs,
                                                      cfg)

RUN = {"cfg": cfg(INT8, False), "unet_kw": dict(UNET_KW,
                                                use_fused_projs=True)}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(22)
    spec = {"seed": 7, "steps": STEPS, "data": 2, "model": 2,
            "image": rng.randn(B, 32, 64, 3).astype(np.float32),
            "calib_noise": rng.randn(B, 4, 8, 4).astype(np.float32),
            "init": rng.randn(B, 4, 8, 4).astype(np.float32),
            "forward": (rng.randn(B, 12, 4, 8).astype(np.float32),
                        np.array([500, 20]))}
    one = W.int8_option_runs(None, dict(spec, runs={
        "projs": dict(RUN, float=True)}))["projs"]
    # one rank on each data rank's row alone, on the same scales
    rows = [W.int8_option_runs(None, dict(
        spec, image=spec["image"][d:d + 1], init=spec["init"][d:d + 1],
        calib_noise=spec["calib_noise"][d:d + 1],
        runs={"projs": dict(RUN, float=True, scales=one["scales"])}))[
            "projs"] for d in range(2)]
    ranks = run_ranks(W.int8_options, 4, args=(dict(spec, runs={
        "projs": dict(RUN, cfg=cfg(INT8, True), scales=one["scales"])}),),
        device="cpu", timeout_s=240)
    return {"ranks": [r["projs"] for r in ranks], "one": one, "rows": rows}


def _rel(a, b):
    return float((a - b).abs().mean() / b.abs().mean())


def test_each_data_rank_samples_its_rows_as_one_rank(runs):
    ranks = runs["ranks"]
    for rank, r in enumerate(ranks):
        d = rank // 2
        row = runs["rows"][d]
        effect = _rel(row["x0"], row["float_x0"])
        share = _rel(r["x0"], row["x0"]) / effect
        # beside it, one rank's sample of the whole batch differs on this
        # row: the Down- and Upsample s8 convs' dynamic per-tensor amax
        # spans the rows a process holds (read, not held)
        batch = _rel(runs["one"]["x0"][d:d + 1], row["x0"]) / effect
        print(f"rank {rank} (data {d}): the quantization's effect "
              f"{effect:.4g}, the rank from one rank on its row "
              f"{share:.4g} of it; one rank's whole batch on this row "
              f"{batch:.4g} of it")
        assert effect > 1e-3, "the int8 path changed nothing"
        assert r["x0"].shape == row["x0"].shape
        assert share <= 0.01
        assert r["fallbacks"] == [0] * 7
    for d in range(2):
        assert torch.equal(ranks[2 * d]["x0"], ranks[2 * d + 1]["x0"])
    assert not torch.equal(ranks[0]["x0"], ranks[2]["x0"])


def test_each_model_rank_holds_its_slice(runs):
    for rank, r in enumerate(runs["ranks"]):
        assert any(n.endswith(".attn1") for n in r["grouped"])
        check_packs(runs["one"]["packs"], r["packs"], r["grouped"],
                    model_axis(Mesh(data=2, model=2, data_rank=rank // 2,
                                    model_rank=rank % 2)))
