"""``tools/main_ldm`` on two gloo ranks, as ``torchrun --nproc_per_node=2``
runs it (the ranks join the group before the CLI, whose
``initialize_from_env`` then finds it up): a run at the tiny widths of
``test_torch_port_cli.py`` with ZeRO-1, global batch 2 (a row a rank), a
checkpoint every step, then a second run that resumes it. One process
writes: the run's files are those of one process (each metrics record
once), the checkpoint holds the one-rank optimizer layout, and both ranks
hold the same masters after each run."""

import json
import os

import pytest
import torch

from ldmseg_torch.parallel.launch import run_ranks

import torch_dp_workers as W
from test_torch_port_cli import PORT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, so one a spawned rank (``run_ranks`` shares the
    caller's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_main_ldm_on_two_ranks_writes_once_and_resumes(tmp_path):
    args = PORT + [f"output_dir={tmp_path}", "run_idx=0", "save_every=1",
                   "optimizer_zero_redundancy=True"]
    runs = [args + ["train_kwargs.train_num_steps=2"],
            args + ["train_kwargs.train_num_steps=3", "eval_first=False"]]
    ranks = run_ranks(W.main_ldm_runs, 2, args=(runs,), device="cpu",
                      timeout_s=240)
    root = tmp_path / "run_0"
    assert sorted(os.listdir(root / "checkpoints")) == [
        "best_model", "metrics.jsonl", "step_1", "step_2", "step_3"]
    recs = [json.loads(line)
            for line in open(root / "checkpoints" / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [2, 3]
    assert json.load(open(root / "config.json"))["optimizer_zero_redundancy"]
    for i, step in enumerate((2, 3)):
        a, b = (r[i] for r in ranks)
        assert a["step"] == b["step"] == step
        for n, p in a["masters"].items():
            assert torch.equal(p, b["masters"][n]), n
    ck = torch.load(root / "checkpoints" / "step_3", weights_only=True)
    sd = ck["opt_state"]
    assert sd["count"] == 3 and ck["step"] == 3
    # the one-rank layout: every parameter's AdamW state, by index
    n = len(ranks[0][1]["masters"])
    assert sorted(sd["torch"]["state"]) == list(range(n))
    assert sum(len(g["params"]) for g in sd["torch"]["param_groups"]) == n
    for name, p in ck["params"].items():
        assert torch.equal(p, ranks[0][1]["masters"][name]), name
