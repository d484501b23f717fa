"""No TF32 in the port's fp32 arithmetic: each trainer turns off cuDNN's
and cuBLAS's TF32 when it is built (``ldmseg_torch/utils/precision.py:
strict_fp32``), so that the command-line tools, ``tools/trained_gate.py``
and a spawned rank, which all build one, compute fp32 as the JAX reference
does. The flags are process-wide and can be read on the CPU."""

import pytest
import torch

from ldmseg_torch.train.trainer_ae import TrainerAE
from ldmseg_torch.train.trainer_ldm import TrainerDiffusion
from ldmseg_torch.train.trainer_pose import TrainerPose
from ldmseg_torch.utils.config import DEFAULT_CONFIG
from ldmseg_torch.utils.precision import strict_fp32

FLAGS = (("cuda.matmul", torch.backends.cuda.matmul),
         ("cudnn", torch.backends.cudnn))


@pytest.fixture
def tf32_on():
    before = [f.allow_tf32 for _, f in FLAGS]
    for _, f in FLAGS:
        f.allow_tf32 = True
    yield
    for (_, f), b in zip(FLAGS, before):
        f.allow_tf32 = b


@pytest.mark.parametrize("build", [
    lambda: TrainerDiffusion(DEFAULT_CONFIG, device="cpu"),
    lambda: TrainerAE(DEFAULT_CONFIG, device="cpu"),
    lambda: TrainerPose(DEFAULT_CONFIG, device="cpu"),
    strict_fp32], ids=["TrainerDiffusion", "TrainerAE", "TrainerPose",
                       "strict_fp32"])
def test_building_a_trainer_turns_tf32_off(tf32_on, build):
    assert all(f.allow_tf32 for _, f in FLAGS)
    build()
    for name, f in FLAGS:
        assert f.allow_tf32 is False, name
