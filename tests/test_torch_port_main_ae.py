"""Stage 1 to stage 2 through the port's command lines on the CPU at tiny
widths: ``main_ae`` trains the seg VAE (2 steps) and writes the run layout
JAX's ``TrainerAE.save`` writes; ``export_checkpoint --stage ae`` writes the
reference's ``{'vae': ...}`` file, which JAX's ``load_reference_seg_vae``
reads to the same weights and the port's ``main_ldm`` adopts through
``vae_model_kwargs.pretrained_path`` before it trains a step.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
pytest.importorskip("orbax.checkpoint")
import torch  # noqa: E402

from ldmseg_tpu.models import torch_import as jimport  # noqa: E402
from ldmseg_tpu.parallel import make_mesh  # noqa: E402
from ldmseg_tpu.train.state import TrainState as JState  # noqa: E402
from ldmseg_tpu.train.trainer_ae import TrainerAE as JTrainerAE  # noqa
from ldmseg_tpu.utils import config as jconfig  # noqa: E402
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.tools import export_checkpoint, main_ae, main_ldm  # noqa

from test_torch_port_cli import PORT, TINY  # noqa: E402

STAGE1 = [a for a in TINY if a.startswith(("transformation_kwargs",
                                           "vae_model_kwargs",
                                           "train_kwargs.batch_size"))] + [
    "loss_kwargs.num_points=48", "train_kwargs.train_num_steps=2",
    "device=cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    several workers at once, and torch's default pool of every core in
    each of them costs more than it gains here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    out = tmp_path_factory.mktemp("ae_runs")
    trainer = main_ae.main(STAGE1 + [f"output_dir={out}", "run_idx=0"])
    return out / "run_0", trainer


def test_main_ae_writes_jax_s_run_layout(stage1, tmp_path):
    root, trainer = stage1
    assert trainer.state.step == 2
    ours = sorted(os.listdir(root / "checkpoints"))
    assert ours == ["metrics.jsonl", "step_2"]
    assert sorted(os.listdir(root)) == ["checkpoints", "config.json", "logs"]
    # JAX's TrainerAE.save on the same config writes the same names, with
    # the payload entries the port's checkpoint holds too
    cfg = jconfig.load_config(None)
    overrides = jconfig.parse_dot_overrides(
        [a for a in STAGE1 if not a.startswith("device")])
    cfg = jconfig.merge_dicts(jconfig.merge_dicts(
        cfg, main_ae.DATASET_PRESETS["synthetic"]), overrides)
    jtr = JTrainerAE(cfg, mesh=make_mesh(devices=jax.devices()[:1]),
                     results_folder=str(tmp_path))
    params = convert_to_jax_shapes(jtr, cfg)
    jtr.state = JState.create(params, jtr.tx)
    jtr.state = jtr.state.replace(step=np.asarray(2))
    jtr.save()
    assert sorted(os.listdir(tmp_path)) == ours
    data = torch.load(root / "checkpoints" / "step_2", weights_only=True)
    assert {"params", "opt_state", "step"} <= set(data)
    assert data["step"] == 2


def convert_to_jax_shapes(jtr, cfg):
    """A zero JAX parameter tree of the run's seg VAE (shapes only)."""
    import jax.numpy as jnp
    bits = cfg["vae_model_kwargs"]["in_channels"]
    shapes = jax.eval_shape(lambda: jtr.vae.init(
        {"params": jax.random.key(0), "sample": jax.random.key(0)},
        jnp.zeros((1, 32, 64, bits)), sample_posterior=False))
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_export_ae_feeds_jax_and_main_ldm(stage1, tmp_path):
    root, trainer = stage1
    out = str(tmp_path / "vae.pt")
    assert export_checkpoint.main(["--run_dir", str(root), "--out", out,
                                   "--stage", "ae", "--device", "cpu"]) == out
    vk = trainer.vae_kwargs
    ours = trainer.vae.state_dict()
    # JAX's reader: the same weights
    tree = jimport.load_reference_seg_vae(out, vk["block_out_channels"],
                                          vk["num_upscalers"])
    back = convert.seg_vae_state_dict_from_jax(tree, vk)
    assert set(back) == set(ours)
    for k, v in ours.items():
        assert torch.equal(back[k], v), k
    # main_ldm adopts them and trains a step
    ldm = main_ldm.main(PORT + [
        f"output_dir={tmp_path / 'ldm'}", "run_idx=0", "eval_first=False",
        "train_kwargs.train_num_steps=1", f"vae_model_kwargs.pretrained_path"
        f"={out}"])
    assert ldm.state.step == 1
    for k, v in ldm.vae_seg.state_dict().items():
        assert torch.equal(v, ours[k].to(v.dtype)), k
