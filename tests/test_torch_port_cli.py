"""The port's stage-2 command lines on the CPU at tiny widths, and the
config, meter and metrics-sink modules they use, against the JAX package.

- ``main_ldm`` on the synthetic dataset (2 steps, ``save_every=1``,
  ``ema_on``) writes ``step_1``, ``step_2``, ``best_model`` and
  ``metrics.jsonl``; run again with 3 steps it resumes from ``step_2``.
- ``predict`` from that checkpoint, and on an image-only KITTI tree, writes
  the file names, shapes and dtypes that JAX's ``predict`` writes on the
  same data.
- ``export_checkpoint --ema`` writes the run's masters and EMA, which JAX's
  and the port's ``load_reference_ldm`` read back bit for bit.
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("flax")
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from ldmseg_tpu.models import torch_import as jimport  # noqa: E402
from ldmseg_tpu.models.unet import UNetConfig as JUNetConfig  # noqa: E402
from ldmseg_tpu.tools import predict as jpredict  # noqa: E402
from ldmseg_tpu.utils import config as jconfig  # noqa: E402
from ldmseg_tpu.utils.meters import AverageMeter as JMeter  # noqa: E402
from ldmseg_tpu.utils.meters import ProgressMeter as JProgress  # noqa
from ldmseg_torch.models import convert  # noqa: E402
from ldmseg_torch.models import torch_import as timport  # noqa: E402
from ldmseg_torch.tools import export_checkpoint, main_ae, main_ldm  # noqa
from ldmseg_torch.tools import predict  # noqa: E402
from ldmseg_torch.utils import config  # noqa: E402
from ldmseg_torch.utils.meters import AverageMeter, ProgressMeter  # noqa
from ldmseg_torch.utils.metrics_sink import MetricsSink  # noqa: E402


# the widths of both CLIs' runs (JAX's predict reads the UNet's sizes but
# not attn_down: its UNet differs, its files' layout does not)
TINY = ["transformation_kwargs.size=32", "transformation_kwargs.size_2=64",
        "vae_model_kwargs.int_channels=16",
        "vae_model_kwargs.out_channels=24",
        "vae_model_kwargs.block_out_channels=[8,8,16,16]",
        "vae_model_kwargs.num_upscalers=2",
        "vae_model_kwargs.upscale_channels=16",
        "vae_model_kwargs.norm_num_groups=8",
        "image_vae_kwargs.block_out_channels=[8,8,16,16]",
        "image_vae_kwargs.groups=8",
        "model_kwargs.block_out_channels=[8,16]",
        "model_kwargs.layers_per_block=1",
        "model_kwargs.attention_head_dim=2",
        "model_kwargs.norm_num_groups=4",
        "train_kwargs.batch_size=2", "eval_kwargs.batch_size=2",
        "sampling_kwargs.num_inference_steps=2"]
PORT = TINY + ["model_kwargs.attn_down=[True,False]", "device=cpu",
               "ema_on=True"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny tensors: the suite runs
    several workers at once, and torch's default pool of every core in
    each of them costs more than it gains here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_sd(module, seed):
    """Numpy weights on a port module's state-dict shapes."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        if k.endswith("bias"):
            out[k] = 0.1 * rng.randn(*v.shape)
        elif v.dim() == 1:  # norm scales
            out[k] = 1.0 + 0.1 * rng.randn(*v.shape)
        else:
            out[k] = rng.randn(*v.shape) / np.prod(v.shape[1:]) ** 0.5
    return out


def _jax_params(t):
    """The JAX trainer's three parameter trees from numpy weights on the
    port's shapes, read by the JAX package's own importers (its
    ``init_state`` would trace, compile and run each ``init``)."""
    from ldmseg_torch.models.image_vae import ImageVAE
    from ldmseg_torch.models.seg_vae import SegVAE
    from ldmseg_torch.models.unet import UNet2DCondition, UNetConfig
    jc, vk = t.unet_config, t.vae_seg
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig(
            in_channels=jc.in_channels, out_channels=jc.out_channels,
            block_out_channels=jc.block_out_channels,
            layers_per_block=jc.layers_per_block,
            attention_head_dim=jc.attention_head_dim,
            norm_num_groups=jc.norm_num_groups,
            attn_down=jc.attn_down[:len(jc.block_out_channels)]))
        ivae = ImageVAE(block_out_channels=t.vae_img.block_out_channels,
                        groups=t.vae_img.groups)
        svae = SegVAE(in_channels=vk.in_channels,
                      int_channels=vk.int_channels,
                      out_channels=vk.out_channels,
                      block_out_channels=vk.block_out_channels,
                      norm_num_groups=vk.norm_num_groups,
                      num_upscalers=vk.num_upscalers,
                      upscale_channels=vk.upscale_channels)
    return {"unet_params": jimport.unet_params_from_sd(_numpy_sd(unet, 3),
                                                       jc),
            "vae_img_params": jimport.image_vae_params_from_sd(
                _numpy_sd(ivae, 1), decoder_enabled=False),
            "vae_seg_params": jimport.seg_vae_params_from_sd(
                _numpy_sd(svae, 2), vk.block_out_channels,
                vk.num_upscalers)}


@pytest.fixture(scope="module")
def jax_predict():
    """JAX's ``predict.main`` with one JAX trainer for the module: both
    calls build the same models from the same widths (the datasets differ,
    not the networks), so the second reuses the first's parameters and
    compiled sampler instead of building them again."""
    from ldmseg_tpu.train import trainer_ldm as jtrainer
    real, built = jtrainer.TrainerDiffusion, {}

    def trainer(cfg, unet_config=None, val_dataset=None, results_folder=None,
                **kw):
        key = json.dumps([cfg[k] for k in (
            "model_kwargs", "vae_model_kwargs", "image_vae_kwargs",
            "sampling_kwargs", "eval_kwargs", "ignore_label")],
            sort_keys=True, default=str)
        if key not in built:
            t = real(cfg, unet_config=unet_config, val_dataset=val_dataset,
                     results_folder=results_folder, **kw)
            init = t.init_state

            def init_once(batch, *a, **k):
                if t.state is None:
                    init(batch, *a, **_jax_params(t), **k)
            t.init_state = init_once
            built[key] = t
        t = built[key]
        t.ds_val, t.results_folder = val_dataset, results_folder
        return t

    def run(argv):
        jtrainer.TrainerDiffusion = trainer
        try:
            return jpredict.main(argv)
        finally:
            jtrainer.TrainerDiffusion = real
    return run


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    args = PORT + [f"output_dir={out}", "run_idx=0", "save_every=1"]
    first = main_ldm.main(args + ["train_kwargs.train_num_steps=2"])
    ckpts = out / "run_0" / "checkpoints"
    listed = sorted(os.listdir(ckpts))
    second = main_ldm.main(args + ["train_kwargs.train_num_steps=3",
                                   "eval_first=False"])
    return out / "run_0", first, listed, second


def test_main_ldm_writes_checkpoints_and_resumes(run, capsys):
    root, first, listed, second = run
    assert listed == ["best_model", "metrics.jsonl", "step_1", "step_2"]
    assert first.state.step == 2 and second.state.step == 3
    assert sorted(os.listdir(root / "checkpoints")) == [
        "best_model", "metrics.jsonl", "step_1", "step_2", "step_3"]
    cfg = json.load(open(root / "config.json"))
    assert cfg["ema_on"] and cfg["checkpoint_dir"] == str(root /
                                                         "checkpoints")
    recs = [json.loads(line)
            for line in open(root / "checkpoints" / "metrics.jsonl")]
    # one loss a run: log_every (20) is past both runs' ends
    assert [r["step"] for r in recs if "loss" in r] == [2, 3]
    # the resumed run started from step_2's weights: its step-3 masters
    # are one step from them
    ref = torch.load(root / "checkpoints" / "step_2", weights_only=True)
    moved = [not torch.equal(p, ref["params"][n])
             for n, p in second.unet.named_parameters()]
    assert any(moved)
    assert not all(torch.equal(p, e) for p, e in zip(
        second.unet.parameters(), second.state.ema_params))


def _pngs(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name.endswith(".png"):
            a = np.asarray(Image.open(os.path.join(d, name)))
            out[name] = (a.shape, a.dtype)
    return out


def test_predict_writes_jax_s_files(run, tmp_path, jax_predict):
    root = run[0]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    n = predict.main(PORT + [f"out_dir={ours}", "max_batches=1",
                             f"checkpoint={root}/checkpoints/step_3"])
    m = jax_predict(TINY + [f"out_dir={ref}", "max_batches=1"])
    assert n == m == 2
    got = _pngs(ours)
    assert got == _pngs(ref) and len(got) == 4
    assert set(got.values()) == {((32, 64), np.dtype(np.uint8))}


def _rgb_tree(root, n=3, hw=(48, 96)):
    d = os.path.join(root, "val")
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, hw + (3,), dtype=np.uint8)).save(
            os.path.join(d, f"000000_{i:06d}_leftImg8bit.png"))
    return root


def test_predict_image_only_writes_jax_s_files(tmp_path, jax_predict):
    data = _rgb_tree(str(tmp_path / "data"))
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    kitti = ["datasets=kitti", f"data_prefix={data}", "image_only=1"]
    n = predict.main(PORT + kitti + [f"out_dir={ours}"])
    m = jax_predict(TINY + kitti + [f"out_dir={ref}"])
    assert n == m == 3
    assert _pngs(ours) == _pngs(ref)


def test_export_checkpoint_round_trips(run, tmp_path):
    root, _, _, trainer = run
    out = str(tmp_path / "model.pt")
    assert export_checkpoint.main(["--run_dir", str(root), "--out", out,
                                   "--ema", "--device", "cpu"]) == out
    jcfg = JUNetConfig(in_channels=8, out_channels=4,
                       block_out_channels=(8, 16), layers_per_block=1,
                       attention_head_dim=2, norm_num_groups=4,
                       attn_down=(True, False), use_cross_attention=False)
    seg = dict(block_out_channels=(8, 8, 16, 16), num_upscalers=2)
    ref = jimport.load_reference_ldm(out, jcfg, **seg)
    ours = timport.load_reference_ldm(out, trainer.unet_config, **seg)
    assert ours["step"] == ref["step"] == 3
    masters = trainer.unet.state_dict()
    ema = dict(zip(masters, trainer.state.ema_params))
    jmasters = convert.unet_state_dict_from_jax(ref["unet"],
                                                trainer.unet_config)
    jema = convert.unet_state_dict_from_jax(ref["ema"], trainer.unet_config)
    for k, v in masters.items():
        assert torch.equal(ours["unet"][k], v) and torch.equal(
            jmasters[k], v), k
        assert torch.equal(ours["ema"][k], ema[k]) and torch.equal(
            jema[k], ema[k]), k
    for k, v in trainer.vae_seg.state_dict().items():
        assert torch.equal(ours["vae_semseg"][k], v), k
    # --stage ae reads a main_ae run: a main_ldm run's checkpoints are
    # another model's
    with pytest.raises(ValueError, match="another seg VAE"):
        export_checkpoint.main(["--run_dir", str(root), "--out", out,
                                "--stage", "ae", "--device", "cpu"])


def test_what_is_not_ported_raises(tmp_path):
    # clips= is ported: 2 clips of 3 frames sampled with clip-shared noise
    # (no pose net given), a pair a frame (test_torch_port_video_cli holds
    # the pose-warped chain against JAX)
    out = tmp_path / "clips"
    assert predict.main(PORT + ["clips=3", f"out_dir={out}",
                                "max_batches=1"]) == 6
    assert set(_pngs(str(out)).values()) == {((32, 64), np.dtype(np.uint8))}
    assert len(_pngs(str(out))) == 12
    # main_ae is ported (tests/test_torch_port_main_ae.py); it runs on the
    # card unless asked for the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=torch.device"):
            main_ae.main([f"output_dir={tmp_path}", "run_idx=0"])
    with pytest.raises(NotImplementedError, match="wandb"):
        MetricsSink(str(tmp_path / "m.jsonl"), use_wandb=True)


def test_presets_and_config_helpers_match_jax(tmp_path):
    from ldmseg_tpu.tools import main_ae as jmain_ae
    assert main_ae.DATASET_PRESETS == jmain_ae.DATASET_PRESETS
    args = ["a.b=3", "a.c=[1,2]", "x=True", "name=kitti", "flag", "f=1e-4"]
    assert config.parse_dot_overrides(args) == \
        jconfig.parse_dot_overrides(args)
    ours = config.prepare_config(config.load_config(), str(tmp_path / "o"),
                                 run_idx=4)
    ref = jconfig.prepare_config(jconfig.load_config(), str(tmp_path / "r"),
                                 run_idx=4)
    for key in ("output_dir", "checkpoint_dir", "log_dir"):
        assert os.path.isdir(ours[key])
        assert os.path.relpath(ours[key], str(tmp_path / "o")) == \
            os.path.relpath(ref[key], str(tmp_path / "r"))
    assert json.load(open(os.path.join(ours["output_dir"],
                                       "config.json"))) == json.loads(
        json.dumps(ours))


def test_meters_and_sink_write_jax_s_records(tmp_path, capsys):
    from ldmseg_tpu.utils.metrics_sink import MetricsSink as JSink
    for meter_cls, progress_cls in ((AverageMeter, ProgressMeter),
                                    (JMeter, JProgress)):
        m = meter_cls("loss", ":.4f")
        for v in (1.0, 2.0, 4.5):
            m.update(v, 2)
        progress_cls(100, [m], prefix="Epoch [0]").display(7)
    ours, ref = capsys.readouterr().out.splitlines()
    assert ours == ref and "(2.5000)" in ours
    for cls, name in ((MetricsSink, "ours"), (JSink, "ref")):
        sink = cls(str(tmp_path / name / "metrics.jsonl"))
        sink.log(3, loss=np.float32(0.25), pq=None)
        sink.log(4, pq=12.5, best_pq=12.5)
        sink.close()
    recs = {name: [json.loads(line) for line in
                   open(tmp_path / name / "metrics.jsonl")]
            for name in ("ours", "ref")}
    for a, b in zip(recs["ours"], recs["ref"]):
        a.pop("time"), b.pop("time")
        assert a == b
