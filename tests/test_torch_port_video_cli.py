"""The port's video command lines chained on the CPU at tiny widths.

``main_pose`` (2 steps on 3-frame synthetic clips) writes a pose
checkpoint; ``main_ldm video_clips=3`` adopts it through
``pose_model_kwargs.pretrained_path`` and trains 2 steps on clips with the
temporal-consistency term; ``predict clips=3`` samples the val clips from
that run's checkpoint with the pose net (pose-warped, refined) and writes
a PNG pair per frame, for the frames that JAX's ``ClipDataset`` groups the
same val split into; ``eval_dvpq`` scores them against ground truth written
from the synthetic frames, with the same scores as JAX's ``eval_dvpq`` on
the same files (the numpy oracle through ``--host``, and the device path on
the CPU through ``evaluate_dvpq(device="cpu")`` on the files the command
line reads).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from ldmseg_torch.evals import evaluate_dvpq  # noqa: E402
from ldmseg_torch.tools import eval_dvpq, main_ldm, main_pose  # noqa: E402
from ldmseg_torch.tools import predict  # noqa: E402

from test_torch_port_cli import PORT, TINY  # noqa: E402

T = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("video")
    pose = main_pose.main(TINY + [
        "device=cpu", f"output_dir={root / 'pose'}", "run_idx=0",
        f"clip_len={T}", "train_kwargs.train_num_steps=2"])
    pose_ckpt = root / "pose" / "run_0" / "checkpoints" / "step_2"
    ldm = main_ldm.main(PORT + [
        f"output_dir={root / 'ldm'}", "run_idx=0", "eval_first=False",
        f"train_kwargs.video_clips={T}",
        "train_kwargs.temporal_consistency_weight=0.1",
        "train_kwargs.train_num_steps=2",
        f"pose_model_kwargs.pretrained_path={pose_ckpt}"])
    preds = root / "preds"
    written = predict.main(PORT + [
        f"out_dir={preds}", "max_batches=1", f"clips={T}",
        f"checkpoint={root / 'ldm' / 'run_0' / 'checkpoints' / 'step_2'}",
        f"pose_model_kwargs.pretrained_path={pose_ckpt}"])
    return root, pose, pose_ckpt, ldm, preds, written


def test_main_pose_writes_the_handoff_checkpoint(chain):
    _, pose, pose_ckpt, _, _, _ = chain
    assert pose.state.step == 2 and pose.nb_ref == T - 1
    data = torch.load(pose_ckpt, weights_only=True)
    assert data["nb_ref"] == T - 1
    assert any(k.startswith("upconv") for k in data["params"])


def test_main_ldm_trains_on_clips_with_the_pose_net(chain):
    _, pose, _, ldm, _, _ = chain
    assert ldm.state.step == 2
    assert len(ldm.ds) > 0 and ldm.ds.clip_len == T
    assert ldm.temporal_consistency_weight == 0.1
    # the decoder-free pose net, its weights the checkpoint's rounded to
    # the compute dtype (fp32 here)
    assert not ldm.pose_model.output_exp
    for name, p in ldm.pose_model.named_parameters():
        assert torch.equal(p, pose.model.state_dict()[name]), name


def _write_gt(d, frames):
    os.makedirs(d)
    for f in frames:
        stem = f"{f['meta']['image_id']:012d}"
        Image.fromarray(f["semseg"].astype(np.uint8)).save(
            os.path.join(d, f"{stem}_gtFine_class.png"))
        Image.fromarray(f["instance"].astype(np.uint8)).save(
            os.path.join(d, f"{stem}_gtFine_instance.png"))


def test_predict_clips_then_eval_dvpq_match_jax(chain, tmp_path, capsys):
    from ldmseg_tpu.data.synthetic import SyntheticDVPS as JSynthetic
    from ldmseg_tpu.data.video import ClipDataset as JClipDataset
    from ldmseg_tpu.tools import eval_dvpq as jeval_dvpq
    _, _, _, _, preds, written = chain
    # JAX's predict groups the val split into clips of T at stride T; the
    # first batch (2 clips) covers these frames
    val = JSynthetic(length=16, size=(32, 64), num_classes=20, num_bits=5)
    clips = JClipDataset(val, clip_len=T, stride=T)
    frames = [val[i] for clip in clips.clips[:2] for i in clip]
    stems = sorted(f"{f['meta']['image_id']:012d}" for f in frames)
    names = sorted(os.listdir(preds))
    assert written == 2 * T
    assert names == sorted([f"{s}_cat.png" for s in stems]
                           + [f"{s}_ins.png" for s in stems])
    for name in names:
        a = np.asarray(Image.open(preds / name))
        assert a.shape == (32, 64) and a.dtype == np.uint8
    gt = str(tmp_path / "gt")
    _write_gt(gt, frames)
    args = ["--pan_dir", str(preds), "--gt_dir", gt, "--eval_frames", "2"]
    ours = evaluate_dvpq(*eval_dvpq.read_dvpq_inputs(str(preds), gt)[:4],
                         eval_frames=2, device="cpu")
    host = eval_dvpq.main(args + ["--host"])
    ref = jeval_dvpq.main(args)
    for key in ("pq", "tpq", "spq"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(host[key], ref[key], rtol=1e-6,
                                   atol=1e-9)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == lines[-2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            eval_dvpq.main(args)
