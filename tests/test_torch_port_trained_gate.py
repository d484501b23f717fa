"""The port's trained-model gate against the JAX package's: its config,
its logits -> DVPQ scoring, and the whole gate run on the CPU at a few
steps and frames."""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the keys of the JAX gate's final line (trained_gate.py:220-233)
JAX_KEYS = {"metric", "recon_miou_stage1", "dvpq_step0", "dvpq_bf16",
            "dvpq_int8", "dvpq_clip_plain", "dvpq_clip_warp", "gates",
            "all_pass", "steps", "wall_s"}


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def test_small_cfg_equals_jax():
    from ldmseg_tpu.tools.perf import trained_gate as jax_gate
    from ldmseg_tpu.utils.config import (DEFAULT_CONFIG as JAX_DEFAULT,
                                         merge_dicts as jax_merge)
    from ldmseg_torch.tools import trained_gate
    from ldmseg_torch.utils.config import DEFAULT_CONFIG, merge_dicts
    want = _flat(jax_gate.small_cfg(jax_merge, JAX_DEFAULT))
    got = _flat(trained_gate.small_cfg(merge_dicts, DEFAULT_CONFIG))
    assert {k: want[k] for k in got} == got
    # the keys only JAX's has are those the port's defaults leave out
    # (no port module reads them)
    assert not set(want) - set(got) & set(_flat(DEFAULT_CONFIG))
    assert (trained_gate.H, trained_gate.W, trained_gate.CLIP_T) == (
        jax_gate.H, jax_gate.W, jax_gate.CLIP_T)


def _scene(n=8, hw=(96, 320), seed=1):
    from ldmseg_torch.data.synthetic import SyntheticDVPS
    ds = SyntheticDVPS(length=n, size=hw, num_classes=20,
                       frames_per_scene=3, seed=seed)
    return np.stack([ds[i]["semseg"] for i in range(n)])


def _logits(gt, c=32, seed=0):
    """Low-resolution logits that mostly agree with ``gt``: its 8x
    subsampled one-hot, scaled, plus noise."""
    rng = np.random.RandomState(seed)
    small = gt[:, 4::8, 4::8]
    onehot = (small[..., None] == np.arange(c)).astype(np.float32)
    return 4.0 * onehot + rng.randn(*onehot.shape).astype(np.float32) * 1.5


def _jax_dvpq(logits, gt, eval_frames, th):
    from ldmseg_tpu.evals import evaluate_dvpq
    from ldmseg_tpu.ops import panoptic_post_process
    b, h, w = gt.shape
    lg = jax.image.resize(jnp.asarray(logits),
                          (b, h, w, logits.shape[-1]), "linear")
    cleaned, _ = panoptic_post_process(
        lg, mask_th=th.mask_th, count_th=th.count_th,
        overlap_th=th.overlap_th, ignore_label=0)
    preds = [np.maximum(p, 0) for p in np.asarray(cleaned)]
    zeros = [np.zeros_like(p) for p in preds]
    return evaluate_dvpq(preds, zeros, list(gt), zeros,
                         eval_frames=eval_frames, num_cat=33,
                         num_eval_cat=32, things_split=8)


class _Thresholds:
    """The gate's eval_kwargs (small_cfg), as the trainer holds them."""
    mask_th, count_th, overlap_th = 0.0, 32, 0.0


@pytest.mark.parametrize("eval_frames", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_to_dvpq_scoring_equals_jax(eval_frames, seed):
    from ldmseg_torch.tools import trained_gate
    gt = _scene(seed=seed + 1)
    logits = _logits(gt, seed=seed)
    want = _jax_dvpq(logits, gt, eval_frames, _Thresholds)
    maps = trained_gate.panoptic_maps(torch.from_numpy(logits.copy()),
                                      gt.shape[1:], _Thresholds)
    got = trained_gate.dvpq(list(maps), list(gt.copy()), eval_frames, "cpu")
    assert got["pq"] == pytest.approx(want["pq"], abs=1e-6)
    np.testing.assert_allclose(got["per_class_pq"], want["per_class_pq"],
                               atol=1e-6)
    assert 5.0 < got["pq"] < 100.0  # neither empty nor trivial


def test_gt_sanity_reads_100_in_each_held_category():
    from ldmseg_tpu.evals import evaluate_dvpq
    from ldmseg_torch.tools import trained_gate
    gts = list(_scene(n=8))
    zeros = [np.zeros_like(g) for g in gts]
    want = evaluate_dvpq(gts, zeros, gts, zeros, eval_frames=1, num_cat=33,
                         num_eval_cat=32, things_split=8)
    got = trained_gate.gt_sanity([g.copy() for g in gts], "cpu")
    # the reference averages over all 32 categories, the absent at 0
    assert got["dvpq"] == pytest.approx(want["pq"], abs=1e-6)
    assert got["dvpq"] == pytest.approx(100 * got["present"] / 32, abs=1e-6)
    assert got["present_pq_min"] == pytest.approx(100, abs=1e-6)
    assert got["present_pq_max"] == pytest.approx(100, abs=1e-6)


def test_the_whole_gate_on_the_cpu(monkeypatch, capsys, tmp_path):
    """2 steps a stage at 32x96 frames (24 training and 12 validation
    frames: one batch of 8 frames, one of 4 clips)."""
    import functools
    from ldmseg_torch.tools import trained_gate
    monkeypatch.setattr(trained_gate, "H", 32)
    monkeypatch.setattr(trained_gate, "W", 96)
    monkeypatch.setattr(trained_gate, "run", functools.partial(
        trained_gate.run, train_frames=24, val_frames=12, val_batches=1))
    out = tmp_path / "gate"
    assert trained_gate.main([
        "--device", "cpu", "--ae-steps", "2", "--ldm-steps", "2",
        "--pose-steps", "2", "--out-dir", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    stages = json.loads(lines[-2])["stages"]
    assert set(line) == JAX_KEYS
    assert line["steps"] == {"ae": 2, "ldm": 2, "pose": 2}
    numbers = [v for k, v in line.items() if k.startswith(("dvpq", "recon"))]
    assert len(numbers) == 6 and np.isfinite(numbers).all()
    assert set(line["gates"]) == {"dvpq_improves", "int8_within_noise",
                                  "pose_not_worse"}
    assert line["all_pass"] == all(line["gates"].values())
    sanity = stages["sanity DVPQ(gt, gt)"]
    assert sanity["present_pq_min"] == pytest.approx(100, abs=1e-6)
    assert 0 <= stages["stage 1 reconstruction DVPQ"] <= 100
    for name in ("stage 1 train", "stage 2 train", "pose train"):
        assert stages[name]["step_timer"]["steps"] == 2
    assert {"stage 2 sample, step 0", "stage 2 sample", "int8 sample",
            "clip sample, per frame", "clip sample, pose-warped"} <= set(
        stages)
    # each stage's trainer wrote into its own folder of the out dir
    assert {p.name for p in out.iterdir()} == {"ae", "ldm", "pose"}
    with pytest.raises(ValueError, match="not empty"):
        trained_gate.main(["--device", "cpu", "--out-dir", str(out)])
