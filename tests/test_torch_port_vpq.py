"""The port's VPQ statistics and DVPQ evaluation against the JAX package's on
the CPU.

``vpq_eval_device`` (torch) against JAX's ``vpq_eval_device`` and the
numpy oracle on the same id maps: tp/fn/fp equal, iou within 1e-5; a
window of more segments than ``max_seg`` cut exactly as JAX cuts it; the
crowded window's exact counts and the grow loop of ``evaluate_dvpq``;
``evaluate_dvpq``'s windowing and depth masking against JAX's; the numpy
oracle's copy equal to JAX's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.evals import evaluate_dvpq as jevaluate_dvpq  # noqa: E402
from ldmseg_tpu.evals import vpq as jvpq  # noqa: E402
from ldmseg_torch.evals import (count_segments_device,  # noqa: E402
                                evaluate_dvpq, grown_max_seg,
                                vpq_eval_device, vpq_eval_np,
                                vpq_stats_to_scores)
from ldmseg_torch.evals.vpq import MAX_INS  # noqa: E402

CPU = "cpu"


def _random_panoptic(rng, h, w, n_cat=20, n_ins=5, p_void=0.1):
    cat = rng.randint(0, n_cat, size=(h, w))
    cat[rng.rand(h, w) < p_void] = 255
    ins = rng.randint(0, n_ins, size=(h, w))
    ins[cat >= 8] = 0  # stuff has no instances
    return cat * MAX_INS + ins


def _blocky(rng, h, w, block=8, **kw):
    small = _random_panoptic(rng, h // block, w // block, **kw)
    return np.kron(small, np.ones((block, block), dtype=np.int64))


def _noisy_pair(seed, h=64, w=96):
    """GT with void, and a prediction that keeps most of it (partial
    matches) and never holds the void category."""
    rng = np.random.RandomState(seed)
    gt = _blocky(rng, h, w)
    pred = gt.copy()
    noise = _blocky(rng, h, w, p_void=0.0)
    m = (rng.rand(h, w) < 0.2) | (gt // MAX_INS == 255)
    pred[m] = noise[m]
    return pred, gt


def _crowded(seed=7, hs=20, ws=20):
    """About 400 distinct ids per map: 8 thing classes x 50 instances."""
    rng = np.random.RandomState(seed)
    cat = rng.randint(0, 8, size=(hs, ws))
    ins = rng.randint(0, 50, size=(hs, ws))
    gt = np.kron(cat * MAX_INS + ins, np.ones((8, 8), dtype=np.int64))
    pred = gt.copy()
    noise = np.kron(rng.randint(0, 8, size=(hs, ws)) * MAX_INS
                    + rng.randint(0, 50, size=(hs, ws)),
                    np.ones((8, 8), dtype=np.int64))
    m = np.kron(rng.rand(hs, ws) < 0.2, np.ones((8, 8), dtype=bool))
    pred[m] = noise[m]
    return pred, gt


def _assert_stats(ours, ref, exact_counts=True):
    for a, b, name in zip(ours, ref, ["iou", "tp", "fn", "fp"]):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if name == "iou" or not exact_counts:
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_vpq_eval_device_matches_jax_and_the_oracle(seed):
    pred, gt = _noisy_pair(seed)
    ours = vpq_eval_device(torch.from_numpy(pred.copy()),
                           torch.from_numpy(gt.copy()), max_seg=256)
    assert all(x.dtype == torch.float32 and x.shape == (20,) for x in ours)
    ref = jvpq.vpq_eval_device(jnp.asarray(pred), jnp.asarray(gt),
                               max_seg=256)
    _assert_stats(ours, ref)
    _assert_stats(ours, vpq_eval_np(pred, gt))
    assert float(ours[1].sum()) > 0 and float(ours[3].sum()) > 0


def test_vpq_eval_device_cuts_a_crowded_window_as_jax_does():
    pred, gt = _crowded()
    assert len(np.unique(gt)) > 256
    ours = vpq_eval_device(torch.from_numpy(pred.copy()),
                           torch.from_numpy(gt.copy()), max_seg=256)
    ref = jvpq.vpq_eval_device(jnp.asarray(pred), jnp.asarray(gt),
                               max_seg=256)
    _assert_stats(ours, ref)
    # at a cap that holds every segment, both equal the oracle
    full = vpq_eval_device(torch.from_numpy(pred.copy()),
                           torch.from_numpy(gt.copy()), max_seg=512)
    _assert_stats(full, vpq_eval_np(pred, gt))


def test_count_segments_and_the_grow_loop_on_a_crowded_window():
    pred, gt = _crowded()
    n_gt, n_pred = (int(x) for x in count_segments_device(
        torch.from_numpy(pred.copy()), torch.from_numpy(gt.copy())))
    ref = [int(x) for x in jvpq.count_segments_device(jnp.asarray(pred),
                                                       jnp.asarray(gt))]
    assert [n_gt, n_pred] == ref
    assert n_gt == len(np.unique(gt)) and n_pred == len(np.unique(pred))
    assert max(n_gt, n_pred) > 256  # the grow loop runs
    seg = grown_max_seg(max(n_gt, n_pred))
    assert seg == 512 and grown_max_seg(seg) == seg == grown_max_seg(300)
    args = ([pred // MAX_INS], [pred % MAX_INS], [gt // MAX_INS],
            [gt % MAX_INS])
    ours = evaluate_dvpq(*args, eval_frames=1, max_seg=256, device=CPU)
    ref = vpq_stats_to_scores(*vpq_eval_np(pred, gt))
    np.testing.assert_allclose(ours["pq"], ref["pq"], rtol=1e-6)
    np.testing.assert_allclose(ours["per_class_pq"], ref["per_class_pq"],
                               rtol=1e-6)


def test_evaluate_dvpq_windowing_and_depth_match_jax():
    rng = np.random.RandomState(2)
    frames = 4
    pairs = [_noisy_pair(10 + i, 32, 32) for i in range(frames)]
    pc = [p // MAX_INS for p, _ in pairs]
    pi = [p % MAX_INS for p, _ in pairs]
    gc = [g // MAX_INS for _, g in pairs]
    gi = [g % MAX_INS for _, g in pairs]
    depth_gt = [np.full((32, 32), 10.0) for _ in range(frames)]
    depth_pred = [10.0 + 8.0 * rng.rand(32, 32) for _ in range(frames)]
    for kw in ({}, {"depth_pred": depth_pred, "depth_gt": depth_gt,
                    "depth_thres": 0.5}):
        for eval_frames in (1, 2):
            ours = evaluate_dvpq(pc, pi, gc, gi, eval_frames=eval_frames,
                                 device=CPU, **kw)
            ref = jevaluate_dvpq(pc, pi, gc, gi, eval_frames=eval_frames,
                                 **kw)
            host = evaluate_dvpq(pc, pi, gc, gi, eval_frames=eval_frames,
                                 device="host", **kw)
            for key in ("pq", "tpq", "spq"):
                np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6,
                                           atol=1e-9, err_msg=key)
                np.testing.assert_allclose(host[key], ref[key], rtol=1e-6,
                                           atol=1e-9, err_msg=key)
    # perfect predictions with wildly wrong depth: every pixel masked
    bad = [np.full((32, 32), 30.0) for _ in range(frames)]
    s = evaluate_dvpq(gc, gi, gc, gi, eval_frames=2, depth_pred=bad,
                      depth_gt=depth_gt, depth_thres=0.5, device=CPU)
    assert s["pq"] < 1e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate_dvpq(gc, gi, gc, gi)


def test_numpy_oracle_is_jax_s():
    pred, gt = _noisy_pair(5)
    for a, b in zip(vpq_eval_np(pred, gt), jvpq.vpq_eval_np(pred, gt)):
        np.testing.assert_array_equal(a, b)
    stats = vpq_eval_np(pred, gt)
    assert vpq_stats_to_scores(*stats) == jvpq.vpq_stats_to_scores(*stats)
