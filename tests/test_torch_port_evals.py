"""The port's evaluators and ``resize_weight_matrix`` against the JAX
package's on the CPU.

- ``resize_weight_matrix``: bit-equal to JAX's over a grid of sizes, up and
  down, and the same as ``jax.image.resize(..., "linear")`` on data.
- ``PanopticEvaluator``: the same ``add_image`` sequence of seeded maps
  into both; ``evaluate()`` equal, integers exactly and floats within
  1e-12 (thing ids, class-agnostic mode, an explicit ``gt_instance``, the
  ignore label, -1 predictions).
- ``SemsegMeter`` (its counts on the tensors' device) and the COCO-panoptic
  PQ within 1e-6.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ldmseg_tpu.evals import coco_pq as jcoco_pq  # noqa: E402
from ldmseg_tpu.evals.miou import SemsegMeter as JSemsegMeter  # noqa: E402
from ldmseg_tpu.evals.pq import PanopticEvaluator as JEvaluator  # noqa
from ldmseg_tpu.ops.resize import (  # noqa: E402
    resize_weight_matrix as jresize_weight_matrix)
from ldmseg_torch import evals as E  # noqa: E402
from ldmseg_torch.ops.resize import resize_weight_matrix  # noqa: E402

SIZES = [1, 2, 3, 7, 16, 24, 45, 64, 128, 375, 1242]


@pytest.mark.parametrize("n_in", SIZES)
def test_resize_weight_matrix_is_jax_bit_for_bit(n_in):
    for n_out in SIZES:
        ours = resize_weight_matrix(n_in, n_out)
        ref = jresize_weight_matrix(n_in, n_out)
        assert ours.dtype == ref.dtype == np.float32
        assert ours.shape == (n_in, n_out)
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape_in,shape_out", [
    ((16, 32), (45, 110)), ((45, 110), (16, 32)), ((24, 80), (24, 80)),
    ((32, 64), (375, 1242))])
def test_resize_weight_matrices_are_jax_image_resize(shape_in, shape_out):
    x = np.random.RandomState(1).randn(2, *shape_in, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(
        jnp.asarray(x), (2, *shape_out, 3), "linear"))
    wh = resize_weight_matrix(shape_in[0], shape_out[0])
    ww = resize_weight_matrix(shape_in[1], shape_out[1])
    got = torch.einsum("bhwc,hH,wW->bHWc", torch.from_numpy(x),
                       torch.from_numpy(wh), torch.from_numpy(ww)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# PanopticEvaluator
# ---------------------------------------------------------------------------
def _scene(rng, h=40, w=64, classes=(1, 2, 3, 11, 12, 13), ignore=0):
    """A GT semantic map of rectangles (things may touch: components),
    its instance map, and a prediction that moves, merges and drops some
    of them and marks a few pixels -1."""
    gt = np.full((h, w), rng.choice(classes[:3]), np.int32)
    inst = np.zeros((h, w), np.int32)
    for k in range(rng.randint(4, 9)):
        y, x = rng.randint(0, h - 6), rng.randint(0, w - 8)
        rh, rw = rng.randint(3, h // 2), rng.randint(4, w // 2)
        gt[y:y + rh, x:x + rw] = rng.choice(classes)
        inst[y:y + rh, x:x + rw] = k + 1
    gt[rng.rand(h, w) < 0.03] = ignore
    pred = np.roll(gt, (rng.randint(-2, 3), rng.randint(-3, 4)), (0, 1))
    pred = pred.copy()
    y, x = rng.randint(0, h - 5), rng.randint(0, w - 5)
    pred[y:y + 5, x:x + 5] = rng.choice(classes)
    pred[rng.rand(h, w) < 0.02] = -1
    return pred, gt, inst


EV_CASES = {
    "default": (dict(), False),
    "things": (dict(thing_ids={11, 12, 13}), False),
    "explicit_instances": (dict(thing_ids={11, 12, 13}), True),
    "agnostic": (dict(thing_ids=set(), class_agnostic=True), False),
    "agnostic_instances": (dict(thing_ids={11, 12}, class_agnostic=True),
                           True),
    "ignore_255": (dict(thing_ids={11, 12, 13}, ignore_label=255), True),
    "iou_thresh": (dict(thing_ids={12}, iou_thresh=0.75, max_ins=1000),
                   False),
}


def _same_results(ours, ref):
    assert set(ours) == set(ref)
    for k in ("tp", "fp", "fn"):
        assert ours[k] == ref[k] and type(ours[k]) is type(ref[k]), k
    for k in ref:
        if k in ("tp", "fp", "fn", "per_class"):
            continue
        assert abs(ours[k] - ref[k]) <= 1e-12 * max(1.0, abs(ref[k])), k
    assert set(ours["per_class"]) == set(ref["per_class"])
    for c, s in ref["per_class"].items():
        o = ours["per_class"][c]
        assert {k: o[k] for k in ("tp", "fp", "fn")} == {
            k: s[k] for k in ("tp", "fp", "fn")}, c
        for k in ("pq", "sq", "rq", "iou"):
            assert abs(o[k] - s[k]) <= 1e-12, (c, k)


@pytest.mark.parametrize("case", sorted(EV_CASES))
def test_panoptic_evaluator_matches_jax(case):
    kw, explicit = EV_CASES[case]
    ours, ref = E.PanopticEvaluator(**kw), JEvaluator(**kw)
    ignore = kw.get("ignore_label", 0)
    rng = np.random.RandomState(len(case))
    for _ in range(4):
        pred, gt, inst = _scene(rng, ignore=ignore)
        ours.add_image(pred, gt, inst if explicit else None)
        ref.add_image(pred, gt, inst if explicit else None)
    assert (ours.TP, ours.FP, ours.FN) == (ref.TP, ref.FP, ref.FN)
    res = ours.evaluate()
    assert res["tp"] > 0
    _same_results(res, ref.evaluate())


def test_panoptic_evaluator_refuses_a_multiprocess_sum(monkeypatch):
    """One process: a no-op. Two (faked, the other rank's table gathered
    as ``all_gather_host`` would hand it over): the counters and the
    per-class table are summed, and a table above the packing cap of 4096
    class ids is refused, as JAX refuses it. The real two-process sum is
    tests/test_torch_port_parallel.py's."""
    ev = E.PanopticEvaluator()
    pred, gt, _ = _scene(np.random.RandomState(0))
    ev.add_image(pred, gt)
    ev.synchronize_between_processes()      # one process: a no-op
    assert ev.evaluate(synchronize=True)["tp"] == ev.TP
    import torch.distributed as dist
    from ldmseg_torch.parallel import multihost
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(multihost.dist, "all_gather_object",
                        lambda out, obj, group=None: out.__setitem__(
                            slice(None), [obj, obj]))
    one = ev.evaluate(synchronize=False)
    two = ev.evaluate()
    assert (two["tp"], two["fp"], two["fn"]) == (
        2 * one["tp"], 2 * one["fp"], 2 * one["fn"])
    assert two["pq"] == pytest.approx(one["pq"])
    meter = E.SemsegMeter(4)
    meter.update(np.array([[[0, 1], [2, 3]]]), np.array([[[0, 1], [2, 2]]]))
    inter, union = meter.inter.copy(), meter.union.copy()
    meter.synchronize()
    np.testing.assert_array_equal(meter.inter, 2 * inter)
    np.testing.assert_array_equal(meter.union, 2 * union)
    crowded = E.PanopticEvaluator()
    for c in range(4097):
        crowded._cls(c)
    with pytest.raises(ValueError, match="packing cap 4096"):
        crowded.synchronize_between_processes()


# ---------------------------------------------------------------------------
# SemsegMeter, COCO-panoptic PQ
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("has_bg,ignore", [(False, 255), (True, 255),
                                           (False, 0), (True, 3)])
def test_semseg_meter_matches_jax(has_bg, ignore):
    rng = np.random.RandomState(int(has_bg) + ignore)
    classes = 6
    ours = E.SemsegMeter(classes, has_bg=has_bg, ignore_index=ignore)
    ref = JSemsegMeter(classes, has_bg=has_bg, ignore_index=ignore)
    for _ in range(3):
        gt = rng.randint(0, classes + 2, (2, 12, 20))
        gt[rng.rand(*gt.shape) < 0.1] = ignore
        pred = np.where(rng.rand(*gt.shape) < 0.7, gt,
                        rng.randint(-1, classes + 2, gt.shape))
        ours.update(torch.from_numpy(pred), torch.from_numpy(gt))
        ref.update(pred, gt)
    np.testing.assert_allclose(ours.inter, ref.inter, rtol=1e-6)
    np.testing.assert_allclose(ours.union, ref.union, rtol=1e-6)
    a, b = ours.return_score(), ref.return_score()
    assert abs(a["mIoU"] - b["mIoU"]) <= 1e-6
    np.testing.assert_allclose(a["per_class"], b["per_class"], atol=1e-6)
    counts = E.miou.batch_stats(torch.from_numpy(pred),
                                torch.from_numpy(gt), classes, ignore,
                                has_bg)
    assert all(c.dtype == torch.int64 for c in counts)


def _coco_pairs(rng, n=4):
    pairs = []
    for _ in range(n):
        gt = np.zeros((24, 40), np.int64)
        segs_g, segs_p = [], []
        pm = np.zeros_like(gt)
        for k in range(1, 7):
            y, x = rng.randint(0, 18), rng.randint(0, 32)
            gt[y:y + rng.randint(3, 9), x:x + rng.randint(3, 12)] = k
            segs_g.append({"id": k, "category_id": int(rng.randint(1, 4)),
                           "iscrowd": int(k == 6)})
        pm[:] = np.roll(gt, rng.randint(-2, 3), axis=1)
        pm[pm == 3] = 0
        for k in range(1, 7):
            if k == 3:
                continue
            cat = segs_g[k - 1]["category_id"]
            segs_p.append({"id": k, "category_id": int(
                cat if rng.rand() < 0.8 else rng.randint(1, 4))})
        pm[rng.rand(*pm.shape) < 0.05] = 9
        segs_p.append({"id": 9, "category_id": 2})
        pairs.append((pm, segs_p, gt, segs_g))
    return pairs


@pytest.mark.parametrize("agnostic,things", [(False, None), (True, None),
                                             (False, {1, 3})])
def test_coco_pq_matches_jax(agnostic, things):
    pairs = _coco_pairs(np.random.RandomState(5 + int(agnostic)))
    ours = E.pq_compute_images(pairs, class_agnostic=agnostic, things=things)
    ref = jcoco_pq.pq_compute_images(pairs, class_agnostic=agnostic,
                                     things=things)
    assert set(ours) == set(ref) and ours["n"] == ref["n"]
    for k in ("pq", "sq", "rq", "thing_pq", "stuff_pq"):
        assert abs(ours[k] - ref[k]) <= 1e-6, k
    assert ours["per_class"].keys() == ref["per_class"].keys()
    for c in ref["per_class"]:
        for k, v in ref["per_class"][c].items():
            assert abs(ours["per_class"][c][k] - v) <= 1e-6, (c, k)
    assert ours["pq"] > 0
