"""The port's dataset readers, transforms, remaps, colour maps, registry and
loader against the JAX package's on the CPU.

The KITTI-DVPS, Cityscapes-DVPS and COCO panoptic trees are written here
(KITTI's by ``ldmseg_torch/tools/kitti_tree.py``) from seeded numpy; both
packages' readers read the same files, and every key of ``__getitem__(i,
epoch)``, ``meta`` included, must be equal: arrays bit for bit with their
dtype, everything else by ``==``.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

pytest.importorskip("jax")
from ldmseg_tpu.data import base as jbase  # noqa: E402
from ldmseg_tpu.data import cityscapes as jcity  # noqa: E402
from ldmseg_tpu.data import coco as jcoco  # noqa: E402
from ldmseg_tpu.data import kitti as jkitti  # noqa: E402
from ldmseg_tpu.data import loader as jloader  # noqa: E402
from ldmseg_tpu.data import remap as jremap  # noqa: E402
from ldmseg_tpu.data import synthetic as jsynthetic  # noqa: E402
from ldmseg_tpu.data import transforms as jtransforms  # noqa: E402
from ldmseg_tpu.ops import color as jcolor  # noqa: E402
from ldmseg_torch import data as D  # noqa: E402
from ldmseg_torch.data import remap as R  # noqa: E402
from ldmseg_torch.data import transforms as T  # noqa: E402
from ldmseg_torch.ops import color as C  # noqa: E402
from ldmseg_torch.tools.kitti_tree import write_kitti_dvps_tree  # noqa


def assert_same(a, b, where="sample"):
    """Equal structure and values; arrays equal bit for bit, dtype too."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, set(a),
                                                          set(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# ---------------------------------------------------------------------------
# the trees
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    for split, seed in (("val", 0), ("train", 1)):
        write_kitti_dvps_tree(root, split, frames=4, hw=(45, 110), scenes=2,
                              seed=seed)
    # two RGB-only frames of a third scene (deployment inference)
    rng = np.random.RandomState(2)
    for f in range(2):
        Image.fromarray(rng.randint(0, 255, (45, 110, 3), np.uint8)).save(
            os.path.join(root, "val", f"000002_{f:06d}_leftImg8bit.png"))
    return root


@pytest.fixture(scope="module")
def cityscapes_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes"))
    rng = np.random.RandomState(3)
    h, w = 40, 96
    for split in ("train", "val"):
        d = os.path.join(root, split)
        os.makedirs(d)
        for s in range(2):
            for f in range(2):
                base = os.path.join(d, f"{s:06d}_{f:06d}_x_y")
                Image.fromarray(rng.randint(0, 255, (h, w, 3),
                                            np.uint8)).save(
                    f"{base}_leftImg8bit.png")
                pan = np.zeros((h, w), np.uint16)
                for k in range(6):
                    y, x = rng.randint(0, h - 8), rng.randint(0, w - 12)
                    pan[y:y + rng.randint(2, 8), x:x + rng.randint(2, 12)] = \
                        rng.randint(1, 60)
                pan[:3, :5] = 255
                Image.fromarray(pan).save(f"{base}_instanceTrainIds.png")
                Image.fromarray(rng.randint(1, 5000, (h, w)).astype(
                    np.uint16)).save(f"{base}_depth.png")
    return root


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    rng = np.random.RandomState(4)
    for split in ("train", "val"):
        for sub in (f"{split}2017", f"panoptic_{split}2017", "annotations"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        anns, caps = [], []
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (48, 80, 3), np.uint8)).save(
                os.path.join(root, f"{split}2017", f"{i:012d}.jpg"))
            pan = np.zeros((48, 80, 3), np.uint8)
            segs = []
            for k, (sid, cat, crowd, rows) in enumerate((
                    (7, 1, 0, slice(0, 20)), (300, 2, 0, slice(20, 40)),
                    (9, 3, 1, slice(40, 44)), (11, 4, 0, slice(44, 48)))):
                pan[rows, :, 0] = sid % 256
                pan[rows, :, 1] = sid // 256
                segs.append({"id": sid, "category_id": cat,
                             "iscrowd": crowd})
            anns.append({"image_id": i, "file_name": f"{i:012d}.png",
                         "segments_info": segs})
            Image.fromarray(pan).save(os.path.join(
                root, f"panoptic_{split}2017", f"{i:012d}.png"))
            caps += [{"image_id": i, "caption": f"scene {i} a"},
                     {"image_id": i, "caption": f"scene {i} b"}]
        with open(os.path.join(root, "annotations",
                               f"panoptic_{split}2017.json"), "w") as f:
            json.dump({"annotations": anns, "categories": [
                {"id": c, "name": str(c), "isthing": c % 2}
                for c in range(1, 5)]}, f)
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"annotations": caps}, f)
    return root


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------
KITTI_CASES = {
    "val": dict(split="val"),
    "fullres": dict(split="val", keep_fullres_gt=True),
    "image_only": dict(split="val", image_only=True),
    "per_scene": dict(split="val", remap_mode="per_scene",
                      keep_fullres_gt=True),
    "train_flip_crop": dict(split="train", flip=True, crop_mode="random",
                            keep_fullres_gt=True),
    "train_centre": dict(split="train", crop_mode="centre", flip=True,
                         remap_mode="per_scene"),
    "color_bits": dict(split="train", with_color_target=True,
                       num_bits_instance=6, inpainting_strength=0.5,
                       normalize_params={"mean": [0.5, 0.5, 0.5],
                                         "std": [0.25, 0.25, 0.25]}),
    "no_bits": dict(split="val", encoding_mode="none", fill_value=0.25),
}


@pytest.mark.parametrize("case", sorted(KITTI_CASES))
def test_kitti_reader_matches_jax(kitti_root, case):
    kw = dict(size=(32, 64), seed=5, **KITTI_CASES[case])
    ours = D.KittiDVPS(prefix=kitti_root, **kw)
    ref = jkitti.KittiDVPS(prefix=kitti_root, **kw)
    assert len(ours) == len(ref) == (6 if case == "image_only" else 4)
    assert_same(ours.samples, ref.samples, "samples")
    assert_same(ours.meta_data, ref.meta_data, "meta_data")
    assert ours.get_class_names() == ref.get_class_names()
    # per_scene tables fill in call order: the same order on both
    for epoch in (0, 1):
        for i in range(len(ours)):
            assert_same(ours.__getitem__(i, epoch), ref.__getitem__(i, epoch),
                        f"{case}[{i}, epoch {epoch}]")
    assert str(ours) == str(ref)


@pytest.mark.parametrize("case", [
    dict(split="val"), dict(split="val", keep_fullres_gt=True),
    dict(split="train", flip=True, crop_mode="random", min_pixels=4),
    dict(split="train", remap_labels=False, keep_fullres_gt=True,
         crop_mode="centre", encoding_mode="none")])
def test_cityscapes_reader_matches_jax(cityscapes_root, case):
    kw = dict(size=(24, 48), seed=6, **case)
    ours = D.CityscapesDVPS(prefix=cityscapes_root, **kw)
    ref = jcity.CityscapesDVPS(prefix=cityscapes_root, **kw)
    assert len(ours) == len(ref) == 4
    for epoch in (0, 2):
        for i in range(len(ours)):
            assert_same(ours.__getitem__(i, epoch), ref.__getitem__(i, epoch),
                        f"cityscapes {case}[{i}]")


@pytest.mark.parametrize("case", [
    dict(split="val"), dict(split="train", caption_dropout=0.5,
                            pixel_threshold=100, flip=True,
                            crop_mode="random"),
    dict(split="train", remap_labels=False, num_classes=32, num_bits=5)])
def test_coco_reader_matches_jax(coco_root, case):
    kw = dict(size=(32, 48), seed=7, **case)
    ours = D.CocoPanoptic(prefix=coco_root, **kw)
    ref = jcoco.CocoPanoptic(prefix=coco_root, **kw)
    assert len(ours) == len(ref) == 3
    assert ours.categories == ref.categories
    for epoch in (0, 1):
        for i in range(len(ours)):
            assert_same(ours.__getitem__(i, epoch), ref.__getitem__(i, epoch),
                        f"coco {case}[{i}]")


def test_registry_and_concat_match_jax(kitti_root):
    assert sorted(D.DATASETS) == sorted(jbase.DATASETS)
    assert D.CITYSCAPES_CATEGORIES == jbase.CITYSCAPES_CATEGORIES
    assert D.THING_IDS == jbase.THING_IDS
    assert_same(D.get_metadata(19, "r"), jbase.get_metadata(19, "r"))
    kw = dict(size=(32, 64))
    ours = D.get_dataset("kitti-dvps", prefix=kitti_root,
                         split=["val", "train"], **kw)
    ref = jbase.get_dataset("kitti-dvps", prefix=kitti_root,
                            split=["val", "train"], **kw)
    assert isinstance(ours, D.ConcatDataset) and len(ours) == len(ref) == 8
    for i in (0, 3, 4, 7):
        assert_same(ours.__getitem__(i, 1), ref.__getitem__(i, 1),
                    f"concat[{i}]")
    with pytest.raises(IndexError):
        ours[-1]
    one = D.get_dataset("kitti", prefix=kitti_root, split="val", **kw)
    assert isinstance(one, D.KittiDVPS) and len(one) == 4
    syn = D.get_dataset("synthetic", length=3, size=(24, 40))
    jsyn = jbase.get_dataset("synthetic", length=3, size=(24, 40))
    assert_same(syn[2], jsyn[2], "synthetic")
    assert isinstance(jsyn, jsynthetic.SyntheticDVPS)


# ---------------------------------------------------------------------------
# transforms, remaps, colours
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size_wh", [(110, 45), (45, 110), (40, 40)])
@pytest.mark.parametrize("mode", [None, "centre", "random"])
def test_transforms_match_jax(size_wh, mode):
    rng = np.random.RandomState(sum(size_wh))
    w, h = size_wh
    box = T.square_crop_box(size_wh, mode, np.random.default_rng(3))
    assert box == jtransforms.square_crop_box(size_wh, mode,
                                              np.random.default_rng(3))
    rgb = Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
    lab = Image.fromarray(rng.randint(0, 30, (h, w)).astype(np.uint8))
    dep = Image.fromarray(rng.randint(0, 60000, (h, w)).astype(np.uint16))
    for f in ("resize_rgb", "resize_label", "resize_depth"):
        img = {"resize_rgb": rgb, "resize_label": lab,
               "resize_depth": dep}[f]
        assert_same(getattr(T, f)(img, (16, 24), box=box),
                    getattr(jtransforms, f)(img, (16, 24), box=box), f)
    x = rng.rand(5, 7, 3).astype(np.float32)
    assert_same(T.normalize_imagenet(x), jtransforms.normalize_imagenet(x))
    assert_same(T.denormalize_imagenet(x),
                jtransforms.denormalize_imagenet(x))
    ids = rng.randint(0, 40, (6, 9))
    for ignore, fill in ((0, 0.5), (None, 0.5), (3, 0.25)):
        assert_same(T.encode_bits_host(ids, 6, ignore, fill),
                    jtransforms.encode_bits_host(ids, 6, ignore, fill),
                    f"bits {ignore}")
    sample = {"image": x, "semseg": ids, "text": "t",
              "meta": {"gt_sem": ids, "gt_cat": ids + 1, "image_id": 3}}
    assert_same(T.hflip_sample(sample), jtransforms.hflip_sample(sample))


def test_remaps_and_colours_match_jax():
    rng = np.random.RandomState(8)
    lab = rng.choice([0, 3, 7, 9, 12, 40], size=(20, 30)).astype(np.int32)
    lab[:2] = 5  # a small region
    assert_same(R.remap_contiguous(lab, 0)[0],
                jremap.remap_contiguous(lab, 0)[0])
    assert R.remap_contiguous(lab, 0)[1] == jremap.remap_contiguous(lab,
                                                                    0)[1]
    for classes, min_px in ((16, 0), (16, 100), (4, 0)):
        ours = R.remap_random(lab, classes, 0, np.random.default_rng(1),
                              min_pixels=min_px)
        ref = jremap.remap_random(lab, classes, 0, np.random.default_rng(1),
                                  min_pixels=min_px)
        assert_same(ours[0], ref[0]) and ours[1] == ref[1]
    t_ours, t_ref = {}, {}
    for frame in (lab, lab[::-1] + 1):
        assert_same(R.remap_per_scene(frame, t_ours, 8, 0),
                    jremap.remap_per_scene(frame, t_ref, 8, 0))
    assert t_ours == t_ref
    for n, norm in ((256, False), (20, True)):
        assert_same(C.color_map(n, norm), jcolor.color_map(n, norm))
    assert_same(C.random_color_map(20), jcolor.random_color_map(20))
    pan = rng.randint(0, 500, (9, 11))
    assert_same(C.colorize_panoptic_np(pan, C.random_color_map(20)),
                jcolor.colorize_panoptic_np(pan, jcolor.random_color_map(20)))


# ---------------------------------------------------------------------------
# the loader's shuffle and drop_last
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_matches_jax(shuffle, drop_last):
    ds = D.SyntheticDVPS(length=7, size=(16, 24))
    jds = jsynthetic.SyntheticDVPS(length=7, size=(16, 24))
    ours = D.Loader(ds, 3, shuffle=shuffle, drop_last=drop_last, seed=4)
    ref = jloader.Loader(jds, 3, shuffle=shuffle, drop_last=drop_last,
                         seed=4, num_threads=1)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want)
        for b, (x, y) in enumerate(zip(got, want)):
            assert_same(x, y, f"epoch {epoch} batch {b}")
    assert [len(b["meta"]) for b in ours.epoch(0)] == (
        [3, 3] if drop_last else [3, 3, 1])
