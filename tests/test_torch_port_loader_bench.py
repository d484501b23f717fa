"""The port's loader bench against the JAX package's: the synthesized
KITTI-DVPS tree (file names and decoded arrays) and the JSON line's keys."""

import functools
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
from PIL import Image  # noqa: E402

HW = (50, 75)


def _tree(root):
    files = sorted(os.listdir(os.path.join(root, "train")))
    return files, {f: np.asarray(Image.open(os.path.join(root, "train", f)))
                   for f in files}


def test_synthesize_tree_writes_what_jax_writes(tmp_path):
    from ldmseg_tpu.tools.perf import loader_bench as jax_bench
    from ldmseg_torch.tools import loader_bench
    jax_bench.synthesize_tree(str(tmp_path / "jax"), 2, 3, hw=HW)
    loader_bench.synthesize_tree(str(tmp_path / "port"), 2, 3, hw=HW)
    want_files, want = _tree(tmp_path / "jax")
    files, got = _tree(tmp_path / "port")
    assert files == want_files and len(files) == 2 * 3 * 4
    for f in files:
        assert got[f].dtype == want[f].dtype and np.array_equal(got[f],
                                                                want[f]), f
    depth = got["000001_000002_depth_707.0912.png"]
    assert depth.dtype == np.uint16 and depth.shape == HW
    # labels in 25-pixel blocks: constant within a block
    sem = got["000000_000000_gtFine_class.png"]
    assert (sem[:25, :25] == sem[0, 0]).all()


def test_main_prints_the_jax_keys(monkeypatch, capsys):
    from ldmseg_tpu.tools.perf import loader_bench as jax_bench
    from ldmseg_torch.tools import loader_bench
    args = ["--frames", "16", "--scenes", "2", "--batch", "4",
            "--threads", "2"]
    # both tools synthesize 375x1242 frames: their trees made small
    for mod in (jax_bench, loader_bench):
        monkeypatch.setattr(mod, "synthesize_tree", functools.partial(
            mod.synthesize_tree, hw=HW))
    jax_bench.main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    line = loader_bench.main(args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == set(want) | {"host_cores", "host_cores_usable"}
    for key in ("metric", "unit", "threads", "batch", "frames",
                "target_res"):
        assert line[key] == want[key], key
    assert line["source_res"] == f"{HW[0]}x{HW[1]}"
    assert line["value"] > 0 and line["per_sample_decode_ms_1thread"] > 0
    assert line["host_cores_usable"] <= line["host_cores"]
