"""Host input-pipeline throughput (counterpart of
``ldmseg_tpu/tools/perf/loader_bench.py``).

    python3 -m ldmseg_torch.tools.loader_bench [--frames 256] [--scenes 4]
        [--batch 16] [--threads 8] [--keep]

Answers "can the host feed the card?": synthesizes a KITTI-DVPS
``video_sequence`` tree at the camera's resolution (375x1242 PNGs: random
RGB, labels in 25-pixel blocks, from ``RandomState(0)`` as the JAX tool's),
then measures the port's ``Loader`` end to end in samples/s: PNG decode,
the per-modality resize to 192x640, the per-scene remap, the native
analog-bits encode (``data/native/``), the collate to fixed shapes, on
``--threads`` worker threads. A warm epoch first (page cache, the codec's
build), then a timed one; beside it the single-thread decode ms per sample.
Prints one JSON line with the JAX tool's keys and the host's core count.
Needs no card: this is the host's rate.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def synthesize_tree(root: str, n_scenes: int, n_frames: int,
                    hw=(375, 1242)) -> tuple:
    """Write the tree into ``root``; returns ``hw``."""
    from PIL import Image
    d = os.path.join(root, "train")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    h, w = hw
    # piecewise-constant label maps (PNG run lengths) over photographic-
    # noise RGB
    for s in range(n_scenes):
        for f in range(n_frames):
            base = f"{s:06d}_{f:06d}"
            rgb = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
            Image.fromarray(rgb).save(
                os.path.join(d, f"{base}_leftImg8bit.png"))
            blocks = rng.randint(0, 19, (h // 25 + 1, w // 25 + 1))
            sem = np.kron(blocks, np.ones((25, 25), np.uint8))[:h, :w]
            Image.fromarray(sem.astype(np.uint8)).save(
                os.path.join(d, f"{base}_gtFine_class.png"))
            inst = np.kron(rng.randint(0, 12, blocks.shape),
                           np.ones((25, 25), np.uint8))[:h, :w]
            Image.fromarray(inst.astype(np.uint8)).save(
                os.path.join(d, f"{base}_gtFine_instance.png"))
            depth = rng.randint(1, 20000, (h, w)).astype(np.uint16)
            Image.fromarray(depth).save(
                os.path.join(d, f"{base}_depth_707.0912.png"))
    return hw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--keep", action="store_true",
                    help="keep the synthesized tree (its path is printed)")
    args = ap.parse_args(argv)

    from ..data import get_dataset
    from ..data.loader import Loader

    tmp = tempfile.mkdtemp(prefix="ldmseg_loader_bench_")
    try:
        per_scene = max(1, args.frames // args.scenes)
        t0 = time.perf_counter()
        hw = synthesize_tree(tmp, args.scenes, per_scene)
        print(f"synthesized {args.scenes * per_scene} frames at "
              f"{hw[0]}x{hw[1]} in {time.perf_counter() - t0:.1f}s into "
              f"{tmp}", flush=True)

        ds = get_dataset("kitti", prefix=tmp, split="train", num_bits=5,
                         ignore_label=0, num_classes=30, size=(192, 640))
        loader = Loader(ds, args.batch, shuffle=True,
                        num_threads=args.threads, seed=0)

        # a warm epoch (page cache, the codec's build), then a timed one
        for b in loader.epoch(0):
            pass
        t0 = time.perf_counter()
        n = 0
        for b in loader.epoch(1):
            n += b["image"].shape[0]
        dt = time.perf_counter() - t0
        sps = n / dt

        # single-thread decode cost for the per-sample breakdown
        k = min(16, len(ds))
        t0 = time.perf_counter()
        for i in range(k):
            ds[i]
        per_sample_ms = (time.perf_counter() - t0) / k * 1e3
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)

    line = {
        "metric": "host_loader_samples_per_sec",
        "value": round(sps, 1),
        "unit": "samples/s",
        "threads": args.threads,
        "batch": args.batch,
        "frames": n,
        "per_sample_decode_ms_1thread": round(per_sample_ms, 1),
        "source_res": f"{hw[0]}x{hw[1]}", "target_res": "192x640",
        "host_cores": os.cpu_count(),
        "host_cores_usable": len(os.sched_getaffinity(0)),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
