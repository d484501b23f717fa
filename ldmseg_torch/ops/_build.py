"""Build and load the port's CUDA kernels.

Each ``ldmseg_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded with
``ctypes``. Libraries go to ``ldmseg_torch/_build/`` (listed in
``.gitignore``), named by a digest of the source and the flags, so a
changed source rebuilds and an unchanged one is reused. Nothing is built or
loaded when the package is imported: the first launch builds what it needs,
and :func:`build` compiles every source at once, one ``nvcc`` each, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# flags of one source: attention_s8.cu instantiates the attention skeleton
# 42 times (7 head classes x 1 or 2 consumer warpgroups x 3 epilogues), so
# its kernels are optimized on parallel threads (72 s alone otherwise on
# the H100's host, against the others' 20-27 s)
SOURCE_FLAGS = {"attention_s8": ("--split-compile=0",)}

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of the kernel sources under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built on a machine with the "
            "CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    # the shared headers count: a changed header rebuilds every source
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    flags = " ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, ()))
    digest = hashlib.sha1(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process each, all running at once. Returns per source the
    seconds it took (0 when it was already built) and the compiler's log
    (``-Xptxas=-v``: registers and shared memory per kernel). Raises
    ``RuntimeError`` with the log of any source that fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    report: Dict[str, dict] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.monotonic())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.monotonic() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
