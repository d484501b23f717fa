"""ctypes bindings for the native host codec (``bitcodec.cpp``; the port's
copy of ``ldmseg_tpu/data/native/__init__.py``, :23-111).

The library is compiled with ``g++ -O3`` at first use into
``ldmseg_torch/_build/`` (git-ignored), named by a digest of the source and
the flags, never into the source tree; a build writes a temporary file and
renames it, so concurrent processes never load half a library. A failed
build raises: unlike the JAX package's loader there is no quiet fallback to
numpy. ``ops/bits.py``'s numpy codec is the plain version the tests hold
this one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bitcodec.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libbitcodec-{digest[:12]}.so"


def build() -> Path:
    """Compile the codec unless it is built; returns the library's path.
    Raises ``RuntimeError`` when there is no ``g++`` or it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("bitcodec: g++ not found on PATH; the native "
                           "codec is built with g++ -O3 at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"bitcodec: g++ failed (exit {proc.returncode}):"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The native library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, i32, f32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_float
        pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.encode_bits_i32.argtypes = [pi, i64, ctypes.c_int, i32, f32, pf]
        lib.encode_bits_i32.restype = ctypes.c_int
        lib.decode_bits_i32.argtypes = [pf, i64, ctypes.c_int,
                                        ctypes.c_int, pi]
        lib.decode_bits_i32.restype = ctypes.c_int
        lib.remap_lut_i32.argtypes = [pi, i64, pi, i64, i32, pi]
        lib.remap_lut_i32.restype = ctypes.c_int
        _lib = lib
        return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"bitcodec: {what} refused its arguments "
                         f"(code {rc}; bits must be 1..31)")


def encode_bits_native(x: np.ndarray, num_bits: int,
                       ignore_label: Optional[int] = 0,
                       fill_value: float = 0.5) -> np.ndarray:
    """``[...]`` ids as int32 -> bits ``[..., num_bits]`` float32 (no
    mask): ``ops/bits.py:encode_bits_np``'s bits. An ignore label below 0,
    or None, fills nothing."""
    lib = get_lib()
    x32 = np.ascontiguousarray(x, dtype=np.int32)
    out = np.empty(x32.shape + (num_bits,), dtype=np.float32)
    _check(lib.encode_bits_i32(
        x32.reshape(-1), x32.size, num_bits,
        -1 if ignore_label is None else int(ignore_label),
        float(fill_value), out.reshape(-1)), "encode_bits_i32")
    return out


def decode_bits_native(bits: np.ndarray,
                       invalid_to_zero: bool = True) -> np.ndarray:
    """Bit planes on the last axis (set where > 0) -> int32 ids; the
    all-ones code maps to 0 with ``invalid_to_zero``."""
    lib = get_lib()
    b32 = np.ascontiguousarray(bits, dtype=np.float32)
    out = np.empty(b32.shape[:-1], dtype=np.int32)
    _check(lib.decode_bits_i32(b32.reshape(-1), out.size, b32.shape[-1],
                               int(invalid_to_zero), out.reshape(-1)),
           "decode_bits_i32")
    return out


def remap_lut_native(ids: np.ndarray, lut: np.ndarray,
                     fallback: int = 0) -> np.ndarray:
    """``lut[ids]``, ids outside the table -> ``fallback``; int32."""
    lib = get_lib()
    ids32 = np.ascontiguousarray(ids, dtype=np.int32)
    lut32 = np.ascontiguousarray(lut, dtype=np.int32)
    out = np.empty(ids32.shape, dtype=np.int32)
    _check(lib.remap_lut_i32(ids32.reshape(-1), ids32.size, lut32,
                             len(lut32), int(fallback), out.reshape(-1)),
           "remap_lut_i32")
    return out
