"""ctypes bindings for the C++ data core (``runtime/data_core.cpp``).

Counterpart of ``intro_tc_vae_tpu/runtime/native.py``, with its own copy
of the source: the same six C entry points, signatures and numpy/PIL
fallbacks, so both packages give the same bytes.

The library is built by ``g++ -O3 -march=native -fopenmp`` at the first
call of an entry point, never at import, into ``build/native/`` beside
the package (git-ignored), named by a hash of the source and the flags.
The compiler writes to a temporary file of its own in that directory,
which is renamed into place, so processes that build at the same time
(test workers) never share a half-written file. Where no ``g++`` is
found or the build fails, every entry point takes its numpy/PIL
fallback; ``available()`` says which path is active. This is host code
for the loader's threads, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("data_core.cpp")
BUILD_DIR = SRC.parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdatacore-{digest[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the data core unless its library exists; returns (path,
    seconds spent compiling). Raises ``OSError`` or
    ``subprocess.SubprocessError`` when the build fails."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(prefix=f"libdatacore-{os.getpid()}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError):
            return None  # the numpy/PIL fallbacks

        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        i32 = ctypes.c_int

        lib.gather_normalize_u8.argtypes = [u8p, i64p, i64, i64, f32p]
        lib.gather_f32.argtypes = [f32p, i64p, i64, i64, f32p]
        lib.resize_bicubic_f32.argtypes = [f32p, i64, i32, i32, i32, f32p, i32, i32]
        lib.flip_horizontal_f32.argtypes = [f32p, i64, i32, i32, i32, u8p]
        lib.gather_u8.argtypes = [u8p, i64p, i64, i64, u8p]
        lib.flip_horizontal_u8.argtypes = [u8p, i64, i32, i32, i32, u8p]
        for fn in (lib.gather_normalize_u8, lib.gather_f32, lib.resize_bicubic_f32,
                   lib.flip_horizontal_f32, lib.gather_u8, lib.flip_horizontal_u8):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is loaded (built at the first call)."""
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_indices(indices: np.ndarray, n: int) -> None:
    if len(indices) and (indices.min() < 0 or indices.max() >= n):
        raise IndexError(f"indices outside [0, {n})")


def gather_normalize(imgs_u8: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """imgs[indices] / 255 -> float32, native when possible."""
    lib = _load()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if lib is None:
        return imgs_u8[indices].astype(np.float32) / 255.0
    imgs_u8 = np.ascontiguousarray(imgs_u8)
    _check_indices(indices, len(imgs_u8))
    elems = int(np.prod(imgs_u8.shape[1:]))
    out = np.empty((len(indices),) + imgs_u8.shape[1:], np.float32)
    lib.gather_normalize_u8(
        _ptr(imgs_u8, ctypes.c_uint8), _ptr(indices, ctypes.c_int64),
        len(indices), elems, _ptr(out, ctypes.c_float),
    )
    return out


def gather(imgs_f32: np.ndarray, indices: np.ndarray) -> np.ndarray:
    lib = _load()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if lib is None:
        return np.ascontiguousarray(imgs_f32[indices])
    imgs_f32 = np.ascontiguousarray(imgs_f32, dtype=np.float32)
    _check_indices(indices, len(imgs_f32))
    elems = int(np.prod(imgs_f32.shape[1:]))
    out = np.empty((len(indices),) + imgs_f32.shape[1:], np.float32)
    lib.gather_f32(
        _ptr(imgs_f32, ctypes.c_float), _ptr(indices, ctypes.c_int64),
        len(indices), elems, _ptr(out, ctypes.c_float),
    )
    return out


def gather_u8(imgs_u8: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """imgs[indices] -> uint8 (raw gather for the uint8-transfer path)."""
    lib = _load()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if lib is None:
        return np.ascontiguousarray(imgs_u8[indices])
    imgs_u8 = np.ascontiguousarray(imgs_u8)
    _check_indices(indices, len(imgs_u8))
    elems = int(np.prod(imgs_u8.shape[1:]))
    out = np.empty((len(indices),) + imgs_u8.shape[1:], np.uint8)
    lib.gather_u8(
        _ptr(imgs_u8, ctypes.c_uint8), _ptr(indices, ctypes.c_int64),
        len(indices), elems, _ptr(out, ctypes.c_uint8),
    )
    return out


def resize_bicubic(batch: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Batched PIL-compatible bicubic resize [N,H,W,C] -> [N,out_h,out_w,C]."""
    lib = _load()
    batch = np.ascontiguousarray(batch, dtype=np.float32)
    n, h, w, c = batch.shape
    if lib is None:
        from PIL import Image

        out = np.empty((n, out_h, out_w, c), np.float32)
        for i in range(n):
            img = Image.fromarray((batch[i] * 255).astype(np.uint8).squeeze())
            img = img.resize((out_w, out_h), Image.BICUBIC)
            arr = np.asarray(img, np.float32) / 255.0
            out[i] = arr[..., None] if arr.ndim == 2 else arr
        return out
    out = np.empty((n, out_h, out_w, c), np.float32)
    lib.resize_bicubic_f32(
        _ptr(batch, ctypes.c_float), n, h, w, c,
        _ptr(out, ctypes.c_float), out_h, out_w,
    )
    return out


def flip_horizontal(batch: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """Horizontal flip of batch[i] where flags[i], in place when ``batch``
    is C-contiguous (returns the flipped batch).

    Dispatches on dtype: float32 and uint8 batches are both supported
    (flipping is a pure permutation, so uint8-then-normalize is
    bit-identical to normalize-then-flip)."""
    lib = _load()
    flags = np.ascontiguousarray(flags, dtype=np.uint8)
    if len(flags) != len(batch):
        raise ValueError(f"{len(flags)} flags for a batch of {len(batch)}")
    if lib is None:
        batch[flags.astype(bool)] = batch[flags.astype(bool), :, ::-1, :]
        return batch
    n, h, w, c = batch.shape
    if batch.dtype == np.uint8:
        batch = np.ascontiguousarray(batch)
        lib.flip_horizontal_u8(
            _ptr(batch, ctypes.c_uint8), n, h, w, c, _ptr(flags, ctypes.c_uint8)
        )
    else:
        batch = np.ascontiguousarray(batch, dtype=np.float32)
        lib.flip_horizontal_f32(
            _ptr(batch, ctypes.c_float), n, h, w, c, _ptr(flags, ctypes.c_uint8)
        )
    return batch
