"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``; nothing includes PyTorch's headers,
so a build takes seconds. The library goes to ``build/kernels/`` beside
the package, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import: a ``Library`` is built, loaded and bound at its first
launch.

Every hand kernel is called the same way, through ``launch``: its
``<entry>_launch`` C function takes the kernel's arguments, then the
device's index and the stream, and returns a cudaError. The kernel
modules (``tc_cuda``, ``conv_cuda``, ``batchnorm_cuda``) keep only their
argument types, their checks and their launch plans; ``launch`` counts
each launch in the caller's registered dict (``ops/launch_counts.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from intro_tc_vae_tpu_torch.ops import launch_counts

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"

# the kernels' dtype argument (every csrc/*.cu reads the same codes)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels are built from csrc/ on the machine with the card"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns
    (path, seconds spent compiling)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a temporary name and rename: a process building at the
    # same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {name}.cu:\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    path, _ = build(name)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The device's multiprocessors: one persistent block each, and the
    launch plans' measure of a full card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class Library:
    """The entry points of ``csrc/<name>.cu``: ``argtypes`` maps each entry
    to the C argument types of its ``<entry>_launch`` before the device
    and the stream, which every entry point takes last. Built, loaded and
    bound at the first launch (``cdll``)."""

    def __init__(self, name: str, argtypes: dict):
        self.name, self.argtypes = name, argtypes

    @functools.cached_property
    def cdll(self) -> ctypes.CDLL:
        lib = load_library(self.name)
        for entry, types in self.argtypes.items():
            fn = getattr(lib, f"{entry}_launch")
            fn.argtypes = [*types, ctypes.c_int, ctypes.c_void_p]  # device, stream
            fn.restype = ctypes.c_int  # a cudaError
        return lib


def launch(library: Library, entry: str, *args, device: torch.device,
           counts: Optional[dict] = None, counted: Optional[str] = None) -> None:
    """Enqueue ``library``'s ``entry`` on ``device``'s current stream:
    tensors pass as their data pointers (None as a null pointer), then the
    device's index and the stream; a non-zero return raises. A counted
    launch (``counts`` given) runs inside the profiler range
    ``itcvae::launch:<counted>`` and adds one to ``counts[counted]``
    (``counted``: ``entry`` unless given); an uncounted one (an empty
    kernel, a phase stamp) opens no range."""
    fn = getattr(library.cdll, f"{entry}_launch")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    counted = counted or entry
    with (launch_counts.host_range(f"itcvae::launch:{counted}") if counts is not None
          else contextlib.nullcontext()):
        err = fn(*args, device.index, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: cudaError {err}")
    if counts is not None:
        counts[counted] += 1
