"""
Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for Hopper (``sm_90a``), into ``csrc/build/``. The
library's file name carries a hash of its source and of the compile flags,
so an edited source is rebuilt at its next use and an unchanged one is
loaded as built. Nothing here runs at import: the first call of a kernel
wrapper builds what it needs.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "SMEM_PER_BLOCK", "build_all", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("letkf_window1d", "rk4_l96")
# Shared memory one block may use on Hopper (227 KB), which bounds the
# shapes the kernels take.
SMEM_PER_BLOCK = 232448
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc_path() -> str:
    """The nvcc of ``$CUDA_HOME`` (default ``/usr/local/cuda``), else the
    one on ``PATH``."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of tpu_assim_torch build only where the CUDA "
            "toolkit is installed")
    return found


def _library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compile(name: str, target: Path) -> str:
    """Run nvcc for ``csrc/<name>.cu``; return its resource report
    (``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc_path(), *NVCC_FLAGS, "-o", str(partial),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(partial, target)
    return proc.stdout + proc.stderr


BUILD_LOG = {}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its hashed library is missing, then load
    it. The resource report of a fresh build lands in ``BUILD_LOG[name]``."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel source {name!r}; have {KERNELS}")
    target = _library_path(name)
    if not target.is_file():
        BUILD_LOG[name] = _compile(name, target)
    return ctypes.CDLL(str(target))


def build_all() -> float:
    """Build and load every kernel library; return the seconds it took."""
    t0 = time.perf_counter()
    for name in KERNELS:
        load_library(name)
    return time.perf_counter() - t0
