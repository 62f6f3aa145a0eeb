"""
Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, for Hopper (``sm_90a``), into ``csrc/build/``. The
library's file name carries a hash of its source, of every header
``csrc/*.cuh`` and of the compile flags, so an edited source or header is
rebuilt at its next use and an unchanged one is loaded as built. Nothing
here runs at import: the first call of a kernel wrapper builds what it
needs, and :func:`build_all` runs one nvcc per missing source, all at
once.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["KERNELS", "SMEM_PER_BLOCK", "build_all", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
KERNELS = ("letkf_window1d", "rk4_l96", "svd_jacobi", "letkf_nbh_cheb",
           "letkf_nbh_ns", "letkf_window2d", "eigh_jacobi", "halo_ring")
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
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
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


def ptxas_report(name: str) -> str:
    """The resource report (``-Xptxas -v``) of ``csrc/<name>.cu``: from
    this process's build, or from a fresh nvcc run into a scratch file when
    the library was loaded as built."""
    if name not in BUILD_LOG:
        scratch = BUILD_DIR / f"report-{name}-{os.getpid()}.so"
        try:
            BUILD_LOG[name] = _compile(name, scratch)
        finally:
            scratch.unlink(missing_ok=True)
    return BUILD_LOG[name]


def _demangled_name(mangled: str) -> str:
    """The function name of an Itanium-mangled kernel symbol, with an
    integer template argument as ``name<arg>``; other symbols as given."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        m = re.match(r"\d+", mangled[i:])
        j = i + len(m.group(0))
        name, i = mangled[j:j + int(m.group(0))], j + int(m.group(0))
    arg = re.match(r"ILi(\d+)E", mangled[i:])
    return f"{name}<{arg.group(1)}>" if arg else name


def kernel_resources(report: str) -> list:
    """``[(kernel, registers, static shared bytes, spill store bytes, spill
    load bytes), ...]`` parsed from an ``-Xptxas -v`` report, a template
    instance named as ``name<arg>``."""
    out, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _demangled_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)),
                        int(smem.group(1)) if smem else 0) + spills)
            name, spills = None, (0, 0)
    return out


def build_all() -> float:
    """Build every missing kernel library, one nvcc process per source, all
    started together; then load them all. Return the seconds it took."""
    t0 = time.perf_counter()
    missing = [n for n in KERNELS if not _library_path(n).is_file()]
    with ThreadPoolExecutor(max_workers=max(len(missing), 1)) as pool:
        reports = pool.map(lambda n: _compile(n, _library_path(n)), missing)
        BUILD_LOG.update(zip(missing, reports))
    for name in KERNELS:
        load_library(name)
    return time.perf_counter() - t0
