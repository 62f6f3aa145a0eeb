"""
ctypes bindings and on-demand build of the port's native C++ runtime
(PyTorch port of :mod:`tpu_assim.runtime.native`, over the port's own copy
of the sources, ``runtime/cpp/letkf_cpu.cpp`` and
``runtime/cpp/obs_pipeline.cpp``).

Each library is compiled with g++ at its first use into
``tpu_assim_torch/csrc/build/``, under a file name that carries a hash of
its source and flags, so an edited source is rebuilt and an unchanged one
is loaded as built; the build writes a temporary file and renames it, so
processes that build at once do not load a half-written library. Without a
toolchain every entry point degrades to a numpy implementation with the
same semantics (as in the JAX package), so the native path is an
accelerator only; :func:`native_available` says whether it built.

Role: the host runtime beside the card's kernels — CPU-only deployments,
the input pipeline (obs bucketing, :mod:`~tpu_assim_torch.runtime.
obs_pipeline`), and an independent C++ oracle for the solver tests.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "native_available",
    "letkf_weights_dense_cpu",
    "etkf_weights_cpu",
    "bucket_obs_cpu",
    "gaspari_cohn_cpu",
]

_CPP = Path(__file__).resolve().parent / "cpp"
_SRC = _CPP / "letkf_cpu.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
# no -march=native: a library built on one host loads on any other of the
# architecture (a checkout may move between machines with its build)
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


def _build(src: Path, name: str, extra: Tuple[str, ...]) -> Optional[Path]:
    """The library of ``src`` built with g++ (``extra`` flags beside
    ``_FLAGS``), or None when the build fails."""
    if not src.exists():
        return None
    flags = _FLAGS + extra
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    path = _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as exc:
        logger.warning("native build of %s failed (%s); numpy fallback",
                       src.name, exc)
        return None
    os.replace(tmp, path)
    return path


def _get_lib(src: Path, name: str,
             extra: Tuple[str, ...]) -> Optional[ctypes.CDLL]:
    """Memoized build and load of one native source; None (the numpy
    fallback) when it does not build or load."""
    with _lock:
        if src in _libs:
            return _libs[src]
        lib, path = None, _build(src, name, extra)
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as exc:
                logger.warning("loading %s failed (%s)", path.name, exc)
        _libs[src] = lib
        return lib


def _load() -> Optional[ctypes.CDLL]:
    lib = _get_lib(_SRC, "tpu_assim_torch_native", ("-fopenmp",))
    if lib is not None and not getattr(lib, "_sigs", False):
        c_dp = ctypes.POINTER(ctypes.c_double)
        c_ip = ctypes.POINTER(ctypes.c_int32)
        c_lp = ctypes.POINTER(ctypes.c_int64)
        lib.ta_letkf_weights_dense.restype = ctypes.c_int
        lib.ta_letkf_weights_dense.argtypes = [
            c_dp, c_dp, c_dp, c_dp,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ]
        lib.ta_etkf_weights.restype = ctypes.c_int
        lib.ta_etkf_weights.argtypes = [
            c_dp, c_dp, c_dp, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ]
        lib.ta_bucket_obs.restype = ctypes.c_int64
        lib.ta_bucket_obs.argtypes = [
            c_ip, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, c_ip, c_lp,
        ]
        lib.ta_gaspari_cohn.restype = ctypes.c_int
        lib.ta_gaspari_cohn.argtypes = [
            c_dp, c_dp, c_dp, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double,
        ]
        lib._sigs = True
    return lib


def native_available() -> bool:
    """True if the C++ runtime built (or was already built) and loaded."""
    return _load() is not None


def _c64(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# ----------------------------------------------------------------- solvers
def letkf_weights_dense_cpu(
    perts: np.ndarray,
    innov: np.ndarray,
    obs_weights: np.ndarray,
    inf_factor: float = 1.0,
) -> np.ndarray:
    """Batched localized-ETKF weights on the host CPU.

    Same semantics as :func:`tpu_assim_torch.ops.etkf.letkf_weights_dense`
    (reference math: pytassim/core/etkf.py:57-77 + wrapper.py:86-99):
    perts [k, o], innov [o], obs_weights [g, o] -> weights [g, k, k], f64.
    """
    perts = np.ascontiguousarray(perts, dtype=np.float64)
    innov = np.ascontiguousarray(innov, dtype=np.float64).reshape(-1)
    obs_weights = np.ascontiguousarray(obs_weights, dtype=np.float64)
    k, o = perts.shape
    g = obs_weights.shape[0]
    lib = _load()
    if lib is not None:
        out = np.empty((g, k, k), dtype=np.float64)
        rc = lib.ta_letkf_weights_dense(
            _c64(perts), _c64(innov), _c64(obs_weights), _c64(out),
            g, k, o, float(inf_factor),
        )
        if rc == 0:
            return out
        logger.warning("native letkf solve returned %d; numpy fallback", rc)
    return _letkf_weights_dense_numpy(perts, innov, obs_weights, inf_factor)


def _letkf_weights_dense_numpy(perts, innov, obs_weights, inf_factor):
    k = perts.shape[0]
    reg = (k - 1) / inf_factor
    gram = np.einsum("kl,gl,ml->gkm", perts, obs_weights, perts)
    zy = np.einsum("kl,gl,l->gk", perts, obs_weights, innov)
    evals, evecs = np.linalg.eigh(gram)
    einv = 1.0 / (np.clip(evals, 0.0, None) + reg)
    cov = np.einsum("gik,gk,gjk->gij", evecs, einv, evecs)
    w_mean = np.einsum("gij,gj->gi", cov, zy)
    w_perts = np.einsum("gik,gk,gjk->gij", evecs,
                        np.sqrt((k - 1) * einv), evecs)
    return w_mean[:, :, None] + w_perts


def etkf_weights_cpu(
    perts: np.ndarray, innov: np.ndarray, inf_factor: float = 1.0
) -> np.ndarray:
    """Global ETKF weights [k, k] on the host CPU (f64)."""
    perts = np.ascontiguousarray(perts, dtype=np.float64)
    innov = np.ascontiguousarray(innov, dtype=np.float64).reshape(-1)
    k, o = perts.shape
    lib = _load()
    if lib is not None:
        out = np.empty((k, k), dtype=np.float64)
        rc = lib.ta_etkf_weights(_c64(perts), _c64(innov), _c64(out),
                                 k, o, float(inf_factor))
        if rc == 0:
            return out
    ones = np.ones((1, o), dtype=np.float64)
    return _letkf_weights_dense_numpy(perts, innov, ones, inf_factor)[0]


# --------------------------------------------------------------- input path
def bucket_obs_cpu(
    obs_idx: np.ndarray, n_grid: int, n_shards: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Group observation indices by owning grid shard (stable counting sort).

    Returns ``(order [n], counts [n_shards], obs_per_shard)`` where ``order``
    permutes observations into shard-grouped order.
    """
    if n_grid % n_shards:
        raise ValueError("n_grid must divide evenly over n_shards")
    shard_size = n_grid // n_shards
    obs_idx = np.ascontiguousarray(obs_idx, dtype=np.int32)
    n = obs_idx.shape[0]
    lib = _load()
    if lib is not None:
        order = np.empty(n, dtype=np.int32)
        counts = np.empty(n_shards, dtype=np.int64)
        maxc = lib.ta_bucket_obs(
            obs_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, shard_size, n_shards,
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if maxc >= 0:
            return order, counts, int(maxc)
    owner = obs_idx // shard_size
    order = np.argsort(owner, kind="stable").astype(np.int32)
    counts = np.bincount(owner, minlength=n_shards).astype(np.int64)
    return order, counts, int(counts.max()) if n else 0


def gaspari_cohn_cpu(
    grid: np.ndarray, obs: np.ndarray, radius: float, eps: float = 1e-5
) -> np.ndarray:
    """Batched 1-D Gaspari-Cohn taper [g, o] on the host CPU."""
    grid = np.ascontiguousarray(grid, dtype=np.float64).reshape(-1)
    obs = np.ascontiguousarray(obs, dtype=np.float64).reshape(-1)
    g, o = grid.shape[0], obs.shape[0]
    lib = _load()
    if lib is not None:
        out = np.empty((g, o), dtype=np.float64)
        rc = lib.ta_gaspari_cohn(_c64(grid), _c64(obs), _c64(out),
                                 g, o, float(radius), float(eps))
        if rc == 0:
            return out
    z = np.abs(grid[:, None] - obs[None, :]) / radius
    w = np.zeros_like(z)
    inner = z < 1.0
    outer = (z >= 1.0) & (z < 2.0)
    zi = z[inner]
    w[inner] = -0.25 * zi**5 + 0.5 * zi**4 + 0.625 * zi**3 - 5/3 * zi**2 + 1.0
    zo = z[outer]
    w[outer] = (zo**5 / 12 - 0.5 * zo**4 + 0.625 * zo**3 + 5/3 * zo**2
                - 5 * zo + 4 - 2 / (3 * zo))
    return np.where(w > eps, w, 0.0)
