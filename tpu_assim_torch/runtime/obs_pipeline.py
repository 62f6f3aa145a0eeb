"""
Background observation-ingest pipeline (PyTorch port of
:mod:`tpu_assim.runtime.obs_pipeline`): ctypes over the port's copy of the
C++ loader, ``runtime/cpp/obs_pipeline.cpp``, with a pure-numpy serial
fallback.

C++ worker threads parse and shard-bucket the next cycle's observation
files while the card runs the current analysis. Batches come out in the
exact layout of :func:`tpu_assim_torch.parallel.halo.shard_observations`
(``[n_shards * cap]`` padded arrays + validity mask): numpy arrays on the
host, or, given ``device``, tensors moved there with ``.to(device)`` (where
the JAX package hands them to ``jax.device_put``).

The port's copy of the loader waits, for file ticket ``t``, until the
consumer has taken ticket ``t - depth`` out of ring slot ``t % depth`` (a
turn counter per slot); the JAX package's copy waits only until the slot
is not filled, which lets two files race for one slot (its loader can hang
or mix two files).

File format ("TAOB", one obs batch per file) and the ring-pipeline
semantics are documented in ``runtime/cpp/obs_pipeline.cpp``; write files
with :func:`write_obs_file` (native) — the numpy writer here is the
fallback. The files are the JAX package's, byte for byte.
"""

import ctypes
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from tpu_assim_torch.runtime.native import _get_lib

__all__ = ["ObsLoader", "write_obs_file", "read_obs_file"]

_SRC = Path(__file__).resolve().parent / "cpp" / "obs_pipeline.cpp"

_MAGIC = b"TAOB"


def _lib():
    lib = _get_lib(_SRC, "tpu_assim_torch_obs", ("-pthread",))
    if lib is not None and not getattr(lib, "_obs_sigs", False):
        lib.obs_loader_open.restype = ctypes.c_void_p
        lib.obs_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.obs_loader_next.restype = ctypes.c_int64
        lib.obs_loader_next.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(dtype=d, flags="C_CONTIGUOUS")
            for d in (np.float64, np.float64, np.int32, np.float64,
                      np.float64)
        ]
        lib.obs_loader_close.restype = None
        lib.obs_loader_close.argtypes = [ctypes.c_void_p]
        lib.obs_file_write.restype = ctypes.c_int64
        lib.obs_file_write.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib._obs_sigs = True
    return lib


def write_obs_file(path: str, vals, var, grid_idx, coords) -> None:
    """Write one observation batch in the TAOB format."""
    vals = np.ascontiguousarray(vals, np.float64)
    var = np.ascontiguousarray(var, np.float64)
    gidx = np.ascontiguousarray(grid_idx, np.int64)
    coords = np.ascontiguousarray(coords, np.float64)
    if coords.ndim != 2 or coords.shape[0] != vals.shape[0]:
        raise ValueError("coords must be [n_obs, n_dims]")
    lib = _lib()
    if lib is not None:
        rc = lib.obs_file_write(path.encode(), vals, var, gidx, coords,
                                vals.shape[0], coords.shape[1])
        if rc != 0:
            raise OSError(f"obs_file_write failed with code {rc}")
        return
    with open(path, "wb") as f:  # numpy fallback
        f.write(_MAGIC)
        np.asarray([vals.shape[0], coords.shape[1]], np.int64).tofile(f)
        vals.tofile(f)
        var.tofile(f)
        gidx.tofile(f)
        coords.tofile(f)


def read_obs_file(path: str):
    """Read one TAOB file -> (vals, var, grid_idx, coords)."""
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise ValueError(f"{path}: not a TAOB observation file")
        n_obs, n_dims = np.fromfile(f, np.int64, 2)
        vals = np.fromfile(f, np.float64, n_obs)
        var = np.fromfile(f, np.float64, n_obs)
        gidx = np.fromfile(f, np.int64, n_obs)
        coords = np.fromfile(f, np.float64, n_obs * n_dims)
    return vals, var, gidx, coords.reshape(n_obs, n_dims)


class ObsLoader:
    """Iterate shard-bucketed observation batches with background prefetch.

    Yields ``(file_index, vals, var, lidx, coords, valid)`` per file, each
    array leading-dim ``n_shards * cap`` (``coords`` with a trailing
    ``n_dims``) — the :func:`shard_observations` layout: numpy arrays, or
    with ``device`` tensors on it. ``depth`` files parse concurrently on
    C++ threads; order of delivery is submission order. Falls back to
    serial numpy parsing without a toolchain.
    """

    def __init__(self, paths: Sequence[str], n_grid: int, n_shards: int,
                 cap: int, n_dims: int = 1, depth: int = 2, device=None):
        if n_grid % n_shards:
            raise ValueError("n_grid must divide evenly over n_shards")
        self.device = None if device is None else torch.device(device)
        self.paths = [str(p) for p in paths]
        self.n_grid = n_grid
        self.n_shards = n_shards
        self.cap = cap
        self.n_dims = n_dims
        self.depth = depth
        self._h: Optional[int] = None
        self._lib = _lib()
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._h = self._lib.obs_loader_open(
                arr, len(self.paths), n_grid, n_shards, cap, n_dims, depth
            )
            if not self._h:
                raise ValueError("obs_loader_open rejected the arguments")

    def __iter__(self) -> Iterator[tuple]:
        for index, *arrays in self._batches():
            if self.device is not None:
                arrays = [torch.from_numpy(a).to(self.device)
                          for a in arrays]
            yield (index, *arrays)

    def _batches(self):
        n = self.n_shards * self.cap
        if self._h is not None:
            try:
                for _ in self.paths:
                    vals = np.empty(n, np.float64)
                    var = np.empty(n, np.float64)
                    lidx = np.empty(n, np.int32)
                    coords = np.empty(n * self.n_dims, np.float64)
                    valid = np.empty(n, np.float64)
                    rc = self._lib.obs_loader_next(
                        self._h, vals, var, lidx, coords, valid
                    )
                    if rc == -5:
                        raise ValueError(
                            f"cap={self.cap} too small for a shard's "
                            "observation count"
                        )
                    if rc < 0:
                        raise OSError(f"obs_loader_next error {rc}")
                    yield (int(rc), vals, var, lidx,
                           coords.reshape(n, self.n_dims), valid)
            finally:
                self.close()
            return
        # numpy fallback: serial parse + the same bucketing
        shard_size = self.n_grid // self.n_shards
        for i, path in enumerate(self.paths):
            fvals, fvar, gidx, fcoords = read_obs_file(path)
            vals = np.zeros(n)
            var = np.ones(n)
            valid = np.zeros(n)
            lidx = np.zeros(n, np.int32)
            coords = np.zeros((n, self.n_dims))
            fill = np.zeros(self.n_shards, np.int64)
            for j in range(fvals.shape[0]):
                sh = min(int(gidx[j]) // shard_size, self.n_shards - 1)
                k = fill[sh]
                fill[sh] += 1
                if k >= self.cap:
                    raise ValueError(
                        f"cap={self.cap} too small for a shard's "
                        "observation count"
                    )
                at = sh * self.cap + k
                vals[at] = fvals[j]
                var[at] = fvar[j]
                valid[at] = 1.0
                lidx[at] = int(gidx[j]) - sh * shard_size
                coords[at] = fcoords[j, :self.n_dims]
            yield i, vals, var, lidx, coords, valid

    def close(self) -> None:
        if self._h is not None and self._lib is not None:
            self._lib.obs_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
