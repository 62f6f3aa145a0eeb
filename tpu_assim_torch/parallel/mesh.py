"""
Device meshes and state sharding (PyTorch port of
:mod:`tpu_assim.parallel.mesh`).

A :class:`Mesh` names the axes of an array of ``torch.device``s, as a JAX
mesh names its devices. One device may stand in several places: a mesh of
``["cuda:0"] * 8`` is a ring of 8 virtual shards on one card, and
``["cpu"] * 8`` the tests' ring on the CPU. Sharded data is a list with one
entry per shard, in mesh order, each on its shard's device; the sharded
functions take global tensors, split them over the mesh and return the
global result.

The ``grid`` axis shards grid columns (the analysis); the ``ens`` axis of
:func:`make_forecast_analysis_mesh` is there for a forecast sharded over
members.
"""

from typing import Optional

import numpy as np
import torch

__all__ = [
    "make_grid_mesh",
    "make_forecast_analysis_mesh",
    "shard_state",
    "replicate",
    "GRID_AXIS",
    "ENS_AXIS",
]

GRID_AXIS = "grid"
ENS_AXIS = "ens"


class Mesh:
    """Named axes over an array of devices.

    Parameters
    ----------
    devices : array-like (nested lists or an object array) of
        ``torch.device``s or device strings, one per mesh position;
        repeats are allowed.
    axis_names : one name per dimension of ``devices``.

    Attributes: ``devices`` (object array of ``torch.device``),
    ``axis_names`` (tuple), ``shape`` (dict of axis name to extent, as
    ``mesh.shape[axis]`` in JAX) and ``size``.
    """

    def __init__(self, devices, axis_names):
        raw = np.asarray(devices, dtype=object)
        flat = np.empty(raw.size, dtype=object)
        flat[:] = [torch.device(d) for d in raw.reshape(-1)]
        self.devices = flat.reshape(raw.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"{len(self.axis_names)} axis names for a device array of "
                f"shape {self.devices.shape}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = self.devices.size


def _axis_devices(mesh: Mesh, *axes: str):
    """The devices along ``axes`` (every other axis at position 0), flat
    in row-major order over ``axes``: one per shard."""
    for axis in axes:
        if axis not in mesh.shape:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{mesh.axis_names}")
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(mesh.devices.ndim) if i not in order]
    arr = np.transpose(mesh.devices, order + rest)
    arr = arr.reshape(arr.shape[:len(order)] + (-1,))[..., 0]
    return list(arr.reshape(-1))


def _cuda_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh takes every CUDA device by default, and this process "
            "sees none; pass devices (e.g. devices=['cpu'] * 8)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_grid_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the grid axis: the first ``n_devices`` of ``devices``
    (default: every CUDA device)."""
    devices = _cuda_devices() if devices is None else list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"mesh needs {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, (GRID_AXIS,))


def make_forecast_analysis_mesh(ens_shards: int, grid_shards: int,
                                devices=None) -> Mesh:
    """2-D mesh ``(ens, grid)``: the forecast shards ensemble members over
    ``ens``, the analysis shards grid columns over ``grid``."""
    devices = _cuda_devices() if devices is None else list(devices)
    n = ens_shards * grid_shards
    if len(devices) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(
        ens_shards, grid_shards), (ENS_AXIS, GRID_AXIS))


def shard_state(state, mesh: Mesh):
    """A state's grid dim split over the mesh's grid axis: one
    :class:`~tpu_assim_torch.state.EnsembleState` per mesh position (mesh
    order), holding the grid block of its ``grid`` coordinate (its data and
    grid coordinates; the times whole), on its device."""
    n = int(mesh.shape.get(GRID_AXIS, 0))
    if not n or state.n_grid % n:
        raise ValueError(f"a grid of {state.n_grid} columns does not split "
                         f"evenly over the mesh {mesh.shape}")
    size = state.n_grid // n
    axis = mesh.axis_names.index(GRID_AXIS)
    shards = []
    for pos, device in np.ndenumerate(mesh.devices):
        cols = slice(pos[axis] * size, (pos[axis] + 1) * size)
        shards.append(state.replace(
            data=state.data[..., cols].to(device),
            grid_coords=state.grid_coords[cols].to(device),
            times=state.times.to(device)))
    return shards


def replicate(value: torch.Tensor, mesh: Mesh):
    """``value`` on every mesh position's device, in mesh order."""
    return [value.to(device) for device in mesh.devices.flat]
