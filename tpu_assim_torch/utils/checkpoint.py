"""
Checkpoints (PyTorch port of :mod:`tpu_assim.utils.checkpoint`).

- Weights are dense tensors (``[k, m]`` global or ``[grid, k, m]``
  localized), stored as HDF5 through h5py under the JAX package's dataset
  key; states and observations are HDF5 files of the JAX package's layout.
  A file written by either package loads in the other. h5py is imported
  where a file is read or written.
- The sharded weight checkpoint (:func:`save_weights_sharded`) sits on
  ``torch.distributed.checkpoint`` (DCP): each process writes the blocks of
  its own mesh positions. The JAX package writes orbax checkpoints there;
  the files are DCP's, not orbax's, and the two do not read each other's.
"""

import contextlib
import json
import re
import warnings

import numpy as np
import torch

from tpu_assim_torch.parallel.mesh import GRID_AXIS, Mesh
from tpu_assim_torch.parallel.multihost import (
    GlobalTensor,
    process_count,
    process_index,
)
from tpu_assim_torch.state import as_device_tensor

__all__ = [
    "load_arrays",
    "load_observation",
    "load_state",
    "load_weights",
    "load_weights_sharded",
    "save_arrays",
    "save_observation",
    "save_state",
    "save_weights",
    "save_weights_sharded",
]

_WEIGHTS_KEY = "ensemble_weights"


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_arrays(path: str, arrays: dict) -> None:
    """Save a flat dict of arrays or tensors to an HDF5 file."""
    import h5py

    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            f.create_dataset(key, data=_host(value))


def load_arrays(path: str) -> dict:
    """Load a flat dict of numpy arrays from an HDF5 file."""
    import h5py

    with h5py.File(path, "r") as f:
        return {key: np.asarray(f[key]) for key in f.keys()}


def save_weights(path: str, weights) -> None:
    """Persist ensemble weights."""
    save_arrays(path, {_WEIGHTS_KEY: weights})


def load_weights(path: str, device=None, dtype=None) -> torch.Tensor:
    """Load ensemble weights as a tensor in ``dtype`` (default the stored
    one) on ``device``, by default the card, as
    :func:`tpu_assim_torch.state.as_device_tensor` places data; without a
    card pass ``device="cpu"``."""
    weights = as_device_tensor(load_arrays(path)[_WEIGHTS_KEY], device)
    return weights if dtype is None else weights.to(dtype)


# ------------------------------------------------------- state / observation
def save_state(path: str, state) -> None:
    """Persist an :class:`~tpu_assim_torch.state.EnsembleState`: data,
    times and grid coordinates, the labels as JSON attributes."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=_host(state.data))
        f.create_dataset("times", data=_host(state.times))
        f.create_dataset("grid_coords", data=_host(state.grid_coords))
        f.attrs["var_names"] = json.dumps([str(v) for v in state.var_names])
        f.attrs["ens_members"] = json.dumps(list(state.ens_members))


def load_state(path: str, device=None):
    """Load an :class:`~tpu_assim_torch.state.EnsembleState`, on ``device``
    (default the card; ``device="cpu"`` without one)."""
    import h5py

    from tpu_assim_torch.state import EnsembleState

    with h5py.File(path, "r") as f:
        return EnsembleState(
            np.asarray(f["data"]),
            times=np.asarray(f["times"]),
            grid_coords=np.asarray(f["grid_coords"]),
            var_names=tuple(json.loads(f.attrs["var_names"])),
            ens_members=tuple(json.loads(f.attrs["ens_members"])),
            device=device)


def save_observation(path: str, obs) -> None:
    """Persist an :class:`~tpu_assim_torch.observation.Observation`: its
    arrays and the correlated flag (the operator is not stored; attach it
    again after loading)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("observations", data=_host(obs.observations))
        f.create_dataset("covariance", data=_host(obs.covariance))
        f.create_dataset("obs_coords", data=_host(obs.obs_coords))
        f.create_dataset("times", data=_host(obs.times))
        f.attrs["correlated"] = bool(obs.correlated)


def load_observation(path: str, device=None):
    """Load an :class:`~tpu_assim_torch.observation.Observation`, on
    ``device`` (default the card; ``device="cpu"`` without one)."""
    import h5py

    from tpu_assim_torch.observation import Observation

    with h5py.File(path, "r") as f:
        return Observation(
            np.asarray(f["observations"]),
            np.asarray(f["covariance"]),
            obs_coords=np.asarray(f["obs_coords"]),
            times=np.asarray(f["times"]),
            correlated=bool(f.attrs["correlated"]),
            device=device)


# --------------------------------------------------------- sharded weights
def save_weights_sharded(path: str, weights) -> None:
    """Save weights as a ``torch.distributed.checkpoint`` directory, each
    process writing the blocks of its own positions (every process calls
    it).

    ``weights``: a GlobalTensor split along its first (grid) dim, as
    :func:`~tpu_assim_torch.parallel.sharded_letkf_weights` returns one
    (``host_local_to_global(mesh, local_weights, axis=0)`` makes one). The
    blocks are stored under ``ensemble_weights.<shard>``.
    """
    import torch.distributed.checkpoint as dcp

    if not (isinstance(weights, GlobalTensor) and weights.dims == (0,)
            and len(weights.axes) == 1):
        raise ValueError(
            "save_weights_sharded takes a GlobalTensor split along dim 0 "
            "over one axis, as host_local_to_global(mesh, weights, axis=0) "
            "makes one")
    state = {f"{_WEIGHTS_KEY}.{key[0]}": block.detach()
             for key, block in weights.blocks.items()}
    with _one_process():
        dcp.save(state, checkpoint_id=str(path),
                 no_dist=process_count() == 1)


@contextlib.contextmanager
def _one_process():
    """DCP without a process group warns that it assumes one process: so
    it does, here on purpose."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        yield


def _stored_blocks(path: str):
    """``(key, size, dtype)`` of every stored block, in shard order."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(str(path)).read_metadata()
    pattern = re.compile(re.escape(_WEIGHTS_KEY) + r"\.(\d+)$")
    found = []
    for key, item in meta.state_dict_metadata.items():
        match = pattern.match(key)
        if match:
            found.append((int(match.group(1)), key, item.size,
                          item.properties.dtype))
    if not found:
        raise ValueError(f"{path}: no {_WEIGHTS_KEY} blocks in this "
                         "checkpoint")
    found.sort()
    return [(key, size, dtype) for _, key, size, dtype in found]


def _read(path: str, wanted) -> dict:
    import torch.distributed.checkpoint as dcp

    state = {key: torch.empty(size, dtype=dtype) for key, size, dtype
             in wanted}
    with _one_process():
        dcp.load(state, checkpoint_id=str(path),
                 no_dist=process_count() == 1)
    return state


def load_weights_sharded(path: str, mesh: Mesh = None, device=None,
                         axis_name: str = GRID_AXIS):
    """Load a checkpoint of :func:`save_weights_sharded` (every process
    calls it).

    Without ``mesh``: the whole weights on ``device`` (default the card;
    ``device="cpu"`` without one). With ``mesh``: this process's positions'
    blocks over its ``axis_name`` axis, as a GlobalTensor (each block read
    alone when the checkpoint has as many shards as the axis).
    """
    stored = _stored_blocks(path)
    if mesh is None:
        state = _read(path, stored)
        return as_device_tensor(torch.cat([state[key] for key, _, _
                                           in stored]), device)
    axes = ((axis_name,),)
    n = int(mesh.shape[axis_name])
    shape = (sum(size[0] for _, size, _ in stored),) + tuple(stored[0][1][1:])
    probe = GlobalTensor(mesh, shape, (0,), axes, {})
    mine = [key for key in probe.keys() if probe.owner(key) == process_index()]
    if n == len(stored):
        state = _read(path, [stored[key[0]] for key in mine])
        blocks = {key: state[stored[key[0]][0]] for key in mine}
    else:
        state = _read(path, stored)
        whole = torch.cat([state[key] for key, _, _ in stored])
        blocks = {key: whole[probe.slices(key)] for key in mine}
    return GlobalTensor(mesh, shape, (0,), axes, {
        key: block.to(probe.device(key)) for key, block in blocks.items()})
