"""
The weight checkpoint (PyTorch port of the arrays and weights half of
:mod:`tpu_assim.utils.checkpoint`).

Weights are dense tensors (``[k, m]`` global or ``[grid, k, m]``
localized), stored as HDF5 through h5py under the JAX package's dataset
key, so a file written by either package loads in the other. h5py is
imported where a file is read or written.
"""

import numpy as np
import torch

from tpu_assim_torch.state import as_device_tensor

__all__ = ["load_arrays", "load_weights", "save_arrays", "save_weights"]

_WEIGHTS_KEY = "ensemble_weights"


def save_arrays(path: str, arrays: dict) -> None:
    """Save a flat dict of arrays or tensors to an HDF5 file."""
    import h5py

    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            f.create_dataset(key, data=np.asarray(value))


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
