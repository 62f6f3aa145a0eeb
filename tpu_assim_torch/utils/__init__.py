"""Utilities (port of :mod:`tpu_assim.utils`): the property and scalar
helpers and the HDF5 weight checkpoint."""

from tpu_assim_torch.utils.checkpoint import (
    load_arrays,
    load_weights,
    save_arrays,
    save_weights,
)
from tpu_assim_torch.utils.decorators import (
    bound_scalar,
    ensure_array,
    lazy_property,
)

__all__ = [
    "bound_scalar",
    "ensure_array",
    "lazy_property",
    "load_arrays",
    "load_weights",
    "save_arrays",
    "save_weights",
]
