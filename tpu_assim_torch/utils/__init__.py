"""Utilities (port of :mod:`tpu_assim.utils`): the property and scalar
helpers, the HDF5 weight checkpoint and the phase timers and traces."""

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
from tpu_assim_torch.utils.profiling import (
    phase,
    report,
    reset,
    timings,
    trace,
)

__all__ = [
    "bound_scalar",
    "ensure_array",
    "lazy_property",
    "load_arrays",
    "load_weights",
    "phase",
    "report",
    "reset",
    "save_arrays",
    "save_weights",
    "timings",
    "trace",
]
