"""Utilities (port of :mod:`tpu_assim.utils`): the property and scalar
helpers, the checkpoints (HDF5 weights, states and observations; sharded
weights on torch.distributed.checkpoint), the phase timers and traces,
and in their own modules the labeled dataset layer
(:mod:`~tpu_assim_torch.utils.dataset`) and the coordinate helpers
(:mod:`~tpu_assim_torch.utils.coords`)."""

from tpu_assim_torch.utils.checkpoint import (
    load_arrays,
    load_observation,
    load_state,
    load_weights,
    load_weights_sharded,
    save_arrays,
    save_observation,
    save_state,
    save_weights,
    save_weights_sharded,
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
    "load_observation",
    "load_state",
    "load_weights",
    "load_weights_sharded",
    "phase",
    "report",
    "reset",
    "save_arrays",
    "save_observation",
    "save_state",
    "save_weights",
    "save_weights_sharded",
    "timings",
    "trace",
]
