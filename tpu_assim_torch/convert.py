"""
Carry state and parameters from the JAX package into the port.

The system has no learned weights: its parameters are the model, integrator
and localization objects, and its state is the ensemble and observation
arrays. :func:`arrays_to_torch` moves numpy arrays to tensors;
:func:`from_tpu_assim` rebuilds a ``tpu_assim`` object as its port by
reading its attributes (duck typing: this module never imports JAX).
"""

import numpy as np
import torch

from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.ops.localization import (
    GaspariCohn,
    GaspariCohnInf,
    abs_distance,
)

__all__ = ["arrays_to_torch", "coord1_distance", "from_tpu_assim"]


def arrays_to_torch(arrays, device, dtype=None):
    """Tensors on ``device`` from a sequence of arrays (``None`` stays
    ``None``). Floating arrays take ``dtype`` when it is given; integer and
    boolean arrays keep theirs."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        a = np.asarray(a)
        t = torch.as_tensor(a, device=device)
        if dtype is not None and a.dtype.kind == "f":
            t = t.to(dtype)
        out.append(t)
    return tuple(out)


def coord1_distance(grid_coord, obs_coords):
    """``abs_distance`` on column 1 of the localization info rows (column 0
    is the time column that the analysis prepends)."""
    return abs_distance(grid_coord[1:2], obs_coords[:, 1:2])


def from_tpu_assim(obj, dist_func=None):
    """The port of a ``tpu_assim`` ``Lorenz96``, ``RK4Integrator``,
    ``GaspariCohn`` or ``GaspariCohnInf``, built from its attributes.

    A JAX distance function cannot be carried across: localizations get
    ``dist_func``, by default :func:`coord1_distance`.
    """
    kind = type(obj).__name__
    if kind == "Lorenz96":
        forcing = np.asarray(obj.forcing)
        return Lorenz96(float(forcing) if forcing.ndim == 0
                        else torch.as_tensor(forcing))
    if kind == "RK4Integrator":
        return RK4Integrator(from_tpu_assim(obj.model), obj.dt)
    dist_func = coord1_distance if dist_func is None else dist_func
    if kind == "GaspariCohn":
        return GaspariCohn(tuple(float(r) for r in np.atleast_1d(obj.radius)),
                           dist_func, epsilon=float(obj.epsilon))
    if kind == "GaspariCohnInf":
        return GaspariCohnInf(float(obj.radius), dist_func,
                              epsilon=float(obj.epsilon))
    raise TypeError(f"no port of {kind} objects")
