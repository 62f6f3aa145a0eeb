"""
Carry state and parameters from the JAX package into the port.

The system has no learned weights: its parameters are the model,
integrator, localization, kernel and transform objects, and its state is
the ensemble and observation arrays. :func:`arrays_to_torch` moves numpy
arrays to tensors; :func:`from_tpu_assim` rebuilds a ``tpu_assim`` object
as its port by reading its attributes (duck typing: this module never
imports JAX).
"""

import numpy as np
import torch

from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops import kernels
from tpu_assim_torch.ops.localization import (
    GaspariCohn,
    GaspariCohnInf,
    abs_distance,
)
from tpu_assim_torch.parallel.mesh import Mesh
from tpu_assim_torch.state import EnsembleState
from tpu_assim_torch.transform import MultiplicativeInflation, Normalizer

__all__ = ["arrays_to_torch", "coord1_distance", "from_tpu_assim"]

# The parameters of each concrete kernel, in the order of its constructor.
_KERNEL_PARAMS = {
    "LinearKernel": (),
    "GaussKernel": ("lengthscale",),
    "RBFKernel": ("gamma",),
    "PolyKernel": ("degree", "const"),
    "PeriodicKernel": ("period", "lengthscale"),
    "RationalKernel": ("lengthscale", "weighting"),
    "TanhKernel": ("coeff", "const"),
    "OrnsteinUhlenbeckKernel": ("lengthscale",),
    "ScaleKernel": ("scaling",),
    "DiagKernel": ("scaling",),
}
_COMPOSITIONS = ("AdditiveKernel", "MultiplicativeKernel", "PowerKernel")


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
        if not a.flags.writeable:  # e.g. a view of a JAX array
            a = a.copy()
        t = torch.as_tensor(a, device=device)
        if dtype is not None and a.dtype.kind == "f":
            t = t.to(dtype)
        out.append(t)
    return tuple(out)


def coord1_distance(grid_coord, obs_coords):
    """``abs_distance`` on column 1 of the localization info rows (column 0
    is the time column that the analysis prepends)."""
    return abs_distance(grid_coord[1:2], obs_coords[:, 1:2])


def _number_or_tensor(value, device):
    """A 0-d array as a Python float, any other as an f64 tensor on
    ``device``."""
    value = np.asarray(value, dtype=np.float64)
    if value.ndim == 0:
        return float(value)
    return torch.as_tensor(value.copy(), device=device)


def from_tpu_assim(obj, dist_func=None, operator=None, device="cuda"):
    """The port of a ``tpu_assim`` ``Lorenz96``, ``RK4Integrator``,
    ``GaspariCohn``, ``GaspariCohnInf``, ``EnsembleState``,
    ``Observation``, kernel (every concrete kernel but ``ModuleKernel``, and
    the ``+ * **`` compositions), ``MultiplicativeInflation`` or
    ``Normalizer``, or of a ``jax.sharding.Mesh``, built from its attributes
    (arrays as tensors on ``device``, by default the card; pass
    ``device="cpu"`` for the CPU). A mesh becomes a
    :class:`~tpu_assim_torch.parallel.mesh.Mesh` with the same axis names
    and shape, every position on ``device`` (virtual shards).

    A JAX callable cannot be carried across: localizations get
    ``dist_func``, by default :func:`coord1_distance`, observations get
    ``operator`` (default None), and a ``ModuleKernel``, whose feature map
    is one, raises ``TypeError``.
    """
    kind = type(obj).__name__
    if kind in _KERNEL_PARAMS:
        params = (np.asarray(getattr(obj, n)) for n in _KERNEL_PARAMS[kind])
        return getattr(kernels, kind)(*params).to(device)
    if kind in _COMPOSITIONS:
        return getattr(kernels, kind)(
            from_tpu_assim(obj.kernel_1, device=device),
            from_tpu_assim(obj.kernel_2, device=device))
    if kind == "ModuleKernel":
        raise TypeError(
            "a ModuleKernel's feature map is a JAX callable and cannot be "
            "carried across; build tpu_assim_torch.ops.kernels.ModuleKernel "
            "with a torch module or callable")
    if kind == "MultiplicativeInflation":
        return MultiplicativeInflation(
            _number_or_tensor(obj.inf_factor, device))
    if kind == "Normalizer":
        def pair(stat):
            return tuple(_number_or_tensor(v, device) for v in stat)

        return Normalizer(pair(obj.ens_stat),
                          [pair(stat) for stat in obj.obs_stat],
                          pair(obj.fg_stat))
    if kind == "EnsembleState":
        data, times, coords = arrays_to_torch(
            (obj.data, obj.times, obj.grid_coords), device)
        return EnsembleState(data, times=times, grid_coords=coords,
                             var_names=obj.var_names,
                             ens_members=obj.ens_members)
    if kind == "Observation":
        values, cov, coords, times = arrays_to_torch(
            (obj.observations, obj.covariance, obj.obs_coords, obj.times),
            device)
        return Observation(values, cov, obs_coords=coords, times=times,
                           operator=operator, correlated=obj.correlated)
    if kind == "Lorenz96":
        forcing = np.asarray(obj.forcing)
        return Lorenz96(float(forcing) if forcing.ndim == 0
                        else torch.as_tensor(forcing))
    if kind == "RK4Integrator":
        return RK4Integrator(from_tpu_assim(obj.model), obj.dt)
    if kind == "Mesh":
        return Mesh(np.full(np.shape(obj.devices), torch.device(device),
                            dtype=object), obj.axis_names)
    dist_func = coord1_distance if dist_func is None else dist_func
    if kind == "GaspariCohn":
        return GaspariCohn(tuple(float(r) for r in np.atleast_1d(obj.radius)),
                           dist_func, epsilon=float(obj.epsilon))
    if kind == "GaspariCohnInf":
        return GaspariCohnInf(float(obj.radius), dist_func,
                              epsilon=float(obj.epsilon))
    raise TypeError(f"no port of {kind} objects")
