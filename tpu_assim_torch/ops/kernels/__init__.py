"""Kernel family of the kernelized ETKF (port of
:mod:`tpu_assim.ops.kernels`)."""

from tpu_assim_torch.ops.kernels.base import (
    AdditiveKernel,
    BaseKernel,
    CompKernel,
    MultiplicativeKernel,
    PowerKernel,
)
from tpu_assim_torch.ops.kernels.concrete import (
    DiagKernel,
    GaussKernel,
    LinearKernel,
    ModuleKernel,
    OrnsteinUhlenbeckKernel,
    PeriodicKernel,
    PolyKernel,
    RBFKernel,
    RationalKernel,
    ScaleKernel,
    TanhKernel,
)
from tpu_assim_torch.ops.kernels.utils import (
    distance_matrix,
    dot_product,
    euclidean_dist,
)

__all__ = [
    "BaseKernel",
    "CompKernel",
    "AdditiveKernel",
    "MultiplicativeKernel",
    "PowerKernel",
    "LinearKernel",
    "GaussKernel",
    "RBFKernel",
    "PolyKernel",
    "PeriodicKernel",
    "RationalKernel",
    "TanhKernel",
    "OrnsteinUhlenbeckKernel",
    "ScaleKernel",
    "DiagKernel",
    "ModuleKernel",
    "dot_product",
    "distance_matrix",
    "euclidean_dist",
]
