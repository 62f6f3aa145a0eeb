"""
Concrete kernel family (PyTorch port of
:mod:`tpu_assim.ops.kernels.concrete`): the same formulas, in the same
operation order, with the parameters as buffers.
"""

import math

import torch

from tpu_assim_torch.ops.kernels.base import BaseKernel
from tpu_assim_torch.ops.kernels.utils import (
    distance_matrix,
    dot_product,
    euclidean_dist,
)

__all__ = [
    "DiagKernel",
    "GaussKernel",
    "LinearKernel",
    "ModuleKernel",
    "OrnsteinUhlenbeckKernel",
    "PeriodicKernel",
    "PolyKernel",
    "RBFKernel",
    "RationalKernel",
    "ScaleKernel",
    "TanhKernel",
]


class LinearKernel(BaseKernel):
    """``K(x, y) = x y^T``."""

    def forward(self, x, y):
        return dot_product(x, y)


class GaussKernel(BaseKernel):
    """``K(x, y) = exp(-||x - y||^2 / (2 l^2))``."""

    def __init__(self, lengthscale=1.0):
        super().__init__()
        self._buffer("lengthscale", lengthscale)

    def _get_lengthscale(self):
        return self.lengthscale

    def forward(self, x, y):
        ls = self._get_lengthscale()
        return torch.exp(-euclidean_dist(x / ls, y / ls) / 2.0)


class RBFKernel(GaussKernel):
    """The Gauss kernel parametrised by ``gamma``: ``l = (0.5 / gamma)^0.5``."""

    def __init__(self, gamma=0.5):
        BaseKernel.__init__(self)
        self._buffer("gamma", gamma)

    def _get_lengthscale(self):
        return (0.5 / self.gamma) ** 0.5


class PolyKernel(BaseKernel):
    """``K(x, y) = (x y^T + c)^p``."""

    def __init__(self, degree=2.0, const=1.0):
        super().__init__()
        self._buffer("degree", degree)
        self._buffer("const", const)

    def forward(self, x, y):
        return (dot_product(x, y) + self.const) ** self.degree


class PeriodicKernel(BaseKernel):
    """``K(x, y) = exp(-2 sin^2(pi ||x - y||_1 / p) / l^2)``."""

    def __init__(self, period=math.pi, lengthscale=1.0):
        super().__init__()
        self._buffer("period", period)
        self._buffer("lengthscale", lengthscale)

    def forward(self, x, y):
        dist_mat = distance_matrix(x, y, 1.0) * math.pi / self.period
        factor = (-2.0 * torch.square(torch.sin(-dist_mat))
                  / (self.lengthscale ** 2))
        return torch.exp(factor)


class RationalKernel(BaseKernel):
    """Rational quadratic ``K(x, y) = (1 + ||x - y||^2 / (2 a l^2))^-a``."""

    def __init__(self, lengthscale=1.0, weighting=1.0):
        super().__init__()
        self._buffer("lengthscale", lengthscale)
        self._buffer("weighting", weighting)

    def forward(self, x, y):
        euc = euclidean_dist(x / self.lengthscale, y / self.lengthscale)
        factor = 1.0 + euc / (2.0 * self.weighting)
        return factor ** (-self.weighting)


class TanhKernel(BaseKernel):
    """``K(x, y) = tanh(alpha x y^T + c)``; not positive semidefinite."""

    def __init__(self, coeff=1.0, const=1.0):
        super().__init__()
        self._buffer("coeff", coeff)
        self._buffer("const", const)

    def forward(self, x, y):
        return torch.tanh(self.coeff * dot_product(x, y) + self.const)


class OrnsteinUhlenbeckKernel(BaseKernel):
    """``K(x, y) = exp(-||x - y||_1 / l)``."""

    def __init__(self, lengthscale=1.0):
        super().__init__()
        self._buffer("lengthscale", lengthscale)

    def forward(self, x, y):
        return torch.exp(-distance_matrix(x, y, norm=1.0) / self.lengthscale)


class ScaleKernel(BaseKernel):
    """Constant kernel ``K(x, y) = c``."""

    def __init__(self, scaling=1.0):
        super().__init__()
        self._buffer("scaling", scaling)

    def forward(self, x, y):
        shape = x.shape[:-1] + (y.shape[-2],)
        return torch.ones(shape, dtype=x.dtype, device=x.device) * self.scaling


class DiagKernel(BaseKernel):
    """White-noise kernel ``c I`` for equal sample counts, a zero matrix
    otherwise."""

    def __init__(self, scaling=1.0):
        super().__init__()
        self._buffer("scaling", scaling)

    def forward(self, x, y):
        n_x, n_y = x.shape[-2], y.shape[-2]
        shape = x.shape[:-1] + (n_y,)
        if n_x != n_y:
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        eye = torch.eye(n_x, dtype=x.dtype, device=x.device)
        return eye.expand(shape) * self.scaling


class ModuleKernel(BaseKernel):
    """Feature-map kernel ``K(x, y) = phi(x) phi(y)^T``; ``transform`` is
    an ``nn.Module`` (registered as a submodule) or any torch callable."""

    def __init__(self, transform):
        super().__init__()
        self.transform = transform

    def forward(self, x, y):
        return dot_product(self.transform(x), self.transform(y))
