"""Toy models and integration (port of :mod:`tpu_assim.models`)."""

from tpu_assim_torch.models.integration import (
    BaseIntegrator,
    RK4Integrator,
    integrate_trajectory,
)
from tpu_assim_torch.models.lorenz84 import Lorenz84
from tpu_assim_torch.models.lorenz96 import Lorenz96

__all__ = [
    "BaseIntegrator",
    "Lorenz84",
    "Lorenz96",
    "RK4Integrator",
    "integrate_trajectory",
]
