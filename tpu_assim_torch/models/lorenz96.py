"""
Lorenz '96 model (PyTorch port of :mod:`tpu_assim.models.lorenz96`):
``dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F`` on a periodic ring over
the trailing (grid) axis, batched over any leading dims.
"""

from typing import Union

import torch

__all__ = ["Lorenz96"]


class Lorenz96:
    """Lorenz '96 time-derivative callable.

    Parameters
    ----------
    forcing : constant forcing F (a number, or a tensor broadcasting over the
        grid); the default 8 gives chaotic behaviour.
    """

    def __init__(self, forcing: Union[float, torch.Tensor] = 8.0):
        self.forcing = forcing

    def __str__(self):
        return "Lorenz96(F={0})".format(self.forcing)

    @staticmethod
    def _calc_advection(state: torch.Tensor) -> torch.Tensor:
        """Advection ``(x_{i+1} - x_{i-2}) x_{i-1}``."""
        diff = torch.roll(state, -1, dims=-1) - torch.roll(state, 2, dims=-1)
        return diff * torch.roll(state, 1, dims=-1)

    def __call__(self, state: torch.Tensor) -> torch.Tensor:
        return self._calc_advection(state) + -state + self.forcing
