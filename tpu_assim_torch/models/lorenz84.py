"""
Lorenz '84 Hadley-circulation model (PyTorch port of
:mod:`tpu_assim.models.lorenz84`): three coupled variables (westerly
current X, cosine/sine eddy phases Y, Z) with damping ``a``, displacement
``b``, and symmetric/asymmetric forcings ``F``/``G``:

    dX/dt = -Y^2 - Z^2 - aX + aF
    dY/dt =  XY - bXZ - Y + G
    dZ/dt =  bXY + XZ - Z

over the trailing (variable, size-3) axis, batched over any leading dims.
"""

import torch

__all__ = ["Lorenz84"]


class Lorenz84:
    """Lorenz '84 time-derivative callable.

    Parameters
    ----------
    damp_factor, dis_factor : the damping ``a`` and displacement ``b``.
    symm_forcing, asymm_forcing : the forcings ``F`` and ``G``.
    """

    def __init__(
        self,
        damp_factor: float = 0.25,
        dis_factor: float = 4.0,
        symm_forcing: float = 8.0,
        asymm_forcing: float = 1.0,
    ):
        self.damp_factor = damp_factor
        self.dis_factor = dis_factor
        self.symm_forcing = symm_forcing
        self.asymm_forcing = asymm_forcing

    def __str__(self):
        return "Lorenz84({0}, {1}, {2}, {3})".format(
            self.damp_factor, self.dis_factor, self.symm_forcing,
            self.asymm_forcing,
        )

    def _calc_westerly(self, state: torch.Tensor) -> torch.Tensor:
        coupling = -state[..., 1] ** 2 - state[..., 2] ** 2
        damping = self.damp_factor * state[..., 0]
        forcing = self.damp_factor * self.symm_forcing
        return coupling - damping + forcing

    def _calc_cosine_phase(self, state: torch.Tensor) -> torch.Tensor:
        amp = state[..., 0] * state[..., 1]
        displace = -self.dis_factor * state[..., 0] * state[..., 2]
        return amp + displace - state[..., 1] + self.asymm_forcing

    def _calc_sine_phase(self, state: torch.Tensor) -> torch.Tensor:
        amp = state[..., 0] * state[..., 2]
        displace = self.dis_factor * state[..., 0] * state[..., 1]
        return amp + displace - state[..., 2]

    def __call__(self, state: torch.Tensor) -> torch.Tensor:
        return torch.stack(
            [
                self._calc_westerly(state),
                self._calc_cosine_phase(state),
                self._calc_sine_phase(state),
            ],
            dim=-1,
        )
