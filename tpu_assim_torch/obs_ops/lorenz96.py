"""
Lorenz-96 observation operators (PyTorch port of
:mod:`tpu_assim.obs_ops.lorenz96`).
"""

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from tpu_assim_torch.obs_ops.base_ops import BaseOperator

__all__ = ["BernoulliOperator", "IdentityOperator"]


class IdentityOperator(BaseOperator):
    """The state at the observed grid points.

    Parameters
    ----------
    obs_points : None (every point), an int (that many points drawn with
        ``random_state``, sorted) or a sequence of grid indices.
    """

    def __init__(self, obs_points: Union[None, int, Sequence[int]] = None,
                 len_grid: int = 40,
                 random_state: Optional[np.random.RandomState] = None):
        super().__init__(len_grid=len_grid, random_state=random_state)
        self._obs_points = None
        self._sel_obs_points = None
        self.obs_points = obs_points

    @property
    def obs_points(self):
        return self._obs_points

    @obs_points.setter
    def obs_points(self, points):
        if isinstance(points, (int, float)):
            rs = self.random_state or np.random
            self._sel_obs_points = np.sort(
                rs.choice(self.len_grid, size=int(points), replace=False))
        elif points is None:
            self._sel_obs_points = np.arange(self.len_grid)
        else:
            self._sel_obs_points = np.asarray(points)
        self._obs_points = points

    def _select_var(self, in_state) -> torch.Tensor:
        """Variable 'x' if the state has one, else the first: [time, ens,
        grid]."""
        v = in_state.var_names.index("x") if "x" in in_state.var_names else 0
        return in_state.data[v]

    def obs_op(self, in_state, *args, **kwargs) -> torch.Tensor:
        values = self._select_var(in_state)
        return values[..., torch.as_tensor(self._sel_obs_points,
                                           device=values.device)]

    def torch_operator(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The one-hot linear map ``[..., grid] -> [..., obs]``."""
        n_obs = len(self._sel_obs_points)
        h_np = np.zeros((n_obs, self.len_grid))
        h_np[np.arange(n_obs), self._sel_obs_points] = 1.0

        def operator(x: torch.Tensor) -> torch.Tensor:
            h = torch.as_tensor(h_np, dtype=x.dtype, device=x.device)
            return torch.einsum("...g,og->...o", x, h)

        return operator


class BernoulliOperator(IdentityOperator):
    """``sigmoid(x - shift)`` at the observed grid points."""

    def __init__(self, shift: float = 5.0,
                 obs_points: Union[None, int, Sequence[int]] = None,
                 len_grid: int = 40,
                 random_state: Optional[np.random.RandomState] = None):
        super().__init__(obs_points=obs_points, len_grid=len_grid,
                         random_state=random_state)
        self.shift = shift

    def obs_op(self, in_state, *args, **kwargs) -> torch.Tensor:
        return torch.sigmoid(super().obs_op(in_state, *args, **kwargs)
                             - self.shift)

    def torch_operator(self) -> Callable[[torch.Tensor], torch.Tensor]:
        linear = super().torch_operator()

        def operator(x: torch.Tensor) -> torch.Tensor:
            return torch.sigmoid(linear(x) - self.shift)

        return operator
