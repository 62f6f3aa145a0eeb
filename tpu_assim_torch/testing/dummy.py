"""
Test doubles (the port of :mod:`tpu_assim.testing.dummy`).
"""

import numpy as np
import torch

from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops.localization import BaseLocalization
from tpu_assim_torch.state import EnsembleState

__all__ = [
    "DummyLocalization",
    "DummyNeuralModule",
    "dummy_distance",
    "dummy_model",
    "dummy_obs_operator",
]


class dummy_obs_operator:
    """Identity operator on variable ``"x"`` (else the first variable) over
    every grid point, at the observation times: [obs_time, ens, grid]."""

    def __call__(self, obs_ds: Observation,
                 state: EnsembleState) -> torch.Tensor:
        v = state.var_names.index("x") if "x" in state.var_names else 0
        values = state.data[v]                          # [time, ens, grid]
        state_times = state.times.detach().cpu().numpy()
        obs_times = obs_ds.times.detach().cpu().numpy()
        t_idx = [int(np.nonzero(state_times == t)[0][0]) for t in obs_times]
        return values[torch.as_tensor(t_idx, device=values.device)]


def dummy_model(state: EnsembleState, iter_num: int = 0):
    """Identity forward model: ``(state, state)``."""
    return state, state


class DummyLocalization(BaseLocalization):
    """Triangular taper, ``max(1 - |dx| / 10, 0)`` on the first observation
    coordinate against the last grid coordinate."""

    def localize_obs(self, grid_coord, obs_coords):
        dist = torch.abs(torch.atleast_2d(obs_coords)[:, 0]
                         - torch.atleast_1d(grid_coord)[-1])
        weights = torch.clamp(1.0 - dist / 10.0, min=0.0)
        return weights > 0.0, weights


def dummy_distance(grid_coord, obs_coords):
    """Absolute distance on the last coordinate column, ``[1, o]``."""
    return torch.abs(torch.atleast_2d(obs_coords)[:, -1]
                     - torch.atleast_1d(grid_coord)[-1])[None, :]


class DummyNeuralModule:
    """Tiny deterministic feature map for ``ModuleKernel`` tests:
    ``[x, x^2]`` on the last axis."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, torch.square(x)], dim=-1)
