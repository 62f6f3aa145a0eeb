"""
Observation operators: point observations, and each observation the mean
of the 4 grid columns from its own on, wrapping round the grid's end.
"""

import torch


def point(state: torch.Tensor, obs_idx: torch.Tensor) -> torch.Tensor:
    return state[:, obs_idx]


def mean4(state: torch.Tensor, obs_idx: torch.Tensor) -> torch.Tensor:
    g = state.shape[-1]
    cols = [(obs_idx + s) % g for s in range(4)]
    return sum(state[:, c] for c in cols) / 4.0

