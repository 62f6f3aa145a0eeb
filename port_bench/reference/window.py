"""
Each grid column's observations inside the taper's support, for sorted
1-D observation coordinates and the distance ``|x_obs - x_grid|``: the
observations strictly within ``2 c`` of the column, padded to the widest
column's count with slots that carry no weight.
"""

import torch

from port_bench.reference.taper import gaspari_cohn


def support_window(obs_x: torch.Tensor, grid_x: torch.Tensor,
                   radius: float):
    """``(idx [g, m], valid [g, m])``: the in-support observations of each
    column, ``m`` the largest count over the columns."""
    if obs_x.numel() > 1 and bool((obs_x[1:] < obs_x[:-1]).any()):
        raise ValueError("the observation coordinates must be sorted")
    lo = torch.searchsorted(obs_x, grid_x - 2.0 * radius, right=True)
    hi = torch.searchsorted(obs_x, grid_x + 2.0 * radius)
    m = max(int((hi - lo).max()), 1)
    idx = lo[:, None] + torch.arange(m, device=obs_x.device)[None, :]
    valid = idx < hi[:, None]
    return torch.clamp(idx, max=obs_x.numel() - 1), valid


def sqrt_taper(obs_x, grid_x, idx, valid, radius: float, epsilon: float):
    """The square roots of the taper weights of the window's slots
    ``[g, m]``, zero in the padding."""
    z = torch.abs(obs_x[idx] - grid_x[:, None]) / radius
    return torch.sqrt(torch.where(valid, gaspari_cohn(z, epsilon), 0.0))
