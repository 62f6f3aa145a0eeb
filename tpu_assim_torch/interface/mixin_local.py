"""
Grid chunking and the domain-localization mixin of the localized solves
(PyTorch port of :mod:`tpu_assim.interface.mixin_local`).
"""

from typing import Callable, Optional

import torch

__all__ = ["DomainLocalizedMixin", "map_grid_chunked"]


def map_grid_chunked(
    fn: Callable[[torch.Tensor], torch.Tensor],
    grid_info: torch.Tensor,
    chunk_size: Optional[int],
) -> torch.Tensor:
    """Apply ``fn`` over ``grid_info [g, d]`` in chunks of ``chunk_size``
    columns and concatenate the results. ``fn`` maps ``[c, d] -> [c, ...]``;
    ``chunk_size`` bounds the memory of each chunk's ``[c, o]`` taper
    block."""
    n_grid = grid_info.shape[0]
    if chunk_size is None or chunk_size >= n_grid:
        return fn(grid_info)
    return torch.cat([fn(grid_info[i:i + chunk_size])
                      for i in range(0, n_grid, chunk_size)], dim=0)


class DomainLocalizedMixin:
    """Shared helpers of the domain-localized algorithms; the class holds a
    ``localization`` (None: every observation counts fully)."""

    def _localized_obs_weights(self, grid_info: torch.Tensor,
                               obs_info: torch.Tensor,
                               dtype) -> torch.Tensor:
        """Taper weights [g, l] of every grid column; all ones without a
        localization."""
        if self.localization is None:
            return torch.ones(grid_info.shape[0], obs_info.shape[0],
                              dtype=dtype, device=grid_info.device)
        return self.localization.taper_weights(grid_info, obs_info).to(dtype)
