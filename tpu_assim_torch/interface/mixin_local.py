"""
Grid chunking for the localized solves (PyTorch port of
:func:`tpu_assim.interface.mixin_local.map_grid_chunked`).
"""

from typing import Callable, Optional

import torch

__all__ = ["map_grid_chunked"]


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
