"""
Kernel math helpers (PyTorch port of :mod:`tpu_assim.ops.kernels.utils`).

All helpers work on the trailing two dims (samples x features) and broadcast
over leading batch dims, so that the kernelized per-column solves batch over
the whole grid.
"""

import torch

__all__ = ["dot_product", "distance_matrix", "euclidean_dist"]


def dot_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise dot products ``x y^T`` over the trailing dims."""
    return torch.einsum("...ij,...kj->...ik", x, y)


def _squared_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``||x||^2 + ||y||^2 - 2 x.y``: the Gram expansion, not
    :func:`torch.cdist`, which picks its own formula by size."""
    return (torch.sum(torch.square(x), dim=-1)[..., :, None]
            + torch.sum(torch.square(y), dim=-1)[..., None, :]
            - 2.0 * dot_product(x, y))


def distance_matrix(x: torch.Tensor, y: torch.Tensor,
                    norm: float = 2.0) -> torch.Tensor:
    """Pairwise p-norm distance matrix: for p = 2 through the Gram
    expansion, clamped at 0 against roundoff; otherwise through broadcast
    differences."""
    if norm == 2.0:
        return torch.sqrt(torch.clamp(_squared_distances(x, y), min=0.0))
    diff = torch.abs(x[..., :, None, :] - y[..., None, :, :])
    return torch.sum(diff ** norm, dim=-1) ** (1.0 / norm)


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance matrix, clamped at 0."""
    return torch.clamp(_squared_distances(x, y), min=0.0)
