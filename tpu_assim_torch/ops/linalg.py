"""
Batched linear-algebra helpers for the analysis cores (PyTorch port of
:mod:`tpu_assim.ops.linalg`), over arbitrary leading batch dimensions.

Forward only: the Daleckii-Krein derivative of
:func:`inv_and_inv_sqrt_psd_eigh` is not ported yet.
"""

from typing import Tuple

import torch

__all__ = [
    "diagonal_add",
    "eigh_psd",
    "evd",
    "inv_and_inv_sqrt_psd_eigh",
    "matrix_product",
    "rev_evd",
]


def eigh_psd(tensor: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric eigendecomposition: ascending eigenvalues and
    eigenvector columns, as :func:`torch.linalg.eigh`.

    This calls :func:`torch.linalg.eigh` on every device, which is what the
    JAX package does off the TPU. On CUDA the batched one-sided Jacobi
    kernel (the port of ``tpu_assim.ops.pallas.svd.eigh_svd_jacobi``) is to
    take over large f32 batches in a later change.
    """
    return torch.linalg.eigh(tensor)


def evd(tensor: torch.Tensor, reg_value=0.0):
    """Eigendecomposition of a symmetric PSD tensor with regularization: the
    eigenvalues of the nearest PSD matrix (clamped at 0) plus
    ``reg_value``, with their inverses.

    Returns ``(evals [..., n], evects [..., n, n], evals_inv [..., n])``.
    """
    evals, evects = eigh_psd(tensor)
    evals = torch.clamp(evals, min=0.0) + reg_value
    return evals, evects, 1.0 / evals


def rev_evd(evals: torch.Tensor, evects: torch.Tensor) -> torch.Tensor:
    """Recompose ``U diag(evals) U^T``."""
    return torch.einsum("...ik,...k,...jk->...ij", evects, evals, evects)


def matrix_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y^T`` over the trailing two dims."""
    return torch.einsum("...kl,...ml->...km", x, y)


def diagonal_add(tensor: torch.Tensor, to_add=0.0) -> torch.Tensor:
    """Add a scalar to the diagonal of the trailing two dims."""
    eye = torch.eye(tensor.shape[-1], dtype=tensor.dtype, device=tensor.device)
    return tensor + to_add * eye


def inv_and_inv_sqrt_psd_eigh(g_mat: torch.Tensor, reg):
    """``((Gc + reg I)^{-1}, (Gc + reg I)^{-1/2})`` of a batched symmetric
    PSD matrix through one eigendecomposition, ``Gc`` the eigenvalue-clamped
    (nearest-PSD) input."""
    evals, evects = eigh_psd(g_mat)
    h = torch.clamp(evals, min=0.0) + reg
    return rev_evd(1.0 / h, evects), rev_evd(1.0 / torch.sqrt(h), evects)
