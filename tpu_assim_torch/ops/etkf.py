"""
ETKF weight-space analysis core (PyTorch port of :mod:`tpu_assim.ops.etkf`,
exact eigendecomposition solve only).

Given R^{-1/2}-normalized observation-space ensemble perturbations ``Z``
(ens x obs) and normalized innovations ``y`` (obs,), the K x K ensemble
weights are

    W = w_mean + W'   with
    C_a = (Z Z^T + (K-1)/rho I)^{-1}
    w_mean = C_a Z y^T
    W'  = ((K-1) C_a)^{1/2}

All functions broadcast over leading batch dimensions.
"""

from typing import Tuple

import torch

from tpu_assim_torch.ops.linalg import inv_and_inv_sqrt_psd_eigh, matrix_product

__all__ = [
    "etkf_prior_weights",
    "etkf_weights",
    "etkf_weights_from_gram",
    "letkf_weights_dense",
]


def etkf_prior_weights(ens_size: int, inf_factor=1.0, dtype=torch.float64,
                       device=None) -> torch.Tensor:
    """Inflated prior weights ``sqrt(rho) * I`` of the empty-obs path."""
    rho = torch.as_tensor(inf_factor, dtype=dtype, device=device)
    return torch.sqrt(rho) * torch.eye(ens_size, dtype=dtype, device=device)


def _check_method(method: str) -> None:
    if method != "eigh":
        raise NotImplementedError(
            f"method={method!r} is not ported yet; only 'eigh' is "
            "(ROADMAP.md Queue 1 item 2: the Newton-Schulz and Woodbury "
            "solves)"
        )


def etkf_weights_from_gram(
    kernel_perts: torch.Tensor,
    kernel_obs: torch.Tensor,
    ens_size: int,
    inf_factor=1.0,
    method: str = "eigh",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve for ``(w_mean, w_perts, cov_analysed)`` from a Gram matrix
    ``kernel_perts [..., k, k]`` and Gram vector ``kernel_obs [..., k, 1]``
    with the regularizer ``(K-1)/rho``."""
    _check_method(method)
    reg_value = (ens_size - 1) / torch.as_tensor(
        inf_factor, dtype=kernel_perts.dtype, device=kernel_perts.device)
    cov_analysed, a_inv_sqrt = inv_and_inv_sqrt_psd_eigh(kernel_perts,
                                                         reg_value)
    w_mean = torch.einsum("...ij,...jl->...il", cov_analysed, kernel_obs)
    w_perts = (ens_size - 1) ** 0.5 * a_inv_sqrt
    return w_mean, w_perts, cov_analysed


def etkf_weights(normed_perts: torch.Tensor, normed_obs: torch.Tensor,
                 inf_factor=1.0) -> torch.Tensor:
    """Global ETKF ensemble weights ``[..., k, k]`` from ``normed_perts
    [..., k, l]`` and ``normed_obs [..., 1, l]`` (or ``[..., l]``)."""
    if normed_obs.ndim == normed_perts.ndim - 1:
        normed_obs = normed_obs[..., None, :]
    ens_size = normed_perts.shape[-2]
    if normed_perts.shape[-1] == 0:
        prior = etkf_prior_weights(ens_size, inf_factor,
                                   dtype=normed_perts.dtype,
                                   device=normed_perts.device)
        return prior.expand(normed_perts.shape[:-2] + (ens_size, ens_size))
    kernel_perts = matrix_product(normed_perts, normed_perts)
    kernel_obs = matrix_product(normed_perts, normed_obs)
    w_mean, w_perts, _ = etkf_weights_from_gram(
        kernel_perts, kernel_obs, ens_size, inf_factor)
    return w_mean + w_perts


def letkf_weights_dense(
    normed_perts: torch.Tensor,
    normed_obs: torch.Tensor,
    obs_weights: torch.Tensor,
    inf_factor=1.0,
    method: str = "eigh",
) -> torch.Tensor:
    """Localized ETKF weights for a batch of grid columns at once.

    Scaled perturbations only enter through the Gram products, so
    ``Z_loc Z_loc^T = Z diag(w) Z^T`` and ``Z_loc y_loc^T = Z diag(w) y^T``:
    weighting inside two products over the full obs vector is exactly the
    reference's masked per-column subsets.

    Parameters
    ----------
    normed_perts : [k, l] normalized obs-space perturbations (shared).
    normed_obs : [l] or [1, l] normalized innovations (shared).
    obs_weights : [..., l] per-column taper weights (>= 0).

    Returns ``[..., k, k]`` per-column weight matrices.
    """
    normed_obs = normed_obs.reshape(-1)
    ens_size = normed_perts.shape[-2]
    weighted = normed_perts * obs_weights[..., None, :]          # [..., k, l]
    kernel_perts = weighted @ normed_perts.T                     # [..., k, k]
    kernel_obs = (weighted @ normed_obs)[..., None]              # [..., k, 1]
    w_mean, w_perts, _ = etkf_weights_from_gram(
        kernel_perts, kernel_obs, ens_size, inf_factor, method=method)
    return w_mean + w_perts
