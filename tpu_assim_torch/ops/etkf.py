"""
ETKF weight-space analysis core (PyTorch port of :mod:`tpu_assim.ops.etkf`).

Given R^{-1/2}-normalized observation-space ensemble perturbations ``Z``
(ens x obs) and normalized innovations ``y`` (obs,), the K x K ensemble
weights are

    W = w_mean + W'   with
    C_a = (Z Z^T + (K-1)/rho I)^{-1}
    w_mean = C_a Z y^T
    W'  = ((K-1) C_a)^{1/2}

Two solves: ``method="eigh"`` (exact eigendecomposition) and
``method="newton"`` (matmul-only coupled Newton-Schulz). Over obs
neighborhoods, ``method="woodbury"`` runs the Newton-Schulz iterations on the
nb x nb dual matrix instead of the K x K one.

All functions broadcast over leading batch dimensions.
"""

from typing import Tuple

import torch

from tpu_assim_torch.ops.linalg import (
    inv_and_inv_sqrt_psd_eigh,
    inv_spd_newton,
    inv_sqrt_psd_newton,
    matrix_product,
    sqrt_and_inv_sqrt_psd_newton,
)
from tpu_assim_torch.ops.localization import safe_sqrt

__all__ = [
    "etkf_prior_weights",
    "etkf_weights",
    "etkf_weights_from_gram",
    "letkf_weights_dense",
    "letkf_weights_nbh",
]


def etkf_prior_weights(ens_size: int, inf_factor=1.0, dtype=torch.float64,
                       device=None) -> torch.Tensor:
    """Inflated prior weights ``sqrt(rho) * I`` of the empty-obs path."""
    rho = torch.as_tensor(inf_factor, dtype=dtype, device=device)
    return torch.sqrt(rho) * torch.eye(ens_size, dtype=dtype, device=device)


def etkf_weights_from_gram(
    kernel_perts: torch.Tensor,
    kernel_obs: torch.Tensor,
    ens_size: int,
    inf_factor=1.0,
    method: str = "eigh",
    newton_iters: int = 25,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Solve for ``(w_mean, w_perts, cov_analysed)`` from a Gram matrix
    ``kernel_perts [..., k, k]`` and Gram vector ``kernel_obs [..., k, 1]``
    with the regularizer ``(K-1)/rho``: by eigendecomposition
    (``"eigh"``) or by ``newton_iters`` coupled Newton-Schulz steps on
    ``G + reg I`` (``"newton"``)."""
    reg_value = (ens_size - 1) / torch.as_tensor(
        inf_factor, dtype=kernel_perts.dtype, device=kernel_perts.device)
    if method == "newton":
        eye = torch.eye(ens_size, dtype=kernel_perts.dtype,
                        device=kernel_perts.device)
        cov_analysed, a_inv_sqrt = inv_sqrt_psd_newton(
            kernel_perts + reg_value * eye, num_iters=newton_iters,
            lam_min=reg_value)
    elif method == "eigh":
        cov_analysed, a_inv_sqrt = inv_and_inv_sqrt_psd_eigh(kernel_perts,
                                                             reg_value)
    else:
        raise ValueError(f"unknown method {method!r}; use 'eigh' or 'newton'")
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
    newton_iters: int = 25,
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
        kernel_perts, kernel_obs, ens_size, inf_factor, method=method,
        newton_iters=newton_iters)
    return w_mean + w_perts


def letkf_weights_nbh(
    normed_perts: torch.Tensor,
    normed_obs: torch.Tensor,
    nbh_idx: torch.Tensor,
    nbh_weights: torch.Tensor,
    inf_factor=1.0,
    method: str = "eigh",
    newton_iters: int = 25,
) -> torch.Tensor:
    """Localized ETKF weights over fixed-size obs neighborhoods: the math of
    :func:`letkf_weights_dense`, with each column's Gram products over only
    its ``nb`` selected observations
    (:func:`tpu_assim_torch.ops.localization.neighborhood_select`).

    Parameters
    ----------
    normed_perts : [k, o] normalized obs-space perturbations (shared).
    normed_obs : [o] normalized innovations (shared).
    nbh_idx : [g, nb] obs indices per grid column.
    nbh_weights : [g, nb] taper weights of the selected obs (0 = padding).
    method : ``"eigh"``, ``"newton"`` or ``"woodbury"`` (the Newton-Schulz
        solve on the nb x nb dual matrix).

    Returns ``[g, k, k]`` per-column weight matrices; NaN in a column whose
    weights hold the strict selection's NaN poison.
    """
    normed_obs = normed_obs.reshape(-1)
    ens_size = normed_perts.shape[-2]
    z = normed_perts[:, nbh_idx]                                  # [k, g, nb]
    y = normed_obs[nbh_idx]                                       # [g, nb]
    if method == "woodbury":
        return _letkf_weights_nbh_woodbury(z, y, nbh_weights, ens_size,
                                           inf_factor, newton_iters)
    if method == "eigh":
        # LAPACK raises on a NaN matrix: a poisoned column solves with zero
        # weights and is NaN-ed after, as the JAX package's eigh leaves it
        poisoned = torch.isnan(nbh_weights).any(-1)[:, None, None]
        nbh_weights = torch.where(poisoned[..., 0], 0.0, nbh_weights)
    kernel_perts = torch.einsum("kgn,gn,mgn->gkm", z, nbh_weights, z)
    kernel_obs = torch.einsum("kgn,gn,gn->gk", z, nbh_weights, y)[..., None]
    w_mean, w_perts, _ = etkf_weights_from_gram(
        kernel_perts, kernel_obs, ens_size, inf_factor, method=method,
        newton_iters=newton_iters)
    if method == "eigh":
        return torch.where(poisoned, torch.nan, w_mean + w_perts)
    return w_mean + w_perts


def _letkf_weights_nbh_woodbury(z, y, nbh_weights, ens_size: int, inf_factor,
                                newton_iters: int = 10) -> torch.Tensor:
    """Dual-space (Woodbury) localized ETKF solve over obs neighborhoods.

    With ``Zh`` the sqrt-weight-scaled neighborhood perturbations [K, nb] of
    a column and ``X = I + Zh^T Zh / reg`` (nb x nb):

        w_mean   = Zh X^{-1} yh / reg
        A^{-1/2} = reg^{-1/2} [I_K - Zh (X^{1/2} + I)^{-1} X^{-1/2} Zh^T / reg]

    so the Newton-Schulz iterations run on nb x nb matrices. The same
    weights as the eigh solve, at working precision.

    z [k, g, nb], y [g, nb], nbh_weights [g, nb] -> weights [g, k, k].
    """
    dtype, device = z.dtype, z.device
    k = ens_size
    nb = z.shape[-1]
    reg = (k - 1) / torch.as_tensor(inf_factor, dtype=dtype, device=device)
    sw = safe_sqrt(nbh_weights).to(dtype)                         # [g, nb]
    zh = z.permute(1, 0, 2) * sw[:, None, :]                      # [g, k, nb]
    yh = y * sw
    eye_nb = torch.eye(nb, dtype=dtype, device=device)
    x = eye_nb + torch.einsum("gkn,gkm->gnm", zh, zh) / reg
    x_sqrt, x_inv_sqrt = sqrt_and_inv_sqrt_psd_newton(
        x, num_iters=newton_iters, lam_min=1.0)
    x_inv = x_inv_sqrt @ x_inv_sqrt
    n_mat = inv_spd_newton(x_sqrt + eye_nb, num_iters=newton_iters,
                           lam_min=2.0) @ x_inv_sqrt
    w_mean = torch.einsum("gkn,gnm,gm->gk", zh, x_inv, yh) / reg  # [g, k]
    zn = zh @ n_mat                                               # [g, k, nb]
    w_perts = torch.sqrt((k - 1) / reg) * (
        torch.eye(k, dtype=dtype, device=device)
        - zn @ zh.transpose(-1, -2) / reg)
    return w_mean[..., None] + w_perts
