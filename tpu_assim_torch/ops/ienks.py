"""
Iterative Ensemble Kalman Smoother (IEnKS) inner steps (PyTorch port of
:mod:`tpu_assim.ops.ienks`): one Gauss-Newton step in ensemble-weight
space, with a learning rate ``tau`` blending the updated precision, and
(bundle variant) a finite-difference linearization scale ``epsilon``.

Everything broadcasts over leading batch dimensions, so the localized
smoother runs all grid columns in one batched call. Each step takes two
batched K x K SVDs (:func:`tpu_assim_torch.ops.linalg.svd`), which go to
the one-sided Jacobi kernel for large f32 batches on CUDA.
"""

from typing import Tuple

import torch

from tpu_assim_torch.ops.linalg import (
    diagonal_add,
    matrix_product,
    rev_svd,
    svd,
)

__all__ = ["ienks_bundle_step", "ienks_transform_step"]


def _scalar(x, dtype) -> torch.Tensor:
    """``x`` as a tensor of ``dtype``; a number becomes a 0-d CPU tensor,
    which enters CUDA arithmetic as a kernel argument, without the host
    sync of a copy to the device."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.tensor(x, dtype=dtype)


def _split_weights(weights: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and perturbation parts of a weight matrix: the column means of
    ``W - I``, and ``W`` without them."""
    weights_mean = torch.mean(diagonal_add(weights, -1.0), dim=-1,
                              keepdim=True)
    return weights_mean, weights - weights_mean


def _decompose_weights(weights: torch.Tensor, ens_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mean weights, the inverse of the weight perturbations and the
    weight-space precision, through one SVD of the perturbations."""
    w_mean, w_perts = _split_weights(weights)
    u, s, v = svd(w_perts)
    s_inv = 1.0 / s
    w_perts_inv = rev_svd(u, s_inv, v).transpose(-1, -2)
    w_prec = rev_svd(u, s_inv * s_inv, u) * (ens_size - 1)
    return w_mean, w_perts_inv, w_prec


def _matvec(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y^T`` for a single row ``y [..., 1, l]``: ``[..., k, 1]``, as
    a product and a sum over the trailing dim. A batched matrix-vector
    product goes to cuBLAS's gemv, whose kernel, and so whose summation
    order, changes with the batch count; this reduction sums each entry
    in one order whatever the batch, so a column's step does not depend
    on the columns batched with it (a grid shard, a chunk)."""
    return torch.sum(x * y, dim=-1, keepdim=True)


def _get_gradient(w_mean: torch.Tensor, dh_dw: torch.Tensor,
                  normed_obs: torch.Tensor, ens_size: int) -> torch.Tensor:
    """Gauss-Newton gradient ``(K-1) w_mean - dH/dW y^T``."""
    return (ens_size - 1) * w_mean + _matvec(dh_dw, -normed_obs)


def _update_covariance(w_prec: torch.Tensor, dh_dw: torch.Tensor,
                       ens_size: int, tau: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend the old and new weight precision by ``tau``, then SVD-invert it
    into the weight covariance and the square-root perturbation weights."""
    new_prec = diagonal_add(matrix_product(dh_dw, dh_dw), ens_size - 1.0)
    updated_prec = (1.0 - tau) * w_prec + tau * new_prec
    u, s, v = svd(updated_prec)
    s_inv = 1.0 / s
    weights_cov = rev_svd(u, s_inv, v)
    weights_perts = rev_svd(u, torch.sqrt(s_inv * (ens_size - 1)), v)
    return weights_cov, weights_perts


def _ienks_step(weights, normed_perts, normed_obs, tau, dh_dw_fn):
    if normed_obs.ndim == normed_perts.ndim - 1:
        normed_obs = normed_obs[..., None, :]
    ens_size = weights.shape[-2]
    if normed_perts.shape[-1] == 0:
        # no observations: the weights pass through unchanged
        return weights
    w_mean, w_perts_inv, w_prec = _decompose_weights(weights, ens_size)
    dh_dw = dh_dw_fn(normed_perts, w_perts_inv)
    grad = _get_gradient(w_mean, dh_dw, normed_obs, ens_size)
    w_cov, w_perts = _update_covariance(w_prec, dh_dw, ens_size, tau)
    w_mean = w_mean - tau * _matvec(w_cov, grad.transpose(-1, -2))
    return w_mean + w_perts


def ienks_transform_step(weights: torch.Tensor, normed_perts: torch.Tensor,
                         normed_obs: torch.Tensor, tau=1.0) -> torch.Tensor:
    """One IEnKS-Transform inner step; the linearized obs operator is
    ``dH/dW = W'^{-1} Z``.

    Parameters
    ----------
    weights : [..., k, k] current ensemble weights.
    normed_perts : [..., k, l] normalized obs-space perturbations of the
        propagated ensemble.
    normed_obs : [..., 1, l] (or [..., l]) normalized innovations.
    tau : learning rate in [0, 1].
    """
    tau = _scalar(tau, weights.dtype)
    return _ienks_step(
        weights, normed_perts, normed_obs, tau,
        lambda perts, w_perts_inv: torch.einsum(
            "...ij,...jl->...il", w_perts_inv, perts))


def ienks_bundle_step(weights: torch.Tensor, normed_perts: torch.Tensor,
                      normed_obs: torch.Tensor, tau=1.0,
                      epsilon=1e-4) -> torch.Tensor:
    """One IEnKS-Bundle inner step; the finite-difference linearization
    ``dH/dW = Z / epsilon``."""
    tau = _scalar(tau, weights.dtype)
    epsilon = _scalar(epsilon, weights.dtype)
    return _ienks_step(weights, normed_perts, normed_obs, tau,
                       lambda perts, _w_perts_inv: perts / epsilon)
