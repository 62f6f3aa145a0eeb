"""
Kernelized ETKF (KETKF) analysis core (PyTorch port of
:mod:`tpu_assim.ops.ketkf`): the ETKF's regularized weight-space solve with
the Gram matrix of an arbitrary kernel, double-centred in feature space.

Kernels are callables ``kernel(x, y) -> gram`` over the trailing two dims
(:mod:`tpu_assim_torch.ops.kernels`); everything broadcasts over leading
batch dims, so the localized variant evaluates all grid columns at once.
Plain PyTorch: in the JAX package this module is pure XLA, with no kernel
of its own (its eigendecompositions go through ``eigh_psd``).
"""

from typing import Callable, Tuple

import torch

from tpu_assim_torch.ops.cuda.letkf import _cheb_nodes_dct
from tpu_assim_torch.ops.etkf import etkf_prior_weights, etkf_weights_from_gram

__all__ = ["center_gram", "ketkf_cheb_analysis", "ketkf_weights"]


def center_gram(k_perts: torch.Tensor,
                k_obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Double-centre the perturbation Gram matrix and centre the obs Gram
    vector, in the reference's operation order:

        m_part = mean_cols(K_zz) - mean(mean_cols(K_zz))
        K_zz_c = K_zz - mean_rows(K_zz) - m_part
        K_zy_c = K_zy - mean_rows(K_zy) - m_part
    """
    partial_mean = torch.mean(k_perts, dim=-1, keepdim=True)
    partial_mean = partial_mean - torch.mean(partial_mean, dim=-2,
                                             keepdim=True)
    k_perts_centered = (k_perts - torch.mean(k_perts, dim=-2, keepdim=True)
                        - partial_mean)
    k_obs_centered = k_obs - torch.mean(k_obs, dim=-2, keepdim=True)
    return k_perts_centered, k_obs_centered - partial_mean


def ketkf_weights(
    normed_perts: torch.Tensor,
    normed_obs: torch.Tensor,
    kernel: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    inf_factor=1.0,
    method: str = "eigh",
    newton_iters: int = 25,
) -> torch.Tensor:
    """KETKF ensemble weights ``[..., k, k]``.

    Parameters
    ----------
    normed_perts : [..., k, l] normalized obs-space ensemble perturbations.
    normed_obs : [..., 1, l] (or [..., l]) normalized innovations.
    kernel : Gram function, e.g. a :class:`~tpu_assim_torch.ops.kernels.
        GaussKernel`.
    inf_factor : inflation rho (the l2 regularization of the GP weights).
    method : ``"eigh"`` (exact) or ``"newton"`` (Newton-Schulz; the
        double-centred Gram of a PSD kernel is PSD, ``P K P``).
    newton_iters : iterations of ``method="newton"``.
    """
    if normed_obs.ndim == normed_perts.ndim - 1:
        normed_obs = normed_obs[..., None, :]
    ens_size = normed_perts.shape[-2]
    if normed_perts.shape[-1] == 0:
        prior = etkf_prior_weights(ens_size, inf_factor,
                                   dtype=normed_perts.dtype,
                                   device=normed_perts.device)
        return prior.expand(normed_perts.shape[:-2] + (ens_size, ens_size))
    k_perts_centered, k_obs_centered = center_gram(
        kernel(normed_perts, normed_perts), kernel(normed_perts, normed_obs))
    w_mean, w_perts, _ = etkf_weights_from_gram(
        k_perts_centered, k_obs_centered, ens_size, inf_factor,
        method=method, newton_iters=newton_iters)
    return w_mean + w_perts


def ketkf_cheb_analysis(
    scaled_perts: torch.Tensor,
    scaled_obs: torch.Tensor,
    kernel: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    inf_factor,
    sp: torch.Tensor,
    mean: torch.Tensor,
    degree: int = 16,
) -> torch.Tensor:
    """Batched kernelized analysis without the [g, k, k] weights or an
    eigendecomposition of the kernel Grams.

    With ``A = Gc + reg I`` (``Gc`` the double-centred Gram, ``reg =
    (K-1)/rho``) and ``q`` the centred obs Gram vector of a column,

        out[m, c] = mean[c] + sp_c^T A_c^{-1} q_c
                            + sqrt(K-1) (A_c^{-1/2} sp_c)[m],

    both matrix functions of ``X = I + Gc/reg`` (spectrum in ``[1, 1 +
    tr(Gc)/reg]``) as degree-``degree`` Chebyshev expansions, evaluated by
    Clenshaw recurrences of batched mat-vecs. A column with all-zero
    scaled inputs gets ``Gc = 0, q = 0`` and so ``mean + sqrt(rho) sp``.

    Parameters
    ----------
    scaled_perts : [g, k, nb] sqrt(taper)-scaled normalized obs-space
        perturbations per column.
    scaled_obs : [g, 1, nb] scaled innovations per column.
    sp / mean : [ns, k, g] state perturbations / [ns, g] means of ns
        stacked (var, time) slices sharing the solve.

    Returns the analysis [ns, k, g].
    """
    dtype, device = scaled_perts.dtype, scaled_perts.device
    ens_size = sp.shape[-2]
    if scaled_perts.shape[-2] != ens_size:
        raise ValueError(f"scaled_perts has {scaled_perts.shape[-2]} members, "
                         f"sp {ens_size}")
    reg = (ens_size - 1) / torch.as_tensor(inf_factor, dtype=dtype,
                                           device=device)
    gc, qc = center_gram(kernel(scaled_perts, scaled_perts),
                         kernel(scaled_perts, scaled_obs))
    # Gc is PSD (P K P): lam_max <= 1 + tr(Gc)/reg; the 1e-6 floors the
    # zero-width interval of empty columns
    tr = torch.clamp(torch.diagonal(gc, dim1=-2, dim2=-1).sum(-1), min=0.0)
    lam = 1.0 + tr / reg + 1e-6                                      # [g]
    nodes, dct = (torch.as_tensor(a, dtype=dtype, device=device)
                  for a in _cheb_nodes_dct(degree))
    x_nodes = 1.0 + (lam[:, None] - 1.0) * (nodes[None, :] + 1.0) / 2.0
    c_inv = torch.einsum("gj,mj->gm", 1.0 / x_nodes, dct)
    c_isq = torch.einsum("gj,mj->gm", 1.0 / torch.sqrt(x_nodes), dct)

    v = sp.permute(2, 1, 0).to(dtype)                               # [g, k, ns]
    a_scale = (2.0 / (lam - 1.0))[:, None, None]
    b_shift = ((lam + 1.0) / (lam - 1.0))[:, None, None]

    def t_of_x(u):
        return a_scale * (u + gc @ u / reg) - b_shift * u

    def clenshaw(coeffs):
        b1 = torch.zeros_like(v)
        b2 = torch.zeros_like(v)
        for m in range(degree, 0, -1):
            b1, b2 = coeffs[:, m, None, None] * v + 2.0 * t_of_x(b1) - b2, b1
        return coeffs[:, 0, None, None] * v + t_of_x(b1) - b2

    u_inv = clenshaw(c_inv)                                         # X^-1 sp
    u_isq = clenshaw(c_isq)                                         # X^-1/2 sp
    # the mean update per (column, slice): sp^T A^{-1} q = u_inv . q / reg
    s1 = torch.einsum("gkn,gk->gn", u_inv, qc[..., 0]) / reg
    alpha = torch.sqrt((ens_size - 1) / reg)                        # sqrt(rho)
    return (mean[:, None, :] + s1.T[:, None, :]
            + alpha * u_isq.permute(2, 1, 0))
