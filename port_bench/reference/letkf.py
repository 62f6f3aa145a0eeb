"""
The LETKF analysis (Hunt, Kostelich and Szunyogh 2007, Physica D 230:112),
column by column, with the Gaspari-Cohn taper on R^{-1} and the
multiplicative inflation ``rho`` as ``(k - 1) / rho`` in the weight-space
precision.

Per column, with ``Z [m, k]`` the tapered normalized obs-space
perturbations of its in-support observations and ``y [m]`` their
innovations, ``A = (k - 1)/rho I + Z^T Z``, ``w = A^{-1} Z^T y`` and
``W = sqrt(k - 1) A^{-1/2}``. They are evaluated exactly through the
eigendecomposition of the small ``S = Z Z^T = U diag(lam) U^T``:

    w = Z^T U diag(1 / (reg + lam)) U^T y
    A^{-1/2} = reg^{-1/2} (I - Z^T U diag(phi) U^T Z),
    phi = 1 / (reg sqrt(1 + lam/reg) (1 + sqrt(1 + lam/reg)))

so the analysis of member ``j`` is ``mean + u^T U (U^T y / (reg + lam))
+ alpha (sp_j - (Z^T U diag(phi) U^T u)_j)``, ``u = Z sp``, ``alpha =
sqrt((k - 1) / reg)``.
"""

import torch

from port_bench.reference.precision import Products
from port_bench.reference.symeig import eigh


def normalized_obs_space(ens_obs, obs_vals, obs_var):
    """R^{-1/2}-normalized perturbations ``[k, o]`` and innovations ``[o]``
    for a diagonal R."""
    mean = ens_obs.mean(0)
    rinv = 1.0 / torch.sqrt(obs_var)
    return (ens_obs - mean) * rinv, (obs_vals - mean) * rinv


def analysis(prior, ens_obs, obs_vals, obs_var, window, inflation,
             products: Products, block: int = 1 << 18):
    """The analysis ensemble ``[k, g]`` of the prior ``[k, g]`` with its
    obs equivalents ``ens_obs [k, o]``, ``block`` columns at a time;
    ``window(cols) -> (idx [c, m], sqrt_w [c, m])`` gives the columns'
    in-support observations and the square roots of their taper
    weights."""
    p = products
    prior, ens_obs, obs_vals, obs_var = (
        p.cast(t) for t in (prior, ens_obs, obs_vals, obs_var))
    k, g = prior.shape
    perts, innov = normalized_obs_space(ens_obs, obs_vals, obs_var)
    mean = prior.mean(0)
    sp = prior - mean
    reg = (k - 1) / inflation
    alpha = ((k - 1) / reg) ** 0.5
    out = torch.empty_like(prior)
    for c0 in range(0, g, block):
        cols = slice(c0, min(c0 + block, g))
        idx, sw = window(cols)
        z = perts[:, idx].permute(1, 2, 0) * sw[..., None]      # [c, m, k]
        y = innov[idx] * sw                                     # [c, m]
        spc = sp[:, cols].T                                     # [c, k]
        lam, u_vec = eigh(p.einsum("cik,cjk->cij", z, z))
        lam = torch.clamp(lam, min=0.0)
        u = p.einsum("cik,ck->ci", z, spc)                      # Z sp
        uy = p.einsum("cim,ci->cm", u_vec, y)
        uu = p.einsum("cim,ci->cm", u_vec, u)
        x = torch.sqrt(1.0 + lam / reg)
        phi = 1.0 / (reg * x * (1.0 + x))
        mean_upd = torch.sum(uu * uy / (reg + lam), dim=-1)
        v = p.einsum("cim,cm->ci", u_vec, phi * uu)
        corr = p.einsum("cik,ci->ck", z, v)
        out[:, cols] = ((mean[cols] + mean_upd)[None, :]
                        + alpha * (spc - corr).T)
    return out
