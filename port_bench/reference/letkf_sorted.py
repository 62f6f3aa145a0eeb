"""
The LETKF of :mod:`port_bench.reference.letkf`, the same equations column
by column, with the columns taken in the order of their window sizes: a
block of columns pads its windows only to the widest of its neighbours in
that order, where a 2-D window's size ranges several fold over a grid.

The eigendecompositions of the blocks' ``S = Z Z^T`` are LAPACK's
(``torch.linalg.eigh``) for CPU tensors, and the round-robin Jacobi's
(:mod:`port_bench.reference.symeig_rr`) on a card, where cuSOLVER's batched
route stops at 32 x 32.
"""

import torch

from port_bench.reference import symeig_rr
from port_bench.reference.letkf import normalized_obs_space
from port_bench.reference.precision import Products


def analysis(prior, ens_obs, obs_vals, obs_var, window, counts, inflation,
             products: Products, block: int = 1 << 16):
    """The analysis ensemble ``[k, g]`` of :func:`port_bench.reference.
    letkf.analysis`; ``counts [g]`` orders the columns, ``block`` columns
    at a time, and ``window(cols) -> (idx [c, m], sqrt_w [c, m])`` gives
    the in-support observations of the columns ``cols`` (an index tensor)
    and the square roots of their taper weights."""
    p = products
    eigh = torch.linalg.eigh if prior.device.type == "cpu" else symeig_rr.eigh
    prior, ens_obs, obs_vals, obs_var = (
        p.cast(t) for t in (prior, ens_obs, obs_vals, obs_var))
    k, g = prior.shape
    perts, innov = normalized_obs_space(ens_obs, obs_vals, obs_var)
    mean = prior.mean(0)
    sp = prior - mean
    reg = (k - 1) / inflation
    alpha = ((k - 1) / reg) ** 0.5
    out = torch.empty_like(prior)
    order = torch.argsort(counts, stable=True)
    for c0 in range(0, g, block):
        cols = order[c0:c0 + block]
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
