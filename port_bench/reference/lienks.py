"""
The localized IEnKS-Transform smoother step (Bocquet and Sakov 2014, QJRMS
140:1521; the per-column localization of pytassim's
``interface/lienks.py``), with the learning rate ``tau = 1``.

Each column ``c`` holds weights ``W_c [k, k]``, the identity at first. An
outer iteration propagates the pseudo-ensemble ``mean + sp W`` (column by
column) through the model, normalizes its obs equivalents by R^{-1/2},
and takes one Gauss-Newton step per column over the tapered in-support
observations ``Z_c [k, m]``, ``y_c [m]``:

    w = mean_j(W - I),  W' = W - w 1^T
    dH = W'^{-1} Z_c,   grad = (k - 1) w - dH y_c
    P = (k - 1) I + dH dH^T
    w <- w - P^{-1} grad,  W <- w 1^T + sqrt(k - 1) P^{-1/2}

``W'^{-1}`` is an LU inverse. ``P`` is ``(k - 1) I`` plus a rank-``m``
term, so with ``dH^T dH = V diag(lam) V^T`` and ``Q = dH V``:

    P^{-1} = (I - Q diag(1 / (k - 1 + lam)) Q^T) / (k - 1)
    sqrt(k - 1) P^{-1/2} = I - Q diag(psi) Q^T,
    psi = 1 / ((k - 1) s (1 + s)),  s = sqrt(1 + lam / (k - 1))

After the last iteration the analysis is ``mean + sp W``.
"""

import torch

from port_bench.reference.letkf import normalized_obs_space
from port_bench.reference.precision import Products
from port_bench.reference.symeig import eigh


def smoother_step(prior, obs_vals, obs_var, observe, window, forecast,
                  n_outer, tau, products: Products):
    """The analysis ``[k, g]`` of the prior ``[k, g]``; ``observe(x) ->
    [k, o]`` is the obs operator, ``forecast(x)`` the model over the
    assimilation window, and ``window(cols) -> (idx [c, m], sqrt_w [c, m])`` the
    columns' in-support observations and the square roots of their taper
    weights."""
    if tau != 1.0:
        raise ValueError(f"the reference holds tau = 1; got {tau}")
    p = products
    prior, obs_vals, obs_var = (
        p.cast(t) for t in (prior, obs_vals, obs_var))
    k, g = prior.shape
    mean = prior.mean(0)
    sp = prior - mean
    idx, sw = window(slice(None))                               # [g, m]
    eye = torch.eye(k, dtype=prior.dtype, device=prior.device)
    weights = eye.expand(g, k, k)
    for _ in range(n_outer):
        pseudo = mean[None, :] + p.einsum("kg,gkm->mg", sp, weights)
        perts, innov = normalized_obs_space(observe(forecast(pseudo)),
                                            obs_vals, obs_var)
        z = perts[:, idx].permute(1, 0, 2) * sw[:, None, :]     # [g, k, m]
        y = innov[idx] * sw                                     # [g, m]
        w_mean = torch.mean(weights - eye, dim=-1, keepdim=True)  # [g, k, 1]
        dh = p.einsum("gij,gjm->gim", torch.linalg.inv(weights - w_mean), z)
        grad = (k - 1) * w_mean[..., 0] - p.einsum("gim,gm->gi", dh, y)
        lam, v = eigh(p.einsum("gim,gin->gmn", dh, dh))
        lam = torch.clamp(lam, min=0.0)
        q = p.einsum("gim,gmn->gin", dh, v)                     # [g, k, m]
        qg = p.einsum("gim,gi->gm", q, grad)
        step = (grad - p.einsum("gim,gm->gi", q, qg / (k - 1 + lam))) / (k - 1)
        s = torch.sqrt(1.0 + lam / (k - 1))
        psi = 1.0 / ((k - 1) * s * (1.0 + s))
        root = eye - p.einsum("gim,gm,gjm->gij", q, psi, q)
        weights = (w_mean[..., 0] - step)[..., None] + root
    return mean[None, :] + p.einsum("kg,gkm->mg", sp, weights)
