"""
Eigendecompositions of batches of small symmetric matrices by the cyclic
Jacobi method (Golub and Van Loan, Matrix Computations, 4th ed., sec.
8.5.2), vectorized over the batch: each sweep rotates every pair (p, q)
once, with the rotation that zeroes the (p, q) entry, until the
off-diagonal part is below the dtype's rounding of the whole.

The reference uses it for its m x m matrices (m the most observations in
a column's support, 5 to 8 here), whose batches of 10^4 to 2^20 are slow
through LAPACK on the host and are refused by some cuSOLVER batched
routes.
"""

import torch


def _rotate(a, v, p, q):
    apq = a[:, p, q]
    nonzero = apq != 0
    theta = (a[:, q, q] - a[:, p, p]) / (2.0 * torch.where(nonzero, apq, 1.0))
    t = torch.where(theta >= 0, 1.0, -1.0) / (
        theta.abs() + torch.sqrt(theta * theta + 1.0))
    t = torch.where(nonzero, t, 0.0)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    s = t * c
    c, s = c[:, None], s[:, None]
    for x in (a, v):                       # columns: x <- x J
        xp, xq = x[:, :, p].clone(), x[:, :, q].clone()
        x[:, :, p] = c * xp - s * xq
        x[:, :, q] = s * xp + c * xq
    ap, aq = a[:, p, :].clone(), a[:, q, :].clone()   # rows: a <- J^T a
    a[:, p, :] = c * ap - s * aq
    a[:, q, :] = s * ap + c * aq


def eigh(a: torch.Tensor, max_sweeps: int = 30):
    """``(lam [b, m], vectors [b, m, m])`` of the symmetric ``a [b, m,
    m]``: ``a = vectors diag(lam) vectors^T``."""
    a = a.clone()
    b, m, _ = a.shape
    v = torch.eye(m, dtype=a.dtype, device=a.device).repeat(b, 1, 1)
    tol = (m * torch.finfo(a.dtype).eps) ** 2
    outside = 1.0 - torch.eye(m, dtype=a.dtype, device=a.device)
    for _ in range(max_sweeps):
        off = (a * a * outside).sum((1, 2))
        if bool((off <= tol * (a * a).sum((1, 2))).all()):
            break
        for p in range(m - 1):
            for q in range(p + 1, m):
                _rotate(a, v, p, q)
    return torch.diagonal(a, dim1=1, dim2=2).clone(), v
