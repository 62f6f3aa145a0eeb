"""
Eigendecompositions of batches of small symmetric matrices by the cyclic
Jacobi method in round-robin order (Brent and Luk 1985, SIAM J. Sci. Stat.
Comput. 6:69; Golub and Van Loan, Matrix Computations, 4th ed., sec.
8.5.5): a sweep is ``n - 1`` rounds, each of which rotates ``n / 2``
disjoint pairs (p, q) at once, each with the rotation that zeroes its
(p, q) entry, until the off-diagonal part is below the dtype's rounding of
the whole. Disjoint rotations commute, so a round is the product of its
rotations taken in any order.

It does what :mod:`port_bench.reference.symeig` does in ``n - 1`` rounds
a sweep in place of ``n (n - 1) / 2`` single rotations, which is what makes
the windows of 2-D localizations (m up to ~50) affordable on a card over
2^20 columns.
"""

import functools

import torch


@functools.lru_cache(maxsize=None)
def _rounds(n: int):
    """The ``n - 1`` rounds of the round-robin tournament of ``n`` (even)
    indices, each the pairs' smaller and larger indices ``(p, q)``."""
    players = list(range(n))
    out = []
    for _ in range(n - 1):
        pairs = [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        out.append(([min(a, b) for a, b in pairs],
                    [max(a, b) for a, b in pairs]))
        players = [players[0], players[-1]] + players[1:-1]
    return tuple(out)


def _rotation(app, aqq, apq):
    """``(c, s)`` of the rotation that zeroes ``apq`` (symeig._rotate's)."""
    nonzero = apq != 0
    theta = (aqq - app) / (2.0 * torch.where(nonzero, apq, 1.0))
    t = torch.where(theta >= 0, 1.0, -1.0) / (
        theta.abs() + torch.sqrt(theta * theta + 1.0))
    t = torch.where(nonzero, t, 0.0)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    return c, t * c


def eigh(a: torch.Tensor, max_sweeps: int = 30):
    """``(lam [b, m], vectors [b, m, m])`` of the symmetric ``a [b, m,
    m]``: ``a = vectors diag(lam) vectors^T``. A round is applied as ``a
    <- J^T a J``, ``vectors <- vectors J`` with ``J`` its rotations, so
    that batched matrix products do the work (f32 products must not run
    in TF32: ``torch.backends.cuda.matmul.allow_tf32`` False)."""
    b, m, _ = a.shape
    n = m + m % 2
    # an odd size gains a zero row and column: never rotated, dropped last
    a = torch.nn.functional.pad(a, (0, n - m, 0, n - m))
    v = torch.eye(n, dtype=a.dtype, device=a.device).repeat(b, 1, 1)
    tol = (m * torch.finfo(a.dtype).eps) ** 2
    outside = 1.0 - torch.eye(n, dtype=a.dtype, device=a.device)
    rounds = [tuple(torch.tensor(i, device=a.device) for i in r)
              for r in _rounds(n)]
    for _ in range(max_sweeps):
        off = (a * a * outside).sum((1, 2))
        if bool((off <= tol * (a * a).sum((1, 2))).all()):
            break
        for p, q in rounds:
            c, s = _rotation(a[:, p, p], a[:, q, q], a[:, p, q])
            j = torch.zeros_like(a)
            j[:, p, p] = c
            j[:, q, q] = c
            j[:, p, q] = s
            j[:, q, p] = -s
            a = j.transpose(1, 2) @ a @ j
            v = v @ j
    return torch.diagonal(a, dim1=1, dim2=2)[:, :m].clone(), v[:, :m, :m]
