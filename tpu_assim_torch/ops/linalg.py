"""
Batched linear-algebra helpers for the analysis cores (PyTorch port of
:mod:`tpu_assim.ops.linalg`), over arbitrary leading batch dimensions.

:func:`svd` and :func:`eigh_psd` send large square f32 batches on a CUDA
device to the one-sided Jacobi kernel
(:mod:`tpu_assim_torch.ops.cuda.svd`), under the JAX package's gate;
``TPU_ASSIM_EIGH_KERNEL=twosided`` sends :func:`eigh_psd`'s to the
two-sided Jacobi kernel (:mod:`tpu_assim_torch.ops.cuda.jacobi`). All else
goes to :func:`torch.linalg.svd` / :func:`torch.linalg.eigh`.

The Newton-Schulz helpers (:func:`inv_sqrt_psd_newton`,
:func:`sqrt_and_inv_sqrt_psd_newton`, :func:`inv_spd_newton`) are
matmul-only iterations on SPD batches.

:func:`inv_and_inv_sqrt_psd_eigh` carries the Daleckii-Krein derivative of
the JAX package as a ``torch.autograd.Function``; both routes of
:func:`svd` carry the JAX package's square-SVD pullback
(:func:`tpu_assim_torch.ops.cuda.svd.svd_pullback`).
"""

import os
from typing import Optional, Tuple

import torch

from tpu_assim_torch.utils.profiling import span

__all__ = [
    "diagonal_add",
    "eigh_psd",
    "evd",
    "inv_and_inv_sqrt_psd_eigh",
    "inv_spd_newton",
    "inv_sqrt_psd_newton",
    "jacobi_dispatch_enabled",
    "matrix_product",
    "rev_evd",
    "rev_svd",
    "set_jacobi_dispatch",
    "sqrt_and_inv_sqrt_psd_newton",
    "svd",
]

# Device types whose f32 batches go to the Jacobi kernel.
JACOBI_DEVICE_TYPES = ("cuda",)

_jacobi_dispatch: Optional[bool] = None  # None: take the env-var default


def set_jacobi_dispatch(enabled: Optional[bool]) -> None:
    """Set the process-wide default of the Jacobi-kernel dispatch of
    :func:`svd` and :func:`eigh_psd`: ``True``/``False`` force it on/off,
    ``None`` restores the environment default (``TPU_ASSIM_JACOBI``, on
    unless set to ``"0"``)."""
    global _jacobi_dispatch
    _jacobi_dispatch = enabled


def jacobi_dispatch_enabled() -> bool:
    """The current default of the Jacobi-kernel dispatch: the value of
    :func:`set_jacobi_dispatch`, else ``TPU_ASSIM_JACOBI``."""
    if _jacobi_dispatch is not None:
        return _jacobi_dispatch
    return os.environ.get("TPU_ASSIM_JACOBI", "1") != "0"


def _takes_jacobi(tensor: torch.Tensor, use_jacobi: Optional[bool]) -> bool:
    """The JAX package's gate: an f32 batch of at least 256 square
    matrices with K <= 64, on a kernel device, dispatch enabled."""
    if use_jacobi is None:
        use_jacobi = jacobi_dispatch_enabled()
    k = tensor.shape[-1]
    return bool(
        use_jacobi
        and tensor.dtype == torch.float32
        and tensor.ndim >= 3
        and tensor.shape[-2] == k
        and k <= 64
        and tensor.shape[:-2].numel() >= 256
        and tensor.device.type in JACOBI_DEVICE_TYPES
    )


class _SquareSVD(torch.autograd.Function):
    """:func:`torch.linalg.svd` of square matrices with the Jacobi route's
    backward, :func:`~tpu_assim_torch.ops.cuda.svd.svd_pullback`. Its tie
    guard keeps the gradient finite where singular values are exactly
    equal; :func:`torch.linalg.svd`'s own backward divides by their zero
    difference there, as the JAX package's LAPACK route does. The IEnKS
    precisions hold such ties: a rank-l update of ``(k - 1) I`` leaves k - l
    singular values at k - 1 (32 of 40 at bench config 9), and the tied
    block of the pullback does not reach the state's gradient."""

    @staticmethod
    def forward(ctx, a):
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        v = vh.transpose(-1, -2)
        ctx.save_for_backward(u, s, v)
        ctx.set_materialize_grads(False)
        return u, s, v

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, du, ds, dv):
        from tpu_assim_torch.ops.cuda.svd import svd_pullback

        return svd_pullback(*ctx.saved_tensors, du, ds, dv)


def svd(tensor: torch.Tensor, reg_value=0.0,
        use_jacobi: Optional[bool] = None):
    """Reduced SVD with the singular values shifted by ``reg_value``.

    Returns ``(u, s, v)`` with ``tensor = u diag(s) v^T``: ``v``, not
    ``v^T``, as :func:`torch.svd`. Large square f32 batches on CUDA go to
    :func:`tpu_assim_torch.ops.cuda.svd.svd_jacobi` (``use_jacobi``,
    :func:`set_jacobi_dispatch` and ``TPU_ASSIM_JACOBI`` control it); the
    rest to :func:`torch.linalg.svd`. Both routes of a square batch are
    differentiable through one pullback, finite on exactly tied singular
    values (:class:`_SquareSVD`).
    """
    with span("linalg.svd"):
        if _takes_jacobi(tensor, use_jacobi):
            from tpu_assim_torch.ops.cuda.svd import svd_jacobi

            u, s, v = svd_jacobi(tensor)
        elif tensor.shape[-1] == tensor.shape[-2]:
            u, s, v = _SquareSVD.apply(tensor)
        else:
            u, s, vh = torch.linalg.svd(tensor, full_matrices=False)
            v = vh.transpose(-1, -2)
        return u, s + reg_value, v


def rev_svd(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Recompose ``u diag(s) v^T``."""
    return torch.einsum("...ik,...k,...jk->...ij", u, s, v)


def eigh_psd(tensor: torch.Tensor, use_jacobi: Optional[bool] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric eigendecomposition: ascending eigenvalues and
    eigenvector columns, as :func:`torch.linalg.eigh`.

    Large f32 batches on CUDA go through the one-sided Jacobi kernel
    (:func:`tpu_assim_torch.ops.cuda.svd.eigh_svd_jacobi`), under the gate
    of :func:`svd`; the rest to :func:`torch.linalg.eigh`. That route is
    exact for PSD inputs, and for symmetric ones without an exact
    +lambda/-lambda magnitude tie. ``TPU_ASSIM_EIGH_KERNEL=twosided``
    (read only on the gate, as in the JAX package) selects the two-sided
    Jacobi kernel (:func:`tpu_assim_torch.ops.cuda.jacobi.eigh_jacobi`,
    7 sweeps), exact for any symmetric input.
    """
    if _takes_jacobi(tensor, use_jacobi):
        if os.environ.get("TPU_ASSIM_EIGH_KERNEL", "onesided") == "twosided":
            from tpu_assim_torch.ops.cuda.jacobi import eigh_jacobi

            return eigh_jacobi(tensor, sweeps=7)
        from tpu_assim_torch.ops.cuda.svd import eigh_svd_jacobi

        return eigh_svd_jacobi(tensor)
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


class _InvAndInvSqrtEigh(torch.autograd.Function):
    """:func:`inv_and_inv_sqrt_psd_eigh` with the exact Daleckii-Krein
    derivative of the JAX package's custom JVP
    (``tpu_assim/ops/linalg.py:_inv_and_inv_sqrt_psd_eigh_jvp``), as its
    adjoint. The forward's eigenpairs come from :func:`eigh_psd` without
    gradients, so the Jacobi kernels' route is differentiable too."""

    @staticmethod
    def forward(ctx, g_mat, reg):
        reg_value = reg.detach() if isinstance(reg, torch.Tensor) else reg
        with torch.no_grad():
            evals, evects = eigh_psd(g_mat.detach())
            h = torch.clamp(evals, min=0.0) + reg_value
            f1 = 1.0 / h
            f2 = 1.0 / torch.sqrt(h)
        ctx.save_for_backward(evals, evects, f1, f2)
        ctx.reg = reg_value
        ctx.reg_shape = reg.shape if isinstance(reg, torch.Tensor) else None
        return rev_evd(f1, evects), rev_evd(f2, evects)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad1, grad2):
        evals, evects, f1, f2 = ctx.saved_tensors
        eps = torch.finfo(evals.dtype).eps
        reg_abs = (abs(ctx.reg) if not isinstance(ctx.reg, torch.Tensor)
                   else torch.abs(ctx.reg))
        scale = torch.amax(torch.abs(evals), dim=-1, keepdim=True) + reg_abs
        # the clamp's derivative: active above rounding-level negatives
        act = (evals > -1e3 * eps * scale).to(evals.dtype)
        d1 = -act * f1 * f1
        d2 = -0.5 * act * f2 * f1
        den = evals[..., :, None] - evals[..., None, :]
        # the derivative mean on pairs closer than sqrt(eps) of the scale:
        # the degenerate limit, and the stable branch of the divided
        # difference
        close = torch.abs(den) <= eps ** 0.5 * scale[..., None]
        den_safe = torch.where(close, 1.0, den)

        def gamma(f, d):
            return torch.where(
                close, 0.5 * (d[..., :, None] + d[..., None, :]),
                (f[..., :, None] - f[..., None, :]) / den_safe)

        inner = torch.zeros_like(den)
        grad_reg = torch.zeros_like(evals)
        for grad, f, d, dh in ((grad1, f1, d1, -f1 * f1),
                               (grad2, f2, d2, -0.5 * f2 * f1)):
            if grad is None:
                continue
            a = evects.transpose(-1, -2) @ grad @ evects
            inner = inner + gamma(f, d) * a
            grad_reg = grad_reg + torch.diagonal(a, dim1=-2, dim2=-1) * dh
        inner = 0.5 * (inner + inner.transpose(-1, -2))
        grad_g = evects @ inner @ evects.transpose(-1, -2)
        if ctx.reg_shape is None:
            return grad_g, None
        # reg broadcasts against the eigenvalues [..., n]
        return grad_g, grad_reg.sum_to_size(ctx.reg_shape)


def inv_and_inv_sqrt_psd_eigh(g_mat: torch.Tensor, reg):
    """``((Gc + reg I)^{-1}, (Gc + reg I)^{-1/2})`` of a batched symmetric
    PSD matrix through one eigendecomposition, ``Gc`` the eigenvalue-clamped
    (nearest-PSD) input.

    Differentiable in ``g_mat`` and ``reg`` by the Daleckii-Krein rule
    (divided differences of the eigenvalue maps, their derivative mean on
    degenerate pairs), so the gradients are finite on the rank-deficient
    Grams of localization and match the matmul-only Newton-Schulz path, as
    in the JAX package. The gradient in ``g_mat`` is that of its symmetric
    part.
    """
    return _InvAndInvSqrtEigh.apply(g_mat, reg)


def _spectral_bound(a: torch.Tensor) -> torch.Tensor:
    """``min(max row-sum |a|, trace a)`` ``[..., 1, 1]``: an upper bound of
    the spectrum of an SPD batch."""
    inf_norm = torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1)
    trace = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
    return torch.minimum(inf_norm, trace)[..., None, None]


def _coupled_newton_schulz(a: torch.Tensor, num_iters: int,
                           lam_min: Optional[float]):
    """The coupled iteration ``T = (3I - Z Y)/2``, ``Y <- Y T``,
    ``Z <- T Z`` from ``Y = a/norm``, ``Z = I``: returns
    ``(a^{1/2}, a^{-1/2})``. With ``lam_min`` the input is scaled by
    ``2/(lam_min + lam_max)``, which centres its spectrum about 1."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    lam_max = _spectral_bound(a)
    norm = lam_max if lam_min is None else 0.5 * (lam_max + lam_min)
    norm = torch.clamp(norm, min=torch.finfo(a.dtype).tiny)
    y = a / norm
    z = eye.expand(a.shape)
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    sqrt_norm = torch.sqrt(norm)
    return y * sqrt_norm, z / sqrt_norm


def inv_sqrt_psd_newton(a: torch.Tensor, num_iters: int = 14,
                        lam_min: Optional[float] = None):
    """Matmul-only ``(a^{-1}, a^{-1/2})`` of a batched SPD matrix by the
    coupled Newton-Schulz iteration; ``lam_min`` is a known lower bound of
    the spectrum (the ETKF regularizer ``(K-1)/rho``)."""
    _, a_inv_sqrt = _coupled_newton_schulz(a, num_iters, lam_min)
    return a_inv_sqrt @ a_inv_sqrt, a_inv_sqrt


def sqrt_and_inv_sqrt_psd_newton(a: torch.Tensor, num_iters: int = 14,
                                 lam_min: Optional[float] = None):
    """``(a^{1/2}, a^{-1/2})`` by the iteration of
    :func:`inv_sqrt_psd_newton`."""
    return _coupled_newton_schulz(a, num_iters, lam_min)


def inv_spd_newton(a: torch.Tensor, num_iters: int = 12,
                   lam_min: Optional[float] = None) -> torch.Tensor:
    """Matmul-only inverse of a batched SPD matrix by the Newton-Schulz
    iteration ``V <- V + V (I - A V)``, seeded with ``2/(lam_min + lam_max)
    I`` (``1/lam_max I`` without ``lam_min``)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    lam_max = _spectral_bound(a)
    scale = 1.0 / lam_max if lam_min is None else 2.0 / (lam_max + lam_min)
    v = scale * eye + 0.0 * a  # the seed carries a NaN of a, as in JAX
    for _ in range(num_iters):
        v = v + v @ (eye - a @ v)
    return v
