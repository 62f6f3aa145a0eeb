"""
Batched square SVD by one-sided (Hestenes) Jacobi as one hand-written CUDA
kernel (the port of :func:`tpu_assim.ops.pallas.svd.svd_jacobi`), with its
plain PyTorch twin, its gradient and the eigendecomposition through it.

Each round orthogonalizes the K/2 disjoint column pairs of one Brent-Luk
tournament seating: a pair freezes when ``|a_p . a_q| <= FREEZE eps |a_p|
|a_q| + tiny``, else it is rotated by the stable Jacobi angle; the seating
composes to the identity every Kp - 1 rounds (one sweep). The iteration
stops after the first sweep that rotated nothing, or after ``sweeps``
sweeps. Then ``sigma_j = |a_j|``, ``u_j = a_j / sigma_j`` and V is the
product of the rotations.

The freeze test is the JAX kernel's without its factor Kp: there it reads
``8 Kp eps``. A frozen pair keeps its cosine, so U ends non-orthogonal by
up to the threshold: 3.8e-5 at K = 40 in f32 with ``8 Kp eps``, which
carries into the IEnKS compositions ``U S^-1 V^T`` as a 6e-5 relative
error against f64, six times the analysis' budget of 1e-5. With ``8 eps``
U is orthogonal to about 1e-6 and the iteration takes the same number of
sweeps (Jacobi converges quadratically near the end).

:func:`svd_jacobi` runs :func:`svd_jacobi_plain` for CPU tensors and
launches ``csrc/svd_jacobi.cu`` for CUDA f32 tensors (one block per matrix,
a team of 4 lanes per column pair; :func:`svd_jacobi_plan`). The kernel
sums its dot products in another order than the plain version, so the two
agree within rounding, not bit for bit. The kernel's library is built at
its first launch (:mod:`tpu_assim_torch._build`). Both routes are
differentiable through one ``torch.autograd.Function`` whose backward is
the JAX package's square-SVD pullback in plain PyTorch (the JAX package
has no backward kernel either).
"""

import ctypes
import functools

import torch

from tpu_assim_torch.utils.profiling import span

__all__ = ["LAUNCHES", "eigh_from_svd", "eigh_svd_jacobi", "svd_jacobi",
           "svd_jacobi_plain", "svd_jacobi_plan", "svd_pullback"]

# Launches of the CUDA kernel, counted by the wrapper.
LAUNCHES = {"svd_jacobi": 0}

# Largest K the kernel takes: a team lane holds at most 4 chunks of 4 rows
# of each of its two columns in registers.
MAX_K = 64
# The freeze test's multiple of eps (see the module docstring).
FREEZE = 8
# The kernel's teams: 4 lanes per column pair, 8 pairs per warp; a team
# lane's 16-byte load covers 4 rows, a team's 16.
_PAIRS_PER_WARP, _CHUNK = 8, 16


def svd_jacobi_plan(k: int) -> dict:
    """K3's launch arithmetic for K x K matrices (csrc/svd_jacobi.cu): the
    even size ``kp``, the rows padded to 16 (``rows``), the column stride
    ``ld`` (16 mod 32), the threads of a block (a warp per 8 column pairs)
    and its shared memory in bytes (A and V, 1/sigma, two seat tables)."""
    kp = k + k % 2
    rows = -(-kp // _CHUNK) * _CHUNK
    ld = rows if rows % 32 == 16 else rows + 16
    threads = -(-(kp // 2) // _PAIRS_PER_WARP) * 32
    return {"kp": kp, "rows": rows, "ld": ld, "threads": threads,
            "smem": (2 * kp * ld + kp) * 4 + 2 * kp * 4}


def _seat_source(kp: int) -> list:
    """The Brent-Luk re-seating: after a round, seat p holds the column
    that sat at ``src[p]`` (seat 0 fixed, the rest one step around the
    ring; the identity for Kp = 2)."""
    if kp == 2:
        return [0, 1]
    src = []
    for p in range(kp):
        if p == 0:
            src.append(0)
        elif p in (2, kp - 1):
            src.append(p - 1)
        else:
            src.append(p - 2 if p % 2 == 0 else p + 2)
    return src


def _check_square(a):
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"square trailing dims required, got "
                         f"{tuple(a.shape)}")
    return tuple(a.shape[:-2]), a.shape[-1]


def _sorted_factors(u, sig, v, k, batch_shape):
    """Descending stable sort of the unsorted factors ``u [B, Kp, Kp]``,
    ``sig [B, Kp]``, ``v [B, Kp, Kp]`` (columns in seat order), then the
    odd-K pad sliced off. The stable sort keeps the pad, which sits in the
    last seat with sigma exactly 0, behind every genuine zero."""
    order = torch.sort(-sig, dim=-1, stable=True).indices
    sig = torch.gather(sig, -1, order)[:, :k]
    cols = order[:, None, :].expand_as(u)
    u = torch.gather(u, -1, cols)[:, :k, :k]
    v = torch.gather(v, -1, cols)[:, :k, :k]
    return (u.reshape(batch_shape + (k, k)), sig.reshape(batch_shape + (k,)),
            v.reshape(batch_shape + (k, k)))


def _unsorted_plain(a, sweeps):
    """The Jacobi iteration over ``a [B, K, K]``: unsorted
    ``(u [B, Kp, Kp], sig [B, Kp], v [B, Kp, Kp])`` in seat order."""
    b, k, _ = a.shape
    kp = k + k % 2
    dtype, device = a.dtype, a.device
    finfo = torch.finfo(dtype)
    tiny, feps = finfo.tiny, FREEZE * finfo.eps
    # columns as rows: at[b, j, i] = A[b, i, j]
    at = torch.zeros(b, kp, kp, dtype=dtype, device=device)
    at[:, :k, :k] = a.transpose(1, 2)
    vt = torch.eye(kp, dtype=dtype, device=device).repeat(b, 1, 1)
    seats = torch.arange(kp, device=device)
    swap = seats ^ 1
    perm = torch.tensor(_seat_source(kp), device=device)
    even = (seats % 2 == 0)[None, :]
    for _ in range(sweeps):
        any_live = torch.zeros((), dtype=torch.bool, device=device)
        for _ in range(kp - 1):
            ps = at[:, swap]
            gam = torch.sum(at * ps, dim=-1)                   # [B, Kp]
            alp = torch.sum(at * at, dim=-1)
            bet = alp[:, swap]
            tol = feps * (torch.sqrt(alp) * torch.sqrt(bet)) + tiny
            live = torch.abs(gam) > tol
            tau = (bet - alp) / (2.0 * torch.where(live, gam, 1.0))
            t = torch.sign(tau) / (torch.abs(tau)
                                   + torch.sqrt(1.0 + tau * tau))
            # tau == 0: 45 degrees, with the sign antisymmetric in the pair
            t = torch.where(tau == 0.0, torch.where(even, 1.0, -1.0), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            c = torch.where(live, c, 1.0)[..., None]
            s = torch.where(live, s, 0.0)[..., None]
            at = (c * at - s * ps)[:, perm]
            vt = (c * vt - s * vt[:, swap])[:, perm]
            any_live = any_live | live.any()
        if not bool(any_live):
            break
    sig = torch.sqrt(torch.sum(at * at, dim=-1))
    inv = torch.where(sig > tiny, 1.0 / torch.clamp(sig, min=tiny), 0.0)
    return ((at * inv[..., None]).transpose(1, 2), sig, vt.transpose(1, 2))


def svd_jacobi_plain(a: torch.Tensor, sweeps: int = 20):
    """Plain PyTorch version of the kernel, in the dtype and on the device
    of its input: the same rotations, freeze test, seating and cap. The
    sweep loop stops once no matrix of the batch rotated in a sweep (one
    host sync per sweep). Same contract as :func:`svd_jacobi`."""
    batch_shape, k = _check_square(a)
    a3 = a.reshape(-1, k, k)
    return _sorted_factors(*_unsorted_plain(a3, sweeps), k, batch_shape)


@functools.lru_cache(maxsize=None)
def _svd_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("svd_jacobi")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.svd_jacobi_launch.argtypes = (
        [ptr] * 4 + [i32] * 3 + [f32] * 2 + [ptr])
    lib.svd_jacobi_launch.restype = i32
    lib.svd_jacobi_smem_bytes.argtypes = [i32]
    lib.svd_jacobi_smem_bytes.restype = ctypes.c_size_t
    lib.svd_jacobi_threads.argtypes = [i32]
    lib.svd_jacobi_threads.restype = i32
    lib.svd_jacobi_error_string.argtypes = [i32]
    lib.svd_jacobi_error_string.restype = ctypes.c_char_p
    return lib


def _launch_svd(a, sweeps):
    if a.dtype != torch.float32:
        raise TypeError(f"the CUDA SVD kernel takes f32; got {a.dtype}")
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    b, k, _ = a.shape
    if k > MAX_K:
        raise ValueError(f"the CUDA SVD kernel takes K <= {MAX_K}; got {k}")
    plan = svd_jacobi_plan(k)
    kp = plan["kp"]
    lib = _svd_lib()
    smem = lib.svd_jacobi_smem_bytes(kp)
    if (smem, lib.svd_jacobi_threads(kp)) != (plan["smem"], plan["threads"]):
        raise RuntimeError(
            f"svd_jacobi: the plan {plan} differs from the kernel's "
            f"{smem} bytes and {lib.svd_jacobi_threads(kp)} threads")
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"K={k} needs {smem} bytes of shared memory per "
                         f"block; Hopper has {SMEM_PER_BLOCK}")
    u = torch.empty(b, kp, kp, dtype=a.dtype, device=a.device)
    v = torch.empty_like(u)
    sig = torch.empty(b, kp, dtype=a.dtype, device=a.device)
    finfo = torch.finfo(torch.float32)
    with span("kernel.svd_jacobi"), torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.svd_jacobi_launch(
            a.data_ptr(), u.data_ptr(), sig.data_ptr(), v.data_ptr(), b, k,
            int(sweeps), FREEZE * finfo.eps, finfo.tiny, stream)
    if err != 0:
        raise RuntimeError("svd_jacobi kernel launch failed: "
                           + lib.svd_jacobi_error_string(err).decode())
    LAUNCHES["svd_jacobi"] += 1
    return u, sig, v


def _svd_jacobi_forward(a, sweeps):
    batch_shape, k = _check_square(a)
    if a.device.type == "cpu":
        return svd_jacobi_plain(a, sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"no SVD kernel for device {a.device}")
    a3 = a.reshape(-1, k, k).contiguous()
    return _sorted_factors(*_launch_svd(a3, sweeps), k, batch_shape)


def _skew(x):
    return x - x.transpose(-1, -2)


def svd_pullback(u, s, v, du, ds, dv):
    """The square-SVD pullback of the JAX package
    (``tpu_assim/ops/linalg.py:_svd_jacobi_bwd``), written in the SVD's own
    ``(u, s, v)``, so any column signs and order feed it:

        dA = U [(F o sk(U^T dU)) S + S (F o sk(V^T dV)) + diag(ds)] V^T

    with ``F_ij = 1 / (s_j^2 - s_i^2)``, zero where ``s_j^2 == s_i^2``,
    and ``sk(X) = X - X^T``. A cotangent of None is skipped."""
    s2 = s * s
    den = s2[..., None, :] - s2[..., :, None]
    f = torch.where(den != 0.0, 1.0 / torch.where(den == 0.0, 1.0, den), 0.0)
    inner = torch.zeros_like(u)
    if du is not None:
        inner = inner + (f * _skew(u.mT @ du)) * s[..., None, :]
    if dv is not None:
        inner = inner + s[..., :, None] * (f * _skew(v.mT @ dv))
    if ds is not None:
        inner = inner + torch.diag_embed(ds)
    return u @ inner @ v.mT


class _SVDJacobi(torch.autograd.Function):
    """:func:`svd_jacobi` with :func:`svd_pullback` as its backward (plain
    PyTorch on either device)."""

    @staticmethod
    def forward(ctx, a, sweeps):
        u, s, v = _svd_jacobi_forward(a, sweeps)
        ctx.save_for_backward(u, s, v)
        ctx.set_materialize_grads(False)
        return u, s, v

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, du, ds, dv):
        return svd_pullback(*ctx.saved_tensors, du, ds, dv), None


def svd_jacobi(a: torch.Tensor, sweeps: int = 20):
    """Batched square SVD, descending singular values: the plain PyTorch
    version for a CPU tensor, the CUDA kernel for a CUDA f32 tensor.
    Differentiable: the gradient is the square-SVD pullback of the JAX
    package (:func:`svd_pullback`), plain PyTorch on either device.

    Parameters
    ----------
    a : [..., K, K] square matrices, any leading batch shape.
    sweeps : the cap on Hestenes sweeps (each K - 1 rounds that meet every
        column pair once). The loop stops at the first sweep that rotated
        nothing, so the cap is not a cost: random f32 batches at K = 40
        need about 7, a sigma span of 1e4 needs up to 16. A cap of 10 left
        U visibly non-orthogonal there, and an exhausted cap fails
        silently, so keep 20.

    Returns ``(u [..., K, K], s [..., K], v [..., K, K])`` with
    ``a == u @ diag(s) @ v.T`` (``v``, not ``v^T``, as ``torch.svd``).

    Contract: :func:`torch.linalg.svd` up to column signs, which are
    arbitrary in both, except that an exactly zero singular value leaves
    its U column zero (LAPACK returns an orthonormal completion). The
    IEnKS consumers invert the singular values, so rank-deficient inputs
    are out of their contract either way. A NaN in a matrix spreads to all
    of its U and s; the other matrices of the batch are untouched. The
    gradient is that of a composition invariant to the column signs (as
    the IEnKS steps take the factors); on exactly repeated singular values
    it drops the coupling of the tied pair, as the JAX package does.
    """
    return _SVDJacobi.apply(a, sweeps)


def eigh_svd_jacobi(a: torch.Tensor, sweeps: int = 20):
    """Batched symmetric eigendecomposition through :func:`svd_jacobi`:
    for symmetric ``A = U diag(s) V^T`` the eigenvectors are V's columns
    and the eigenvalues ``s * sign(diag(U^T V))``, a zero sign read as +1;
    sorted ascending with a stable sort, as :func:`torch.linalg.eigh`.

    One Newton-Schulz step ``V (3 I - V^T V) / 2`` then makes the
    eigenvectors orthogonal to rounding. V is a product of some 300
    rotations at K = 40, and in f32 it drifts from orthogonality by up to
    7e-6, which ``(G + reg I)^{-1/2}`` of the LETKF carries as an 8e-6
    relative error against f64; after the step the error is 6e-7, below
    LAPACK's 1e-6 in f32. The JAX package returns V as it comes.

    Contract: PSD inputs, and any symmetric matrix without an exact
    +lambda/-lambda magnitude tie. On such a tie the singular subspace is
    degenerate and V may mix the two eigendirections (``[[0, 1], [1, 0]]``
    freezes at once with V = I).
    """
    return eigh_from_svd(*svd_jacobi(a, sweeps))


def eigh_from_svd(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor):
    """The eigendecomposition of a symmetric matrix from its SVD
    ``(u, s, v)``, as :func:`eigh_svd_jacobi` takes it, with the
    orthogonalizing step."""
    sign = torch.sign(torch.einsum("...ki,...ki->...i", u, v))
    evals = s * torch.where(sign == 0, 1.0, sign)
    order = torch.sort(evals, dim=-1, stable=True).indices
    evals = torch.gather(evals, -1, order)
    evecs = torch.gather(v, -1, order[..., None, :].expand_as(v))
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    return evals, evecs @ (1.5 * eye - 0.5 * (evecs.mT @ evecs))
