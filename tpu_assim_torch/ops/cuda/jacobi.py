"""
Batched symmetric eigendecomposition by two-sided cyclic Jacobi as one
hand-written CUDA kernel (the port of
:func:`tpu_assim.ops.pallas.jacobi.eigh_jacobi`), with its plain PyTorch
twin.

Each round rotates the Kp/2 disjoint row-and-column pairs of one Brent-Luk
tournament seating, pairs on the seats (2i, 2i+1), the even seat "p":

    o   = (a_pq + a_qp) / 2            (one shared value: t_q == -t_p)
    tau = (d_q - d_p) / (2 o)          (o replaced by 1 where |o| <= tiny)
    t   = sign(tau) / (|tau| + sqrt(1 + tau^2)),  +-1 by seat parity where
          tau == 0
    c   = 1 / sqrt(1 + t^2),  s = t c
    frozen (c = 1, s = 0) unless |o| > 8 eps (|d_p| + |d_q|) + tiny

rotating the rows of A, then its columns, then V's columns; then the seats
move one step around the ring (seat 0 fixed), which composes to the
identity every Kp - 1 rounds (one sweep). Before each sweep a matrix stops
once every off-diagonal entry is below its pair's freeze threshold, or
after ``sweeps`` sweeps. A converged sweep would apply identity rotations
only, so the exit is exact. Odd K gets one decoupled pad seat whose
diagonal ``1 + max row-sum |a|`` lies above the spectrum; its eigenpair
sorts last and is sliced off.

The freeze test is the JAX kernel's without its factor Kp: there it reads
``8 Kp eps``, which in f32 at K = 40 leaves off-diagonal entries up to
3.8e-5 (|d_p| + |d_q|). Through it, the f32 analysis of bench config 11
with the (indefinite) Tanh kernel misses the 1e-5 budget against its f64
run; with ``8 eps`` it meets it, and the reconstruction of well-conditioned
batches improves tenfold at the same cap. It costs time: in f32 the exit
then rarely fires before the cap (noise-level rotations go on), so most
matrices run all the sweeps they are allowed, where at ``8 Kp eps`` many
well-conditioned ones stop a sweep or two earlier. ``chip_smoke.py``
phases 21 and 22 measure both thresholds (sweeps, times, errors; PERF.md).

:func:`eigh_jacobi` runs :func:`eigh_jacobi_plain` for CPU tensors and
launches ``csrc/eigh_jacobi.cu`` for CUDA f32 tensors; the kernel's library
is built at its first launch (:mod:`tpu_assim_torch._build`). The launch
gives each matrix one warp (a block of 32 threads, :func:`eigh_jacobi_plan`):
a lane per seat pair computes its rotation, the two-sided update of A runs
one 2 x 2 block at a time in registers (rows, then columns: the operations
of the plain version in its order), V^T's rows turn in the same pass, and
the kernel agrees with :func:`eigh_jacobi_plain` bit for bit on the card.
(On the CPU, PyTorch's vectorized f32 square root can round otherwise than
the correctly rounded one the card and the kernel use, so there the plain
version may differ in the last bit.)
"""

import ctypes
import functools

import torch

from tpu_assim_torch.ops.cuda.svd import _check_square, _seat_source

__all__ = ["LAUNCHES", "eigh_jacobi", "eigh_jacobi_plain", "eigh_jacobi_plan"]

# Launches of the CUDA kernel, counted by the wrapper.
LAUNCHES = {"eigh_jacobi": 0}

# Largest K the kernel takes (the JAX package's gate).
MAX_K = 64
# The freeze test's multiple of eps (see the module docstring).
FREEZE = 8


def eigh_jacobi_plan(k: int) -> dict:
    """K7's launch arithmetic for K x K matrices (csrc/eigh_jacobi.cu): the
    even size ``kp``, the threads of a block (one warp) and the matrices it
    takes (one), V^T's columns that ride in A's rows (``extra``: 32 <
    Kp <= 42, one for each lane past Kp/2, whose block pairs it with the
    zero column), the columns a lane holds in registers (``vt_regs``), the
    odd row stride ``ld`` of A (its columns, the extra ones, the zero
    column) and the block's shared memory in bytes (the pair table, a
    float4 per pair, and A)."""
    kp = k + k % 2
    extra = kp - 32 if 32 < kp and kp - 32 <= 32 - kp // 2 else 0
    ld = (kp + extra) | 1
    return {"kp": kp, "threads": 32, "matrices": 1, "extra": extra,
            "vt_regs": 2 if kp > 32 and not extra else 1, "ld": ld,
            "smem": 16 * (kp // 2) + 4 * kp * ld}


def _pad_odd(a3: torch.Tensor) -> torch.Tensor:
    """``a3 [B, K, K]`` with odd K padded by one decoupled seat of diagonal
    ``1 + max row-sum |a|`` (above every eigenvalue, by Gershgorin); even K
    as it is."""
    b, k, _ = a3.shape
    if k % 2 == 0:
        return a3
    out = a3.new_zeros(b, k + 1, k + 1)
    out[:, :k, :k] = a3
    out[:, k, k] = 1.0 + torch.amax(torch.sum(torch.abs(a3), dim=-1), dim=-1)
    return out


def _sorted(evals, vecs, k, batch_shape):
    """Ascending stable sort of the unsorted ``evals [B, Kp]`` and the
    eigenvector columns of ``vecs [B, Kp, Kp]``, then the odd-K pad (the
    largest eigenvalue) sliced off."""
    order = torch.sort(evals, dim=-1, stable=True).indices
    evals = torch.gather(evals, -1, order)[:, :k]
    vecs = torch.gather(vecs, -1, order[:, None, :].expand_as(vecs))[:, :k, :k]
    return (evals.reshape(batch_shape + (k,)),
            vecs.reshape(batch_shape + (k, k)))


def _unsorted_plain(a, sweeps):
    """The Jacobi iteration over the padded ``a [B, Kp, Kp]``: unsorted
    ``(evals [B, Kp], V [B, Kp, Kp], sweeps run [B])``; a matrix still
    rotating when the cap stopped it counts ``sweeps + 1``."""
    b, kp, _ = a.shape
    dtype, device = a.dtype, a.device
    finfo = torch.finfo(dtype)
    tiny, feps = finfo.tiny, FREEZE * finfo.eps
    seats = torch.arange(kp, device=device)
    swap = seats ^ 1
    perm = torch.tensor(_seat_source(kp), device=device)
    even = (seats % 2 == 0)[None, :]
    off_diag = ~torch.eye(kp, dtype=torch.bool, device=device)
    vt = torch.eye(kp, dtype=dtype, device=device).repeat(b, 1, 1)  # V^T

    def unfrozen(a):
        ad = torch.abs(torch.diagonal(a, dim1=-2, dim2=-1))
        tol = feps * (ad[:, :, None] + ad[:, None, :]) + tiny
        return ((torch.abs(a) > tol) & off_diag).flatten(1).any(-1)

    run = torch.zeros(b, dtype=torch.int32, device=device)
    for _ in range(sweeps):
        live_mat = unfrozen(a)
        if not bool(live_mat.any()):
            break
        run += live_mat.to(torch.int32)
        keep = live_mat[:, None, None]
        a_in, vt_in = a, vt
        for _ in range(kp - 1):
            d = torch.diagonal(a, dim1=-2, dim2=-1)
            o = a[:, seats, swap]
            o = 0.5 * (o + o[:, swap])
            dq = d[:, swap]
            o_safe = torch.where(torch.abs(o) > tiny, o, 1.0)
            tau = (dq - d) / (2.0 * o_safe)
            t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(tau == 0.0, torch.where(even, 1.0, -1.0), t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            live = torch.abs(o) > feps * (torch.abs(d) + torch.abs(dq)) + tiny
            c = torch.where(live, c, 1.0)
            s = torch.where(live, s, 0.0)
            a = c[:, :, None] * a - s[:, :, None] * a[:, swap, :]
            a = c[:, None, :] * a - s[:, None, :] * a[:, :, swap]
            vt = c[:, :, None] * vt - s[:, :, None] * vt[:, swap, :]
            a = a[:, perm][:, :, perm]
            vt = vt[:, perm]
        # a converged matrix keeps its state, as the kernel's per-matrix exit
        a = torch.where(keep, a, a_in)
        vt = torch.where(keep, vt, vt_in)
    else:
        run += unfrozen(a).to(torch.int32)
    return torch.diagonal(a, dim1=-2, dim2=-1), vt.transpose(1, 2), run


def eigh_jacobi_plain(a: torch.Tensor, sweeps: int = 7,
                      with_sweeps: bool = False):
    """Plain PyTorch version of the kernel, in the dtype and on the device
    of its input: the same rounds, freeze test, seating, pad, per-matrix
    exit and cap. The sweep loop stops once no matrix of the batch is left
    rotating (one host sync per sweep). Same contract as
    :func:`eigh_jacobi`."""
    batch_shape, k = _check_square(a)
    evals, vecs, run = _unsorted_plain(_pad_odd(a.reshape(-1, k, k)), sweeps)
    out = _sorted(evals, vecs, k, batch_shape)
    return out + (run.reshape(batch_shape),) if with_sweeps else out


@functools.lru_cache(maxsize=None)
def _eigh_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("eigh_jacobi")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.eigh_jacobi_launch.argtypes = (
        [ptr] * 4 + [i32] * 3 + [f32] * 2 + [ptr])
    lib.eigh_jacobi_launch.restype = i32
    lib.eigh_jacobi_smem_bytes.argtypes = [i32]
    lib.eigh_jacobi_smem_bytes.restype = ctypes.c_size_t
    lib.eigh_jacobi_threads.argtypes = [i32]
    lib.eigh_jacobi_threads.restype = i32
    lib.eigh_jacobi_error_string.argtypes = [i32]
    lib.eigh_jacobi_error_string.restype = ctypes.c_char_p
    return lib


def _launch_eigh(a, sweeps, freeze=FREEZE):
    """K7 on the padded ``a [B, Kp, Kp]`` (contiguous f32 on a CUDA
    device): the triple of :func:`_unsorted_plain`, with the freeze test at
    ``freeze`` eps (``chip_smoke.py`` also runs the JAX kernel's)."""
    if a.requires_grad:
        raise NotImplementedError(
            "the CUDA eigh kernel has no VJP (the JAX package's eigh_jacobi "
            "has none of its own): eigh_psd's gradient is the Daleckii-Krein "
            "backward of ops.linalg.inv_and_inv_sqrt_psd_eigh, whose forward "
            "runs without gradients")
    if a.dtype != torch.float32:
        raise TypeError(f"the CUDA eigh kernel takes f32; got {a.dtype}")
    b, kp, _ = a.shape
    if kp > MAX_K or kp % 2:
        raise ValueError(f"the CUDA eigh kernel takes an even K <= {MAX_K} "
                         f"(odd K padded); got {kp}")
    plan = eigh_jacobi_plan(kp)
    lib = _eigh_lib()
    smem = lib.eigh_jacobi_smem_bytes(kp)
    if (smem, lib.eigh_jacobi_threads(kp)) != (plan["smem"], plan["threads"]):
        raise RuntimeError(
            f"eigh_jacobi: the plan {plan} differs from the kernel's "
            f"{smem} bytes and {lib.eigh_jacobi_threads(kp)} threads")
    evals = torch.empty(b, kp, dtype=a.dtype, device=a.device)
    vecs = torch.empty(b, kp, kp, dtype=a.dtype, device=a.device)
    run = torch.empty(b, dtype=torch.int32, device=a.device)
    finfo = torch.finfo(torch.float32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.eigh_jacobi_launch(
            a.data_ptr(), evals.data_ptr(), vecs.data_ptr(), run.data_ptr(),
            b, kp, int(sweeps), freeze * finfo.eps, finfo.tiny, stream)
    if err != 0:
        raise RuntimeError("eigh_jacobi kernel launch failed: "
                           + lib.eigh_jacobi_error_string(err).decode())
    LAUNCHES["eigh_jacobi"] += 1
    return evals, vecs, run


def eigh_jacobi(a: torch.Tensor, sweeps: int = 7, with_sweeps: bool = False):
    """Batched symmetric eigendecomposition, ascending eigenvalues: the
    plain PyTorch version for a CPU tensor, the CUDA kernel for a CUDA f32
    tensor.

    Parameters
    ----------
    a : [..., K, K] symmetric matrices, any leading batch shape (K <= 64
        on the card).
    sweeps : the cap on sweeps (each Kp - 1 rounds that meet every pair
        once); 7 as the JAX package's ``eigh_psd`` dispatch. A matrix stops
        at the first sweep that finds it converged. An exhausted cap fails
        silently: ``with_sweeps`` shows it.
    with_sweeps : also return the sweeps each matrix ran, ``sweeps + 1``
        for one still rotating when the cap stopped it.

    Returns ``(evals [..., K], evecs [..., K, K])`` with ``a == evecs @
    diag(evals) @ evecs.T``: the :func:`torch.linalg.eigh` contract, column
    signs arbitrary as there. Exact for any symmetric matrix, indefinite
    ones with +lambda/-lambda ties included (where the one-sided route of
    :func:`tpu_assim_torch.ops.cuda.svd.eigh_svd_jacobi` fails). A NaN stays
    in its own matrix; the others are untouched.
    """
    batch_shape, k = _check_square(a)
    if a.device.type == "cpu":
        return eigh_jacobi_plain(a, sweeps, with_sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"no eigh kernel for device {a.device}")
    a3 = _pad_odd(a.reshape(-1, k, k)).contiguous()
    evals, vecs, run = _launch_eigh(a3, sweeps)
    out = _sorted(evals, vecs, k, batch_shape)
    return out + (run.reshape(batch_shape),) if with_sweeps else out
