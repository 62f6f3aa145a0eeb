"""
The 1-D window LETKF analysis as one hand-written CUDA kernel (the port of
:func:`tpu_assim.ops.pallas.letkf.letkf_window_analysis_fused`), with its
plain PyTorch twin and the numpy host helpers it shares with the JAX
package.

Per grid column: the window of ``nb`` observations around the column's rank
among the sorted observation coordinates, clamped onto its in-support
range; the Gaspari-Cohn taper with sqrt-weight scaling; then the
Chebyshev/Clenshaw evaluation of ``q = X^{-1} yh`` and ``v = f(X) u`` with
``X = I + Zh Zh^T / reg`` and ``f(x) = 1/(sqrt(x)(1 + sqrt(x)))``, applied as
``mean + <u, q>/reg + alpha sp - (alpha/reg) Zh^T v``.

:func:`letkf_window_analysis_fused` runs :func:`window_analysis_plain` for
CPU tensors and launches ``csrc/letkf_window1d.cu`` for CUDA tensors. The
kernel's library is built at its first launch (:mod:`tpu_assim_torch._build`).
"""

import ctypes
import functools
import math

import numpy as np
import torch

from tpu_assim_torch.ops.localization import (
    GaspariCohn,
    GaspariCohnInf,
    safe_sqrt,
    taper_support_z,
)

__all__ = [
    "LAUNCHES",
    "cheb_degree_for",
    "letkf_window_analysis_fused",
    "max_in_support_1d",
    "required_obs_block",
    "window_analysis_plain",
]

# Launches of the CUDA kernel, counted by the wrapper.
LAUNCHES = {"window1d": 0}

_TAPERS = ("gc2", "gcinf")


def cheb_degree_for(lam_max: float, tol: float = 1e-6,
                    lo: int = 6, hi: int = 96) -> int:
    """Chebyshev degree reaching truncation error ``tol`` for ``1/x`` and
    ``1/(sqrt(x)(1+sqrt(x)))`` on ``[1, lam_max]``: the smallest ``d`` with
    ``rho^-d <= tol``, ``rho = (sqrt(lam) + 1)/(sqrt(lam) - 1)`` the
    Bernstein-ellipse parameter through the singularity at 0."""
    lam = max(float(lam_max), 1.0 + 1e-6)
    rho = (math.sqrt(lam) + 1.0) / (math.sqrt(lam) - 1.0)
    d = int(math.ceil(math.log(1.0 / tol) / math.log(rho)))
    return max(lo, min(hi, d))


def required_obs_block(obs_x, grid_x, nb: int, tile: int = 128,
                       radius: float | None = None, taper: str = "gc2",
                       epsilon: float = 1e-5) -> int:
    """Exact per-tile obs block width of the TPU kernel's blocking
    (host-side numpy), for callers that size ``obs_block`` for the JAX
    package. The CUDA kernel searches the whole table and ignores
    ``obs_block``."""
    obs_x = np.asarray(obs_x)
    grid_x = np.asarray(grid_x)
    o = obs_x.shape[0]
    g = grid_x.shape[0]
    n_tiles = -(-g // tile)
    pad = n_tiles * tile - g
    if pad:
        grid_x = np.concatenate([grid_x, np.full(pad, grid_x[-1])])
    tiles = grid_x.reshape(n_tiles, tile)
    tmin = tiles.min(axis=1)
    tmax = tiles.max(axis=1)
    s = taper_support_z(taper, epsilon) * radius if radius else 0.0
    offs = np.minimum(
        np.searchsorted(obs_x, tmin) - nb,
        np.searchsorted(obs_x, tmin - s, side="right"),
    )
    offs = np.clip(offs, 0, max(o - 1, 0))
    rank_hi = np.searchsorted(obs_x, tmax, side="right")
    end_needed = np.maximum(
        np.clip(rank_hi, 0, max(o - nb, 0)) + nb,
        np.searchsorted(obs_x, tmax + s, side="left"),
    )
    width = int(np.max(end_needed - offs)) if n_tiles else 2 * nb
    width = max(width, 2 * nb)
    return min(o, -(-width // 8) * 8)


def max_in_support_1d(obs_x, grid_x, radius: float, taper: str = "gc2",
                      epsilon: float = 1e-5) -> int:
    """Max per-column count of in-support observations (host-side numpy,
    exact): ``|x - gx| < z* radius`` with ``z* = taper_support_z``. The
    window analysis is exact iff this is <= ``nb``."""
    obs_x = np.sort(np.asarray(obs_x))
    grid_x = np.asarray(grid_x)
    s = taper_support_z(taper, epsilon) * radius
    lo = np.searchsorted(obs_x, grid_x - s, side="right")
    hi = np.searchsorted(obs_x, grid_x + s, side="left")
    return int((hi - lo).max()) if grid_x.size else 0


def _cheb_nodes_dct(degree: int):
    """Chebyshev nodes ``[d+1]`` and the DCT ``[d+1, d+1]`` mapping node
    values to coefficients, computed in f64 and rounded to f32 (the
    constants of the TPU kernel)."""
    j = np.arange(degree + 1)
    nodes = np.cos(np.pi * (j + 0.5) / (degree + 1))
    m = np.arange(degree + 1)[:, None]
    dct = np.cos(np.pi * m * (j[None, :] + 0.5) / (degree + 1))
    dct = dct * (2.0 / (degree + 1))
    dct[0] *= 0.5
    return nodes.astype(np.float32), dct.astype(np.float32)


def _taper_poly(z: torch.Tensor, taper: str, epsilon: float) -> torch.Tensor:
    """Gaspari-Cohn taper of normalized distances ``z = |dx| / radius``,
    sub-epsilon cut to zero (the polynomials of
    :mod:`tpu_assim_torch.ops.localization`)."""
    zero = torch.zeros_like(z)
    if taper == "gc2":
        z_safe = torch.clamp(z, min=0.5)  # keeps the 1/z term finite
        w = torch.where(z < 2.0, GaspariCohn._f2(z_safe), zero)
        w = torch.where(z < 1.0, GaspariCohn._f1(z), w)
    elif taper == "gcinf":
        z_safe = torch.clamp(z, min=0.25)
        w = torch.where(z < 2.0, GaspariCohnInf._f4(z_safe), zero)
        w = torch.where(z < 1.5, GaspariCohnInf._f3(z_safe), w)
        w = torch.where(z < 1.0, GaspariCohnInf._f2(z_safe), w)
        w = torch.where(z < 0.5, GaspariCohnInf._f1(z), w)
    else:
        raise ValueError(f"unknown taper {taper!r}; use 'gc2' or 'gcinf'")
    return torch.where(w > epsilon, w, zero)


def _cheb_solve_apply(nodes, dct_mat, zh, yh, sp, mean, reg, ens_size,
                      degree):
    """Chebyshev/Clenshaw solve and weight application, columns last.

    zh [nb, k, T] scaled window perturbations; yh [nb, T] scaled
    innovations; sp [ns, k, T] state perturbations of ns stacked slices;
    mean [ns, 1, T]; reg a scalar tensor -> analysis [ns, k, T].

    The obs-space part (Gram S, spectral bound, coefficients, q = X^{-1} yh)
    is shared by the ns slices; the 1 + ns operands [yh; u_i = Zh sp_i] run
    through one joint recurrence.
    """
    nb = zh.shape[0]
    ns = sp.shape[0]
    s = torch.einsum("nkt,mkt->nmt", zh, zh)                   # [nb, nb, T]
    # spectral upper bound of X; the 1.05 floor keeps the affine map
    # well-conditioned
    eye = torch.eye(nb, dtype=zh.dtype, device=zh.device)[:, :, None]
    inf_norm = torch.amax(torch.sum(torch.abs(s), dim=1), dim=0)
    trace = torch.sum(s * eye, dim=(0, 1))
    lam_ub = torch.clamp(1.0 + torch.minimum(inf_norm, trace) / reg, min=1.05)

    # coefficients of f1(x) = 1/x and f2(x) = 1/(sqrt(x)(1 + sqrt(x))) on
    # [1, lam_ub], per column, from the values at the mapped nodes; in f32
    # whatever the working dtype, as the JAX twin computes them
    # (preferred_element_type=f32)
    half_w = 0.5 * (lam_ub - 1.0)[None, :]
    x_nodes = (1.0 + half_w) + half_w * nodes.reshape(-1, 1)   # [d+1, T]
    sq = torch.sqrt(x_nodes)
    dct32 = dct_mat.to(torch.float32)
    c1 = (dct32 @ (1.0 / x_nodes).to(torch.float32)).to(zh.dtype)
    c2 = (dct32 @ (1.0 / (sq * (1.0 + sq))).to(torch.float32)).to(zh.dtype)
    c_all = torch.cat([c1[:, None, :], c2[:, None, :].expand(-1, ns, -1)],
                      dim=1)                                   # [d+1, 1+ns, T]

    # normalized operator Xt v = (2/(lam_ub - 1)/reg) S v - v
    a2_sc = (2.0 / (lam_ub - 1.0) / reg)[None, :]

    def xt(vec):                                               # [1+ns, nb, T]
        return a2_sc * torch.einsum("nmt,omt->ont", s, vec) - vec

    u = torch.einsum("nkt,ikt->int", zh, sp)                   # [ns, nb, T]
    w_all = torch.cat([yh[None], u], dim=0)                    # [1+ns, nb, T]
    b1 = torch.zeros_like(w_all)
    b2 = torch.zeros_like(w_all)
    for m_i in range(degree, 0, -1):
        b0 = c_all[m_i][:, None, :] * w_all + 2.0 * xt(b1) - b2
        b2, b1 = b1, b0
    res = c_all[0][:, None, :] * w_all + xt(b1) - b2
    q = res[0]                                                 # X^{-1} yh
    v = res[1:]                                                # f2(X) u

    alpha = torch.sqrt((ens_size - 1.0) / reg)
    mean_upd = torch.sum(u * q[None], dim=1, keepdim=True) / reg
    zv = torch.einsum("nkt,int->ikt", zh, v)                   # [ns, k, T]
    return mean + mean_upd + alpha * sp - (alpha / reg) * zv


def window_analysis_plain(perts, innov, obs_x, grid_x, sp, mean, reg,
                          radius, *, ens_size, nb, degree, epsilon, taper,
                          strict):
    """Plain PyTorch version of the CUDA kernel, in the dtype of its inputs.

    perts [k, o], innov [o], obs_x [o] (sorted), grid_x [g], sp [ns, k, g],
    mean [ns, g], ``reg`` and ``radius`` numbers -> analysis [ns, k, g].

    The window follows the kernel: ``start`` is clipped onto ``[0, o - nb]``
    as ``min(max(., 0), o - nb)``, so with ``o < nb`` it goes negative and
    the slots outside ``[0, o)`` contribute nothing. ``strict`` NaN-poisons
    columns with more than ``nb`` in-support observations (when ``o > nb``);
    unsorted ``obs_x`` poisons the whole output.
    """
    dtype, device = perts.dtype, perts.device
    o = perts.shape[1]
    reg = torch.as_tensor(reg, dtype=dtype, device=device)
    radius = torch.as_tensor(radius, dtype=dtype, device=device)
    sup = torch.as_tensor(taper_support_z(taper, epsilon), dtype=dtype,
                          device=device) * radius
    center = torch.searchsorted(obs_x, grid_x, right=True)
    low = torch.searchsorted(obs_x, grid_x - sup, right=True)
    high = torch.searchsorted(obs_x, grid_x + sup)
    start = torch.minimum(torch.maximum(center - nb // 2, high - nb), low)
    start = torch.clamp(start, min=0, max=o - nb)
    idx = start[:, None] + torch.arange(nb, device=device)[None, :]  # [g, nb]
    valid = (idx >= 0) & (idx < o)
    idx = torch.clamp(idx, 0, o - 1)
    z = torch.abs(obs_x[idx] - grid_x[:, None]) / radius
    w = torch.where(valid, _taper_poly(z, taper, epsilon), 0.0)
    sw = safe_sqrt(w).T                                         # [nb, g]
    zh = perts[:, idx].permute(2, 0, 1) * sw[:, None, :]        # [nb, k, g]
    yh = torch.where(valid, innov[idx], 0.0).T * sw             # [nb, g]
    if strict and o > nb:
        yh = yh + torch.where(high - low > nb, math.nan, 0.0).to(dtype)
    if o > 1:
        sorted_ok = torch.all(obs_x[1:] >= obs_x[:-1])
        mean = mean + torch.where(sorted_ok, 0.0, math.nan).to(dtype)
    nodes, dct = (torch.from_numpy(a).to(dtype=dtype, device=device)
                  for a in _cheb_nodes_dct(degree))
    return _cheb_solve_apply(nodes, dct, zh, yh, sp, mean[:, None, :], reg,
                             ens_size, degree)


@functools.lru_cache(maxsize=None)
def _window1d_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("letkf_window1d")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window1d_launch.argtypes = (
        [ptr] * 10 + [i32] * 6 + [f32] * 4 + [i32, i32, ptr])
    lib.window1d_launch.restype = i32
    lib.window1d_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.window1d_smem_bytes.restype = ctypes.c_size_t
    lib.window1d_error_string.argtypes = [i32]
    lib.window1d_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _cheb_tables(degree: int, device: torch.device):
    nodes, dct = _cheb_nodes_dct(degree)
    return (torch.from_numpy(nodes).to(device),
            torch.from_numpy(dct).to(device))


def _launch_window1d(perts, innov, obs_x, grid_x, sp, mean, reg, radius, nb,
                     degree, epsilon, taper, strict):
    if any(t.requires_grad for t in (perts, innov, obs_x, grid_x, sp, mean)):
        raise NotImplementedError(
            "gradients through the CUDA window kernel are not ported yet "
            "(ROADMAP.md: the autograd.Function of K1)")
    for t in (perts, innov, obs_x, grid_x, sp, mean):
        if not t.is_contiguous():
            raise ValueError("the CUDA window kernel needs contiguous inputs")
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    lib = _window1d_lib()
    k, o = perts.shape
    ns, _, g = sp.shape
    smem = lib.window1d_smem_bytes(k, nb, ns, degree)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"ens_size={k}, nb={nb}, ns={ns}, degree={degree} need {smem} "
            f"bytes of shared memory per block; Hopper has "
            f"{SMEM_PER_BLOCK}")
    device = perts.device
    nodes, dct = _cheb_tables(degree, device)
    out = torch.empty_like(sp)
    flag = torch.empty(1, dtype=torch.int32, device=device)
    # the support bound rounds to f32 as f32(z*) * f32(radius), as on the TPU
    sup = float(np.float32(taper_support_z(taper, epsilon))
                * np.float32(radius))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.window1d_launch(
            perts.data_ptr(), innov.data_ptr(), obs_x.data_ptr(),
            grid_x.data_ptr(), sp.data_ptr(), mean.data_ptr(),
            nodes.data_ptr(), dct.data_ptr(), flag.data_ptr(),
            out.data_ptr(), k, o, g, ns, nb, degree, float(reg),
            float(radius), sup, float(epsilon), _TAPERS.index(taper),
            int(bool(strict)), stream)
    if err != 0:
        raise RuntimeError("window1d kernel launch failed: "
                           + lib.window1d_error_string(err).decode())
    LAUNCHES["window1d"] += 1
    return out


def letkf_window_analysis_fused(
    perts: torch.Tensor,
    innov: torch.Tensor,
    obs_x: torch.Tensor,
    grid_x: torch.Tensor,
    sp: torch.Tensor,
    mean: torch.Tensor,
    reg,
    radius: float,
    ens_size: int,
    nb: int = 16,
    degree: int = 16,
    tile: int = 128,
    epsilon: float = 1e-5,
    obs_block: int = 0,
    taper: str = "gc2",
    strict: bool = True,
) -> torch.Tensor:
    """The complete 1-D-window LETKF analysis: the plain PyTorch version for
    CPU tensors, the CUDA kernel for CUDA tensors.

    Parameters
    ----------
    perts : [k, o] R^{-1/2}-normalized obs-space perturbations.
    innov : [o] normalized innovations.
    obs_x : [o] obs coordinates, sorted ascending (unsorted coordinates
        NaN-poison the whole output).
    grid_x : [g] grid coordinates.
    sp : [k, g] state perturbations, or [ns, k, g] for ns stacked state
        slices sharing the obs-space solve; mean [g] (or [ns, g]).
    reg : number (or scalar tensor) (K-1)/rho; radius : Gaspari-Cohn radius.
    nb : window size. The window is rank-centered, then clamped onto the
        column's in-support range: exact iff no column has more than nb
        nonzero-taper obs. ``strict=True`` NaN-poisons any column violating
        that; ``strict=False`` accepts truncation to the nearest.
    tile, obs_block : accepted for parity with the JAX signature and
        ignored: the CUDA kernel runs one warp per column and binary-searches
        the whole coordinate table, so it has neither grid tiles nor
        per-tile obs blocks.
    taper : ``"gc2"`` (GC(z,1/2,c)) or ``"gcinf"`` (GC(z,inf,c)).

    Every tensor is f32 on one device. Returns the analysis [k, g] (or
    [ns, k, g]).
    """
    del tile, obs_block
    tensors = (perts, innov, obs_x, grid_x, sp, mean)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("letkf_window_analysis_fused takes f32 tensors; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    device = perts.device
    if any(t.device != device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if taper not in _TAPERS:
        raise ValueError(f"unknown taper {taper!r}; use 'gc2' or 'gcinf'")
    multi = sp.ndim == 3
    sp3 = sp if multi else sp[None]
    mean2 = mean if multi else mean[None]
    k, o = perts.shape
    ns, _, g = sp3.shape
    if (k != ens_size or o < 1 or nb < 1 or degree < 1
            or innov.shape != (o,) or obs_x.shape != (o,)
            or grid_x.shape != (g,) or sp3.shape != (ns, k, g)
            or mean2.shape != (ns, g)):
        raise ValueError(
            f"shapes do not fit: perts {tuple(perts.shape)}, innov "
            f"{tuple(innov.shape)}, obs_x {tuple(obs_x.shape)}, grid_x "
            f"{tuple(grid_x.shape)}, sp {tuple(sp.shape)}, mean "
            f"{tuple(mean.shape)}, ens_size {ens_size}, nb {nb}, "
            f"degree {degree}")
    if device.type == "cpu":
        out = window_analysis_plain(
            perts, innov, obs_x, grid_x, sp3, mean2, float(reg), radius,
            ens_size=ens_size, nb=nb, degree=degree, epsilon=epsilon,
            taper=taper, strict=strict)
    elif device.type == "cuda":
        out = _launch_window1d(perts, innov, obs_x, grid_x, sp3, mean2, reg,
                               radius, nb, degree, epsilon, taper, strict)
    else:
        raise ValueError(f"no window kernel for device {device}")
    return out if multi else out[0]
