"""
The LETKF analysis kernels (the port of :mod:`tpu_assim.ops.pallas.letkf`),
each hand-written in CUDA with its plain PyTorch twin, and the numpy host
helpers they share with the JAX package:

- K1, :func:`letkf_window_analysis_fused` (``csrc/letkf_window1d.cu``): the
  whole 1-D window analysis;
- K4, :func:`letkf_nbh_analysis_cheb` (``csrc/letkf_nbh_cheb.cu``): the
  Chebyshev/Clenshaw solve and apply over neighborhoods gathered as
  ``[nb, k, g]``, shared by ``ns`` stacked state slices;
- K1 and K4 take two routes by window size (:func:`window1d_plan`,
  :func:`nbh_cheb_plan`): the Gram matrix in registers with small windows
  packed several columns to a warp (``csrc/cheb_pack.cuh``), or in shared
  memory (``csrc/cheb_core.cuh``);
- K5, :func:`letkf_nbh_analysis_fused` (``csrc/letkf_nbh_ns.cu``): the
  Woodbury solve by Newton-Schulz iterations and apply over neighborhoods
  gathered as ``[g, nb, k]``; two routes by ``nb`` (:func:`nbh_ns_plan`),
  a lane per row with the iterates' rows in registers, or one warp a
  column in shared memory;
- K6, :func:`window2d_banded` (``csrc/letkf_window2d.cu``): the whole 2-D
  window analysis over a y-sorted observation table, behind
  :func:`letkf_window_analysis_fused_2d` and the x-strips of
  :func:`tpu_assim_torch.analysis.make_strip_letkf_2d`; two routes by
  window size (:func:`window2d_plan`), the Gram matrix in registers
  (``csrc/cheb_reg.cuh``) or in shared memory (``csrc/cheb_core.cuh``).

K1 does, per grid column: the window of ``nb`` observations around the
column's rank among the sorted observation coordinates, clamped onto its
in-support range; the Gaspari-Cohn taper with sqrt-weight scaling; then the
Chebyshev/Clenshaw evaluation of ``q = X^{-1} yh`` and ``v = f(X) u`` with
``X = I + Zh Zh^T / reg`` and ``f(x) = 1/(sqrt(x)(1 + sqrt(x)))``, applied as
``mean + <u, q>/reg + alpha sp - (alpha/reg) Zh^T v``. K4 does the last
step alone, on neighborhoods gathered outside it. K6 does K1's work per
128-column tile of a 2-D grid: the x-window runs over the tile's y-band of
observations, and the taper is the product of the per-dimension tapers.

Each wrapper runs its plain version (:func:`window_analysis_plain`,
:func:`nbh_cheb_plain`, :func:`nbh_fused_plain`, :func:`window2d_plain`) for
CPU tensors and launches its kernel for CUDA tensors. A kernel's library is
built at its first launch (:mod:`tpu_assim_torch._build`).
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
    "letkf_nbh_analysis_cheb",
    "letkf_nbh_analysis_fused",
    "letkf_window_analysis_fused",
    "letkf_window_analysis_fused_2d",
    "max_in_support_1d",
    "max_in_support_2d",
    "nbh_cheb_plain",
    "nbh_cheb_plan",
    "nbh_fused_plain",
    "nbh_ns_plan",
    "raise_if_overflow",
    "required_obs_block",
    "required_obs_block_2d",
    "taper_name",
    "window1d_plan",
    "window2d_banded",
    "window2d_inputs",
    "window2d_plain",
    "window2d_plan",
    "window_analysis_plain",
]

# Launches of each CUDA kernel, counted by its wrapper.
LAUNCHES = {"window1d": 0, "nbh_cheb": 0, "nbh_ns": 0, "window2d": 0}

_AUTOGRAD_ITEM = "ROADMAP.md Queue 1, the autograd item"

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


def required_obs_block_2d(obs_y, grid_y, radius_y: float,
                          tile: int = 128) -> int:
    """Exact per-tile obs block width of the 2-D window analysis
    (host-side numpy): the largest population over grid tiles of the tile's
    y-band ``[min(gy) - 2 ry, max(gy) + 2 ry]``, rounded up to a multiple of
    8 and at most the observation count. ``obs_y`` need not be sorted."""
    obs_y = np.sort(np.asarray(obs_y))
    grid_y = np.asarray(grid_y)
    o = obs_y.shape[0]
    g = grid_y.shape[0]
    n_tiles = -(-g // tile)
    pad = n_tiles * tile - g
    if pad:
        grid_y = np.concatenate([grid_y, np.full(pad, grid_y[-1])])
    tiles = grid_y.reshape(n_tiles, tile)
    lo = tiles.min(axis=1) - 2.0 * radius_y
    hi = tiles.max(axis=1) + 2.0 * radius_y
    counts = (np.searchsorted(obs_y, hi, side="right")
              - np.searchsorted(obs_y, lo))
    width = max(int(counts.max()) if n_tiles else 8, 8)
    return min(o, -(-width // 8) * 8)


def max_in_support_2d(obs_xy, grid_xy, radius_x: float, radius_y: float,
                      taper: str = "gc2", epsilon: float = 1e-5,
                      tile: int = 128) -> int:
    """Max per-column count of y-band observations inside the x-cutoff
    (host-side numpy, exact): per grid tile the band is ``[min(gy) - 2 ry,
    max(gy) + 2 ry]``, and each column counts the band's observations with
    ``|dx| < z* rx``. The 2-D window analysis is exact iff this is <=
    ``nb``."""
    obs_xy = np.asarray(obs_xy)
    grid_xy = np.asarray(grid_xy)
    g = grid_xy.shape[0]
    if g == 0 or obs_xy.shape[0] == 0:
        return 0
    order = np.argsort(obs_xy[:, 1], kind="stable")
    oy = obs_xy[order, 1]
    ox = obs_xy[order, 0]
    sx = taper_support_z(taper, epsilon) * radius_x
    n_tiles = -(-g // tile)
    worst = 0
    for t in range(n_tiles):
        gx = grid_xy[t * tile:(t + 1) * tile, 0]
        gy = grid_xy[t * tile:(t + 1) * tile, 1]
        b0 = np.searchsorted(oy, gy.min() - 2.0 * radius_y)
        b1 = np.searchsorted(oy, gy.max() + 2.0 * radius_y, side="right")
        if b1 <= b0:
            continue
        bx = np.sort(ox[b0:b1])
        lo = np.searchsorted(bx, gx - sx, side="right")
        hi = np.searchsorted(bx, gx + sx, side="left")
        worst = max(worst, int((hi - lo).max()))
    return worst


def raise_if_overflow(worst: int, max_obs: int) -> None:
    """Loud failure for the window selection's exactness condition:
    ``worst`` in-support observations in a column (``max_in_support_1d``)
    against ``max_obs`` slots."""
    if worst > max_obs:
        raise ValueError(
            f"a grid column has {worst} in-support (nonzero-taper) "
            f"observations but max_obs={max_obs}: the window selection "
            f"would truncate. Raise max_obs to >= {worst} or pass "
            "max_obs_strict=False to accept truncation to the nearest "
            "observations."
        )


def taper_name(localization) -> str:
    """The window kernel's name of a Gaspari-Cohn localization's taper."""
    return "gcinf" if isinstance(localization, GaspariCohnInf) else "gc2"


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
        [ptr] * 10 + [i32] * 6 + [f32] * 4 + [i32] * 4 + [ptr])
    lib.window1d_launch.restype = i32
    lib.window1d_smem_bytes.argtypes = [i32] * 5
    lib.window1d_smem_bytes.restype = ctypes.c_size_t
    lib.window1d_cols_per_warp.argtypes = [i32]
    lib.window1d_cols_per_warp.restype = i32
    lib.window1d_error_string.argtypes = [i32]
    lib.window1d_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _cheb_tables(degree: int, device: torch.device):
    nodes, dct = _cheb_nodes_dct(degree)
    return (torch.from_numpy(nodes).to(device),
            torch.from_numpy(dct).to(device))


def _check_f32_one_device(name, tensors):
    """f32 tensors on one CPU or CUDA device; returns the device."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes f32 tensors; got "
                        + ", ".join(str(t.dtype) for t in tensors))
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {device}")
    return device


def _check_launchable(name, tensors, smem):
    """The checks of every kernel wrapper before a CUDA launch: no
    gradients, contiguous inputs, and ``smem`` bytes of shared memory (the
    smallest block the launch may take) within a Hopper block's."""
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"gradients through the CUDA kernel {name} are not ported yet "
            f"({_AUTOGRAD_ITEM})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the CUDA kernel {name} needs contiguous inputs")
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"{name}: these shapes need {smem} bytes of shared memory per "
            f"block; a Hopper block has {SMEM_PER_BLOCK}")


# K1's and K4's routes (csrc/letkf_window1d.cu, csrc/letkf_nbh_cheb.cu): the
# register route (csrc/cheb_pack.cuh) holds the Gram matrix in registers for
# windows of up to CHEB_REG_MAX_NB observations, nb rounded up to 4 (nbc) a
# template argument, a column on nbc rounded up to a power of 2 lanes (at
# most 32) and 32 // lanes columns a warp; the shared route
# (csrc/cheb_core.cuh) takes larger windows, one warp a column. Both take up
# to CHEB_MAX_WARPS warps a block.
CHEB_REG_MAX_NB = 64
CHEB_MAX_WARPS = 8


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _cheb_pack_lanes(nbc: int) -> int:
    """Lanes a column owns on the register route: ``nbc`` rounded up to a
    power of 2, at most 32 (cheb_pack.cuh:lanes_per_col)."""
    return next(n for n in (4, 8, 16, 32) if nbc <= n or n == 32)


def _cheb_pack_warp_floats(k: int, nb: int, ns: int, degree: int) -> int:
    """Shared floats of one warp's slice on the register route
    (cheb_pack.cuh:warp_floats): zt, w_all and three Clenshaw buffers, rows
    of the warp's columns side by side, then each column's own block (its
    state and coefficients), lanes mod 32 floats long when packed."""
    nbc = _round4(nb)
    lanes = _cheb_pack_lanes(nbc)
    cols = 32 // lanes
    own = ns * k + ns + 4 * (degree + 1)
    own = (own + 31 - lanes) // 32 * 32 + lanes if cols > 1 else _round4(own)
    return cols * nbc * (k + 4 * (1 + ns)) + cols * own


def _cheb_core_floats(k: int, nb: int, ns: int, degree: int) -> int:
    """Shared floats of one column's workspace on the shared route
    (cheb_core.cuh:workspace_floats)."""
    return _round4(nb * (k | 1) + nb * nb + ns * k + ns
                   + 4 * (1 + ns) * nb + 4 * (degree + 1))


def _cheb_plan(name: str, k: int, nb: int, ns: int, degree: int, g: int,
               shared_floats: int) -> dict:
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    route = "register" if nb <= CHEB_REG_MAX_NB else "shared"
    nbc = _round4(nb) if route == "register" else None
    cols = 32 // _cheb_pack_lanes(nbc) if route == "register" else 1
    per_warp = 4 * (_cheb_pack_warp_floats(k, nb, ns, degree)
                    if route == "register" else shared_floats)
    if per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"{name}: these shapes need {per_warp} bytes of shared memory "
            f"per block; a Hopper block has {SMEM_PER_BLOCK}")
    warps = CHEB_MAX_WARPS
    while warps * per_warp > SMEM_PER_BLOCK:
        warps //= 2
    return {"route": route, "nbc": nbc, "cols_per_warp": cols,
            "warps": warps, "smem": warps * per_warp,
            "blocks": -(-g // (warps * cols))}


def window1d_plan(k: int, nb: int, ns: int, degree: int, g: int) -> dict:
    """K1's launch for ``g`` columns, windows of ``nb`` observations, ``k``
    members, ``ns`` state slices and Chebyshev degree ``degree``: the route
    (``"register"`` up to ``CHEB_REG_MAX_NB``, else ``"shared"``), the
    template argument ``nbc`` (None on the shared route), the columns a
    warp, the warps a block (the most of 8, 4, 2, 1 whose slices fit a
    Hopper block's shared memory), the block's shared memory in bytes and
    the blocks that cover ``g``. Raises ``ValueError`` when not even one
    warp fits."""
    return _cheb_plan("window1d", k, nb, ns, degree, g,
                      _round4(_cheb_core_floats(k, nb, ns, degree) + nb))


def nbh_cheb_plan(k: int, nb: int, ns: int, degree: int, g: int) -> dict:
    """K4's launch, as :func:`window1d_plan` gives K1's."""
    return _cheb_plan("nbh_cheb", k, nb, ns, degree, g,
                      _cheb_core_floats(k, nb, ns, degree))


def _check_plan(name, plan, smem, cols_per_warp):
    """The library's own shared bytes and columns a warp for a plan."""
    if (smem, cols_per_warp) != (plan["smem"], plan["cols_per_warp"]):
        raise RuntimeError(
            f"{name}: the plan {plan} differs from the kernel's {smem} "
            f"bytes and {cols_per_warp} columns a warp")


@functools.lru_cache(maxsize=256)
def _cheb_launch_plan(name: str, k: int, nb: int, ns: int, degree: int,
                      g: int) -> dict:
    """K1's (``name`` "window1d") or K4's ("nbh_cheb") plan, checked once
    per shape against its library's own shared bytes and columns a warp."""
    plan = (window1d_plan if name == "window1d" else nbh_cheb_plan)(
        k, nb, ns, degree, g)
    lib = _window1d_lib() if name == "window1d" else _nbh_cheb_lib()
    _check_plan(name, plan,
                getattr(lib, f"{name}_smem_bytes")(k, nb, ns, degree,
                                                   plan["warps"]),
                getattr(lib, f"{name}_cols_per_warp")(nb))
    return plan


def _launch_window1d(perts, innov, obs_x, grid_x, sp, mean, reg, radius, nb,
                     degree, epsilon, taper, strict):
    lib = _window1d_lib()
    k, o = perts.shape
    ns, _, g = sp.shape
    plan = _cheb_launch_plan("window1d", k, nb, ns, degree, g)
    _check_launchable("window1d", (perts, innov, obs_x, grid_x, sp, mean),
                      plan["smem"])
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
            int(bool(strict)), plan["warps"], plan["blocks"], stream)
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
        ignored: each column of the CUDA kernel binary-searches the whole
        coordinate table, so it has neither grid tiles nor per-tile obs
        blocks (its blocks are :func:`window1d_plan`'s).
    taper : ``"gc2"`` (GC(z,1/2,c)) or ``"gcinf"`` (GC(z,inf,c)).

    Every tensor is f32 on one device. Returns the analysis [k, g] (or
    [ns, k, g]).
    """
    del tile, obs_block
    device = _check_f32_one_device("letkf_window_analysis_fused",
                                   (perts, innov, obs_x, grid_x, sp, mean))
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
    else:
        out = _launch_window1d(perts, innov, obs_x, grid_x, sp3, mean2, reg,
                               radius, nb, degree, epsilon, taper, strict)
    return out if multi else out[0]


# -- K4: the Chebyshev/Clenshaw solve over gathered neighborhoods -------------

def nbh_cheb_plain(zh, yh, sp, mean, reg, ens_size, degree):
    """Plain PyTorch version of K4, in the dtype of its inputs.

    zh [nb, k, g] sqrt-taper-scaled neighborhood perturbations; yh [nb, g]
    scaled innovations; sp [ns, k, g] state perturbations; mean [ns, g];
    ``reg`` a number -> analysis [ns, k, g].
    """
    dtype, device = zh.dtype, zh.device
    nodes, dct = (torch.from_numpy(a).to(dtype=dtype, device=device)
                  for a in _cheb_nodes_dct(degree))
    return _cheb_solve_apply(nodes, dct, zh, yh, sp, mean[:, None, :],
                             torch.as_tensor(reg, dtype=dtype, device=device),
                             ens_size, degree)


@functools.lru_cache(maxsize=None)
def _nbh_cheb_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("letkf_nbh_cheb")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nbh_cheb_launch.argtypes = (
        [ptr] * 7 + [i32] * 5 + [ctypes.c_float, i32, i32, ptr])
    lib.nbh_cheb_launch.restype = i32
    lib.nbh_cheb_smem_bytes.argtypes = [i32] * 5
    lib.nbh_cheb_smem_bytes.restype = ctypes.c_size_t
    lib.nbh_cheb_cols_per_warp.argtypes = [i32]
    lib.nbh_cheb_cols_per_warp.restype = i32
    lib.nbh_cheb_error_string.argtypes = [i32]
    lib.nbh_cheb_error_string.restype = ctypes.c_char_p
    return lib


def _launch_nbh_cheb(zh, yh, sp, mean, reg, degree):
    lib = _nbh_cheb_lib()
    nb, k, g = zh.shape
    ns = sp.shape[0]
    plan = _cheb_launch_plan("nbh_cheb", k, nb, ns, degree, g)
    _check_launchable("nbh_cheb", (zh, yh, sp, mean), plan["smem"])
    device = zh.device
    nodes, dct = _cheb_tables(degree, device)
    out = torch.empty_like(sp)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.nbh_cheb_launch(
            zh.data_ptr(), yh.data_ptr(), sp.data_ptr(), mean.data_ptr(),
            nodes.data_ptr(), dct.data_ptr(), out.data_ptr(), k, g, ns, nb,
            degree, float(reg), plan["warps"], plan["blocks"], stream)
    if err != 0:
        raise RuntimeError("nbh_cheb kernel launch failed: "
                           + lib.nbh_cheb_error_string(err).decode())
    LAUNCHES["nbh_cheb"] += 1
    return out


def letkf_nbh_analysis_cheb(
    zh: torch.Tensor,
    yh: torch.Tensor,
    sp: torch.Tensor,
    mean: torch.Tensor,
    reg,
    ens_size: int,
    degree: int = 16,
    tile: int = 128,
) -> torch.Tensor:
    """The localized ETKF analysis over gathered neighborhoods, Chebyshev
    form: :func:`nbh_cheb_plain` for CPU tensors, kernel K4 for CUDA
    tensors.

    Parameters
    ----------
    zh : [nb, k, g] sqrt(taper-weight)-scaled neighborhood perturbations.
    yh : [nb, g] scaled innovations.
    sp : [k, g] state perturbations, or [ns, k, g] for ns stacked state
        slices sharing one obs-space solve per column; mean [g] (or
        [ns, g]).
    reg : number (or scalar tensor) (K-1)/rho.
    degree : Chebyshev degree.
    tile : accepted for parity with the JAX signature and ignored: the
        kernel's blocks are :func:`nbh_cheb_plan`'s.

    Every tensor is f32 on one device. Returns the analysis [k, g] (or
    [ns, k, g]).
    """
    del tile
    device = _check_f32_one_device("letkf_nbh_analysis_cheb",
                                   (zh, yh, sp, mean))
    multi = sp.ndim == 3
    sp3 = sp if multi else sp[None]
    mean2 = mean if multi else mean[None]
    nb, k, g = zh.shape
    ns = sp3.shape[0]
    if (k != ens_size or nb < 1 or degree < 1 or yh.shape != (nb, g)
            or sp3.shape != (ns, k, g) or mean2.shape != (ns, g)):
        raise ValueError(
            f"shapes do not fit: zh {tuple(zh.shape)}, yh {tuple(yh.shape)}, "
            f"sp {tuple(sp.shape)}, mean {tuple(mean.shape)}, ens_size "
            f"{ens_size}, degree {degree}")
    if device.type == "cpu":
        out = nbh_cheb_plain(zh, yh, sp3, mean2, float(reg), ens_size, degree)
    else:
        out = _launch_nbh_cheb(zh, yh, sp3, mean2, reg, degree)
    return out if multi else out[0]


# -- K5: the Woodbury solve by Newton-Schulz iterations -----------------------

def nbh_fused_plain(zh, yh, sp, mean, reg, ens_size, num_iters):
    """Plain PyTorch version of K5, in the dtype of its inputs: the steps of
    the TPU kernel ``_letkf_kernel``, in its order.

    zh [g, nb, k]; yh [g, nb]; sp [g, k]; mean [g]; ``reg`` a number ->
    analysis [g, k].
    """
    dtype, device = zh.dtype, zh.device
    nb = zh.shape[1]
    reg = torch.as_tensor(reg, dtype=dtype, device=device)
    eye = torch.eye(nb, dtype=dtype, device=device)
    x = eye + zh @ zh.transpose(1, 2) / reg                     # [g, nb, nb]
    # spectrum of X in [1, lam_max]: scale by 2/(1 + lam_max)
    trace = torch.diagonal(x, dim1=1, dim2=2).sum(-1)[:, None, None]
    inf_norm = torch.amax(torch.abs(x).sum(-1), dim=-1)[:, None, None]
    norm = 0.5 * (torch.minimum(trace, inf_norm) + 1.0)
    y, z = x / norm, eye.expand(x.shape)
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    sqrt_norm = torch.sqrt(norm)
    x_sqrt, x_inv_sqrt = y * sqrt_norm, z / sqrt_norm
    x_inv = x_inv_sqrt @ x_inv_sqrt
    # N = (X^{1/2} + I)^{-1} X^{-1/2}, the inverse by Newton-Schulz
    c = x_sqrt + eye
    c_lam_max = torch.amax(torch.abs(c).sum(-1), dim=-1)[:, None, None]
    v = (2.0 / (2.0 + c_lam_max)) * eye
    for _ in range(num_iters):
        v = v + v @ (eye - c @ v)
    n_mat = v @ x_inv_sqrt
    alpha = torch.sqrt((ens_size - 1.0) / reg)
    u = (zh @ sp[:, :, None])[..., 0]                           # [g, nb]
    q = (x_inv @ yh[:, :, None])[..., 0]
    mean_upd = torch.sum(q * u, dim=-1, keepdim=True) / reg
    zv = (zh.transpose(1, 2) @ (n_mat @ u[:, :, None]))[..., 0]  # [g, k]
    return mean[:, None] + mean_upd + (alpha * sp - (alpha / reg) * zv)


@functools.lru_cache(maxsize=None)
def _nbh_ns_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("letkf_nbh_ns")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nbh_ns_launch.argtypes = (
        [ptr] * 5 + [i32] * 4 + [ctypes.c_float, i32, i32, ptr])
    lib.nbh_ns_launch.restype = i32
    lib.nbh_ns_smem_bytes.argtypes = [i32, i32, i32]
    lib.nbh_ns_smem_bytes.restype = ctypes.c_size_t
    lib.nbh_ns_cols_per_warp.argtypes = [i32]
    lib.nbh_ns_cols_per_warp.restype = i32
    lib.nbh_ns_error_string.argtypes = [i32]
    lib.nbh_ns_error_string.restype = ctypes.c_char_p
    return lib


# K5's routes (csrc/letkf_nbh_ns.cu): the register route takes nb up to
# K5_REG_MAX_NB, a lane per row and 32 // nb columns a warp, nb a template
# argument; the shared route one warp a column beyond. Both take up to
# K5_MAX_WARPS warps a block.
K5_REG_MAX_NB = 32
K5_MAX_WARPS = 4


def _k5_col_floats(route: str, k: int, nb: int) -> int:
    """Shared floats of one column's slice on ``route``
    (letkf_nbh_ns.cu:reg_col_floats, smem_col_floats)."""
    if route == "shared":
        return _round4(nb * k + k + 4 * nb + 6 * nb * nb)
    nbp = _round4(nb)
    ld = nbp if (nbp // 4) % 2 else nbp + 4
    floats = k * nbp + _round4(k) + 3 * nbp + 4 * nb * ld
    return floats if floats % 8 else floats + 4


def nbh_ns_plan(k: int, nb: int, g: int) -> dict:
    """K5's launch for ``g`` columns of ``nb`` observations and ``k``
    members: the route, the template argument ``nb_t`` (None on the
    shared route), the columns a warp, the warps a block (the most up to
    ``K5_MAX_WARPS`` whose slices fit a Hopper block's shared memory), the
    block's shared memory in bytes and the blocks that cover ``g``. Raises
    ``ValueError`` when not even one warp fits."""
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    route = "register" if nb <= K5_REG_MAX_NB else "shared"
    cols = 32 // nb if route == "register" else 1
    per_warp = 4 * cols * _k5_col_floats(route, k, nb)
    if per_warp > SMEM_PER_BLOCK:
        raise ValueError(
            f"nbh_ns: these shapes need {per_warp} bytes of shared memory "
            f"per block; a Hopper block has {SMEM_PER_BLOCK}")
    warps = K5_MAX_WARPS
    while warps * per_warp > SMEM_PER_BLOCK:
        warps //= 2
    return {"route": route, "nb_t": nb if route == "register" else None,
            "cols_per_warp": cols, "warps": warps,
            "smem": warps * per_warp, "blocks": -(-g // (warps * cols))}


def _launch_nbh_ns(zh, yh, sp, mean, reg, num_iters):
    lib = _nbh_ns_lib()
    g, nb, k = zh.shape
    plan = nbh_ns_plan(k, nb, g)
    _check_plan("nbh_ns", plan, lib.nbh_ns_smem_bytes(k, nb, plan["warps"]),
                lib.nbh_ns_cols_per_warp(nb))
    _check_launchable("nbh_ns", (zh, yh, sp, mean), plan["smem"])
    out = torch.empty_like(sp)
    with torch.cuda.device(zh.device):
        stream = torch.cuda.current_stream(zh.device).cuda_stream
        err = lib.nbh_ns_launch(
            zh.data_ptr(), yh.data_ptr(), sp.data_ptr(), mean.data_ptr(),
            out.data_ptr(), k, g, nb, num_iters, float(reg), plan["warps"],
            plan["blocks"], stream)
    if err != 0:
        raise RuntimeError("nbh_ns kernel launch failed: "
                           + lib.nbh_ns_error_string(err).decode())
    LAUNCHES["nbh_ns"] += 1
    return out


def letkf_nbh_analysis_fused(
    zh: torch.Tensor,
    yh: torch.Tensor,
    sp: torch.Tensor,
    mean: torch.Tensor,
    reg,
    ens_size: int,
    num_iters: int = 10,
    tile: int = 128,
) -> torch.Tensor:
    """The localized ETKF analysis over gathered neighborhoods, Woodbury
    form by Newton-Schulz iterations: :func:`nbh_fused_plain` for CPU
    tensors, kernel K5 for CUDA tensors.

    Parameters
    ----------
    zh : [g, nb, k] sqrt(taper-weight)-scaled neighborhood perturbations.
    yh : [g, nb] scaled innovations.
    sp : [g, k] state perturbations; mean : [g] state mean.
    reg : number (or scalar tensor) (K-1)/rho.
    num_iters : Newton-Schulz iterations, for the square roots and for the
        inverse each.
    tile : accepted for parity with the JAX signature and ignored: the
        kernel packs columns into warps by ``nb`` (:func:`nbh_ns_plan`).

    Every tensor is f32 on one device. Returns the analysis [g, k].
    """
    del tile
    device = _check_f32_one_device("letkf_nbh_analysis_fused",
                                   (zh, yh, sp, mean))
    g, nb, k = zh.shape
    if (k != ens_size or nb < 1 or num_iters < 0 or yh.shape != (g, nb)
            or sp.shape != (g, k) or mean.shape != (g,)):
        raise ValueError(
            f"shapes do not fit: zh {tuple(zh.shape)}, yh {tuple(yh.shape)}, "
            f"sp {tuple(sp.shape)}, mean {tuple(mean.shape)}, ens_size "
            f"{ens_size}")
    if device.type == "cpu":
        return nbh_fused_plain(zh, yh, sp, mean, float(reg), ens_size,
                               num_iters)
    return _launch_nbh_ns(zh, yh, sp, mean, reg, num_iters)


# -- K6: the 2-D window analysis ----------------------------------------------

# Coordinate sentinel of pad and out-of-band observation slots: sorts after
# every real coordinate and lies outside every taper support.
_BIG = float(np.finfo(np.float32).max)


def window2d_plain(table, bands, grid, sp, mean, scal, *, width, ens_size,
                   nb, degree, epsilon, taper, strict, tile=128,
                   chunk=16384):
    """Plain PyTorch version of K6, in the dtype of its inputs.

    table [n_rows, k + 1 + n_dims]: per observation slot its k normalized
    perturbations, its innovation, then its x, y and extra coordinates
    (slots y-sorted; pad slots carry zeros and +float32.max coordinates).
    bands [3, n_tiles] int: per grid tile of ``tile`` columns the offset
    ``off`` of its slot slice ``[off, off + width)`` and its y-band
    ``[a, b)`` within the slice. grid [n_dims, G], G = n_tiles * tile; sp
    [ns, k, G]; mean [ns, G]; scal [1 + n_dims]: reg, rx, ry, extra radii
    -> analysis [ns, k, G].

    Per tile: the slice's x outside the band becomes +float32.max; the slots
    are ranked by (x, slot); each column's window of ``nb`` ranks starts at
    ``clip(clip(rank - nb//2, high - nb, low), 0, width - nb)`` with rank,
    low and high its counts of x <= gx, x <= gx - z* rx and x < gx + z* rx;
    the taper is the product of the per-dimension tapers, cut at
    ``epsilon``; ``strict`` (with ``width > nb``) NaN-poisons columns whose
    counts differ by more than ``nb``; then the Chebyshev solve and apply.
    Runs ``chunk`` columns at a time, to bound the gathered windows.
    """
    dtype, device = table.dtype, table.device
    k = ens_size
    n_dims = grid.shape[0]
    n_tiles = grid.shape[1] // tile
    reg = scal[0]
    radii = scal[1:]
    sup = torch.as_tensor(taper_support_z(taper, epsilon), dtype=dtype,
                          device=device) * radii[0]
    nodes, dct = (torch.from_numpy(a).to(dtype=dtype, device=device)
                  for a in _cheb_nodes_dct(degree))
    iota = torch.arange(width, device=device)
    slots = torch.arange(nb, device=device)
    per = max(chunk // tile, 1)
    outs = []
    for t0 in range(0, n_tiles, per):
        t1 = min(n_tiles, t0 + per)
        n_t, cols = t1 - t0, slice(t0 * tile, t1 * tile)
        bd = bands[:, t0:t1].long()
        blk = table[bd[0][:, None] + iota]                     # [T, W, rows]
        in_band = (iota >= bd[1][:, None]) & (iota < bd[2][:, None])
        x = torch.where(in_band, blk[..., k + 1], _BIG)
        xs, order = torch.sort(x, dim=1, stable=True)         # rank order
        g = grid[:, cols].reshape(n_dims, n_t, tile)
        center = torch.searchsorted(xs, g[0].contiguous(), right=True)
        low = torch.searchsorted(xs, (g[0] - sup).contiguous(), right=True)
        high = torch.searchsorted(xs, (g[0] + sup).contiguous())
        start = torch.minimum(torch.maximum(center - nb // 2, high - nb), low)
        start = torch.clamp(start, min=0, max=width - nb)
        pos = start[..., None] + slots                        # [T, tile, nb]
        valid = (pos >= 0) & (pos < width)
        pos = pos.clamp(0, width - 1).reshape(n_t, tile * nb)
        slot = torch.gather(order, 1, pos)
        sel = torch.gather(blk, 1, slot[..., None].expand(-1, -1,
                                                          blk.shape[2]))
        sel = sel.reshape(n_t, tile, nb, -1)
        ox = torch.gather(xs, 1, pos).reshape(n_t, tile, nb)
        w = (_taper_poly(torch.abs(ox - g[0][..., None]) / radii[0], taper,
                         0.0)
             * _taper_poly(torch.abs(sel[..., k + 2] - g[1][..., None])
                           / radii[1], taper, 0.0))
        for j in range(n_dims - 2):
            w = w * _taper_poly(torch.abs(sel[..., k + 3 + j]
                                          - g[2 + j][..., None])
                                / radii[2 + j], taper, 0.0)
        w = torch.where(valid & (w > epsilon), w, 0.0)
        n_c = n_t * tile
        sw = safe_sqrt(w).reshape(n_c, nb).T                  # [nb, C]
        zh = sel[..., :k].reshape(n_c, nb, k).permute(1, 2, 0) * sw[:, None]
        yh = torch.where(valid, sel[..., k], 0.0).reshape(n_c, nb).T * sw
        if strict and width > nb:
            yh = yh + torch.where(high - low > nb, math.nan, 0.0).to(
                dtype).reshape(1, n_c)
        outs.append(_cheb_solve_apply(nodes, dct, zh, yh, sp[:, :, cols],
                                      mean[:, None, cols], reg, ens_size,
                                      degree))
    return torch.cat(outs, dim=2)


@functools.lru_cache(maxsize=None)
def _window2d_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("letkf_window2d")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window2d_launch.argtypes = (
        [ptr] * 9 + [i32] * 11 + [f32] * 2 + [i32] * 3 + [ptr])
    lib.window2d_launch.restype = i32
    lib.window2d_smem_bytes.argtypes = [i32] * 7
    lib.window2d_smem_bytes.restype = ctypes.c_size_t
    lib.window2d_error_string.argtypes = [i32]
    lib.window2d_error_string.restype = ctypes.c_char_p
    return lib


# K6's routes (csrc/letkf_window2d.cu): the register route holds the Gram
# matrix in registers for windows of at most K6_REG_MAX_NB observations in
# blocks of K6_REG_WARPS warps; the shared route takes larger windows, up
# to K6_SMEM_MAX_WARPS warps a block.
K6_ROUTES = ("register", "shared")
K6_REG_MAX_NB = 64
K6_REG_WARPS = 4
K6_SMEM_MAX_WARPS = 8
# Blocks that fill the card: 132 SMs, each holding 2-3 of them, several
# waves over, so that the last wave's imbalance is small.
_K6_FILL_BLOCKS = 16 * 132


def _band_bytes(width: int) -> tuple:
    """Shared memory of a tile's sorted band (letkf_window2d.cu:band_bytes,
    key_bytes): the sorted x and slot of each slot, 16-byte aligned; and the
    sort's 64-bit keys over the width rounded up to a power of 2, which the
    warps' workspaces overwrite once the band is sorted."""
    pow2 = 1 << max(width - 1, 0).bit_length()
    return (8 * width + 15) & ~15, 8 * pow2


def _k6_floats_per_warp(route: str, k: int, nb: int, ns: int,
                        degree: int) -> int:
    """Shared floats of one column's workspace on ``route``
    (cheb_reg.cuh:workspace_floats; cheb_core.cuh:workspace_floats plus the
    window's weights and rows)."""
    if route == "register":
        nbc = (nb + 7) & ~7
        return _round4(k * nbc + 4 * (1 + ns) * nbc + ns * k + ns
                       + 4 * (degree + 1))
    return _round4(_cheb_core_floats(k, nb, ns, degree) + 2 * nb)


def window2d_plan(k: int, nb: int, ns: int, degree: int, width: int,
                  n_tiles: int, tile: int = 128) -> dict:
    """K6's launch: the route, the warps a block, the blocks a tile
    (``splits``) and the block's shared memory in bytes.

    Windows of up to ``K6_REG_MAX_NB`` take the register route, larger
    ones the shared route. The warps are the route's most that fit a
    Hopper block's shared memory beside the band. A grid of few tiles
    spreads each tile over up to ``tile / (2 warps)`` blocks (each sorts
    the band itself; every warp keeps at least two columns) until about
    ``16 * 132`` blocks are in flight. Raises ``ValueError`` when not even
    one warp fits."""
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    route = "register" if nb <= K6_REG_MAX_NB else "shared"
    cap = K6_REG_WARPS if route == "register" else K6_SMEM_MAX_WARPS
    band, keys = _band_bytes(width)
    per_warp = 4 * _k6_floats_per_warp(route, k, nb, ns, degree)
    warps = min(cap, tile, (SMEM_PER_BLOCK - band) // per_warp)
    if warps < 1 or band + keys > SMEM_PER_BLOCK:
        raise ValueError(
            f"window2d: these shapes need {band + max(per_warp, keys)} bytes "
            f"of shared memory per block; a Hopper block has "
            f"{SMEM_PER_BLOCK}")
    splits = 1
    while (n_tiles * splits < _K6_FILL_BLOCKS and tile % (2 * splits) == 0
           and tile // (2 * splits) >= 2 * warps):
        splits *= 2
    return {"route": route, "warps": warps, "splits": splits,
            "smem": band + max(warps * per_warp, keys)}


def _launch_window2d(table, bands, grid, sp, mean, scal, width, nb, degree,
                     tile, epsilon, taper, strict):
    lib = _window2d_lib()
    n_rows = table.shape[0]
    n_dims, g = grid.shape
    ns, k, _ = sp.shape
    plan = window2d_plan(k, nb, ns, degree, width, g // tile, tile)
    route = K6_ROUTES.index(plan["route"])
    smem = lib.window2d_smem_bytes(route, k, nb, ns, degree, width,
                                   plan["warps"])
    if smem != plan["smem"]:
        raise RuntimeError(f"window2d: the plan's {plan['smem']} bytes of "
                           f"shared memory differ from the kernel's {smem}")
    _check_launchable("window2d", (table, bands, grid, sp, mean, scal), smem)
    nodes, dct = _cheb_tables(degree, table.device)
    out = torch.empty_like(sp)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.window2d_launch(
            table.data_ptr(), bands.data_ptr(), grid.data_ptr(),
            sp.data_ptr(), mean.data_ptr(), scal.data_ptr(),
            nodes.data_ptr(), dct.data_ptr(), out.data_ptr(), k, n_dims,
            n_rows, g, ns, nb, degree, width, tile, _TAPERS.index(taper),
            int(bool(strict)), taper_support_z(taper, epsilon),
            float(epsilon), route, plan["warps"], plan["splits"], stream)
    if err != 0:
        raise RuntimeError("window2d kernel launch failed: "
                           + lib.window2d_error_string(err).decode())
    LAUNCHES["window2d"] += 1
    return out


def window2d_banded(
    table: torch.Tensor,
    bands: torch.Tensor,
    grid: torch.Tensor,
    sp: torch.Tensor,
    mean: torch.Tensor,
    scal: torch.Tensor,
    *,
    width: int,
    ens_size: int,
    nb: int = 48,
    degree: int = 16,
    tile: int = 128,
    epsilon: float = 1e-5,
    taper: str = "gc2",
    strict: bool = True,
) -> torch.Tensor:
    """The 2-D window analysis over a prepared observation table (the port
    of the JAX package's ``_window2d_dma_call``): :func:`window2d_plain` for
    CPU tensors, kernel K6 for CUDA tensors.

    Parameters
    ----------
    table : [n_rows, k + 1 + n_dims] f32, one row per observation slot: k
        perturbations, innovation, x, y, extra coordinates.
    bands : [3, n_tiles] int32: per tile the slice offset and the band
        ``[a, b)`` within the slice (see :func:`window2d_plain`). K6
        NaN-poisons a tile whose slice leaves the table.
    grid : [n_dims, G] f32 grid coordinates, G = n_tiles * tile.
    sp / mean : [ns, k, G] / [ns, G] f32 state perturbations and mean.
    scal : [1 + n_dims] f32: reg = (k - 1)/rho, then the radii.
    width : slots per slice (the whole table's row count when every tile
        sees every observation).

    Returns the analysis [ns, k, G].
    """
    device = _check_f32_one_device("window2d_banded",
                                   (table, grid, sp, mean, scal))
    if taper not in _TAPERS:
        raise ValueError(f"unknown taper {taper!r}; use 'gc2' or 'gcinf'")
    n_dims, g = grid.shape
    ns = sp.shape[0]
    k = ens_size
    if (n_dims < 2 or g % tile or width < 1 or nb < 1 or degree < 1
            or table.shape[1:] != (k + 1 + n_dims,)
            or bands.shape != (3, g // tile) or bands.device != device
            or bands.dtype != torch.int32 or sp.shape != (ns, k, g)
            or mean.shape != (ns, g) or scal.shape != (1 + n_dims,)):
        raise ValueError(
            f"shapes do not fit: table {tuple(table.shape)}, bands "
            f"{tuple(bands.shape)} {bands.dtype}, grid {tuple(grid.shape)}, "
            f"sp {tuple(sp.shape)}, mean {tuple(mean.shape)}, scal "
            f"{tuple(scal.shape)}, ens_size {k}, width {width}, tile {tile}")
    if device.type == "cpu":
        return window2d_plain(table, bands, grid, sp, mean, scal,
                              width=width, ens_size=k, nb=nb, degree=degree,
                              epsilon=epsilon, taper=taper, strict=strict,
                              tile=tile)
    return _launch_window2d(table, bands, grid, sp, mean, scal, width, nb,
                            degree, tile, epsilon, taper, strict)


def letkf_window_analysis_fused_2d(
    perts: torch.Tensor,
    innov: torch.Tensor,
    obs_xy: torch.Tensor,
    grid_xy: torch.Tensor,
    sp: torch.Tensor,
    mean: torch.Tensor,
    reg,
    radius_x: float,
    radius_y: float,
    ens_size: int,
    obs_block: int,
    nb: int = 48,
    degree: int = 16,
    tile: int = 128,
    epsilon: float = 1e-5,
    taper: str = "gc2",
    strict: bool = True,
    extra_radii: tuple = (),
) -> torch.Tensor:
    """The complete 2-D-window LETKF analysis: the plain PyTorch version for
    CPU tensors, kernel K6 for CUDA tensors (one launch).

    Parameters
    ----------
    perts : [k, o] R^{-1/2}-normalized obs-space perturbations.
    innov : [o] normalized innovations.
    obs_xy : [o, d] obs (x, y, ...) coordinates in any order (sorted by y
        here, stably); d = 2 + len(extra_radii).
    grid_xy : [g, d] grid coordinates; their order affects the work (a
        row-major grid gives thin per-tile y-bands), never the result.
    sp / mean : state perturbations / mean, [k, g] or [ns, k, g] (mean [g]
        or [ns, g]).
    reg : number (or scalar tensor) (K-1)/rho; radius_x / radius_y : the
        per-dimension Gaspari-Cohn radii (the taper is their product).
    obs_block : per-tile y-band width, required
        (:func:`required_obs_block_2d` is exact). With ``obs_block >= o``
        every tile takes the whole table; otherwise a slice of
        ``obs_block + 8`` slots around its band, and a tile whose band holds
        more than ``obs_block`` observations is NaN-poisoned.
    nb : x-window size inside the band; exact iff no column has more than
        nb band observations within its x-cutoff (``max_in_support_2d``).
        ``strict=True`` NaN-poisons any column violating that;
        ``strict=False`` accepts the truncation to the x-nearest.
    extra_radii : radii of coordinate dims >= 3: product taper factors
        only; the band and window stay on (y, x).

    perts, innov, sp and mean are f32 on one device; the coordinates may be
    f32 or f64 (sorted in their own precision, then rounded to f32). The
    JAX signature's ``sel_prec`` and ``interpret`` select TPU code paths
    and have no counterpart. Returns the analysis [k, g] (or [ns, k, g]).
    """
    n_dims = 2 + len(extra_radii)
    if obs_xy.shape[1] < n_dims or grid_xy.shape[1] < n_dims:
        raise ValueError(
            f"need {n_dims} coordinate columns for 2 windowed + "
            f"{len(extra_radii)} extra taper dims; got obs "
            f"{tuple(obs_xy.shape)}, grid {tuple(grid_xy.shape)}")
    if obs_block <= 0:
        raise ValueError(
            "obs_block is required for the 2-D window analysis; compute it "
            "with required_obs_block_2d(obs_y, grid_y, radius_y, tile)")
    device = _check_f32_one_device("letkf_window_analysis_fused_2d",
                                   (perts, innov, sp, mean))
    if obs_xy.device != device or grid_xy.device != device:
        raise ValueError("all inputs must be on one device")
    multi = sp.ndim == 3
    sp3 = sp if multi else sp[None]
    mean2 = mean if multi else mean[None]
    k, o = perts.shape
    ns, _, g = sp3.shape
    if (k != ens_size or o < 1 or innov.shape != (o,)
            or obs_xy.shape[0] != o or grid_xy.shape[0] != g
            or sp3.shape != (ns, k, g) or mean2.shape != (ns, g)):
        raise ValueError(
            f"shapes do not fit: perts {tuple(perts.shape)}, innov "
            f"{tuple(innov.shape)}, obs_xy {tuple(obs_xy.shape)}, grid_xy "
            f"{tuple(grid_xy.shape)}, sp {tuple(sp.shape)}, mean "
            f"{tuple(mean.shape)}, ens_size {ens_size}")
    args, width = window2d_inputs(perts, innov, obs_xy, grid_xy, sp3, mean2,
                                  reg, radius_x, radius_y, obs_block, tile,
                                  extra_radii)
    out = window2d_banded(*args, width=width, ens_size=k, nb=nb,
                          degree=degree, tile=tile, epsilon=epsilon,
                          taper=taper, strict=strict)[:, :, :g]
    return out if multi else out[0]


def window2d_inputs(perts, innov, obs_xy, grid_xy, sp, mean, reg, radius_x,
                    radius_y, obs_block, tile=128, extra_radii=()):
    """The prologue of :func:`letkf_window_analysis_fused_2d`: the stable
    y-sort of the observations, the grid padded to whole tiles (edge
    coordinates, zero state), the table, each tile's slice and band, and
    the band-overflow NaN poison of the mean.

    ``sp [ns, k, g]``, ``mean [ns, g]``; the rest as the wrapper takes
    them. Returns ``((table, bands, grid, sp, mean, scal), width)``: the
    inputs of :func:`window2d_banded` (and :func:`window2d_plain`) and the
    slice width.
    """
    f32 = torch.float32
    device = perts.device
    k, o = perts.shape
    g = grid_xy.shape[0]
    n_dims = 2 + len(extra_radii)
    sp3, mean2 = sp, mean
    n_tiles = -(-g // tile)
    pad = n_tiles * tile - g
    if pad:
        grid_xy = torch.cat([grid_xy, grid_xy[-1:].expand(pad, -1)])
        sp3 = torch.nn.functional.pad(sp3, (0, pad))
        mean2 = torch.nn.functional.pad(mean2, (0, pad))
    order = torch.sort(obs_xy[:, 1], stable=True).indices
    coords = obs_xy[order, :n_dims].to(f32)                    # [o, d]
    gy = grid_xy[:, 1].to(f32)
    grid = grid_xy[:, :n_dims].to(f32).T.contiguous()          # [d, G]
    table = torch.cat([perts[:, order].T, innov[order, None], coords], dim=1)
    o_b = min(obs_block, o)
    if o_b >= o:
        # every tile takes the whole table, unmasked
        width = o
        bands = torch.tensor([0, 0, o], dtype=torch.int32,
                             device=device)[:, None].expand(3, n_tiles)
    else:
        ty = gy.reshape(n_tiles, tile)
        oy = coords[:, 1].contiguous()
        iy0 = torch.clamp(torch.searchsorted(
            oy, (ty.amin(dim=1) - 2.0 * radius_y).contiguous()), 0, o - 1)
        iy1 = torch.searchsorted(
            oy, (ty.amax(dim=1) + 2.0 * radius_y).contiguous(), right=True)
        # a band with more observations than the block would lose some:
        # NaN-poison its tile
        bad_tile = (iy1 - iy0) > o_b
        mean2 = mean2 + torch.where(bad_tile, math.nan, 0.0).to(
            f32).repeat_interleave(tile)[None, :]
        # the slices: o_b + 8 slots from an 8-aligned offset below the band
        # start (the offsets of the JAX package, which decide the slice
        # width and so the window clamp); pad slots past the table's end
        width = o_b + 8
        o_pad = -(-o // 8) * 8
        off = torch.clamp(iy0, max=max(o_pad - width, 0))
        off = off - off % 8
        bands = torch.stack([off, iy0 - off,
                             torch.clamp(iy1 - off, 0, width)]).to(torch.int32)
        n_rows = max(o_pad, width)
        pad_rows = torch.zeros(n_rows - o, table.shape[1], dtype=f32,
                               device=device)
        pad_rows[:, k + 1:] = _BIG
        table = torch.cat([table, pad_rows])
    scal = torch.cat([
        torch.as_tensor(reg, dtype=f32, device=device).reshape(1),
        torch.tensor((radius_x, radius_y) + tuple(extra_radii), dtype=f32,
                     device=device)])
    return ((table.contiguous(), bands.contiguous(), grid, sp3.contiguous(),
             mean2.contiguous(), scal), width)
