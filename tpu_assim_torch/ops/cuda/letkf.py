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
  memory (``csrc/cheb_core.cuh``); up to windows of ``CHEB_UNION_MAX_NB``,
  K1 takes a third, its union route, which stages the union of a block's
  windows once, and counts the blocks that took it in
  ``WINDOW1D_UNION_BLOCKS``;
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
  (``csrc/cheb_reg.cuh``) or in shared memory (``csrc/cheb_core.cuh``);
  the register route solves each column at the width of its observations
  of nonzero weight, and counts the columns at each width
  (:func:`window2d_width_counts`); where the plan finds room, its blocks
  stage their tile's slice of the observation table in shared memory once
  for all their columns (:func:`window2d_staged_share`).

Each kernel's launch plan is Python arithmetic that mirrors its source's
shared-memory layout, so that the CPU tests check every shape; it is
checked against the library's own bytes once per shape
(:func:`_launch_plan`).

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

K1, K4 and K6 are differentiable, as the JAX package's custom VJPs are:
when grad mode is on and an input requires a gradient, the wrapper calls
its ``torch.autograd.Function`` (:class:`_Window1D`, :class:`_NbhCheb`,
:class:`_Window2D`), whose forward dispatches as the wrapper does and whose
backward replays the plain version with autograd and pulls the cotangent
back through it. K5 has no VJP in the JAX package either, and its kernel
raises on a gradient.
"""

import ctypes
import functools
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from tpu_assim_torch.ops.localization import (
    GaspariCohn,
    GaspariCohnInf,
    safe_sqrt,
    taper_support_z,
)
from tpu_assim_torch.utils.profiling import span

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
    "window2d_staged_share",
    "window2d_width_counts",
    "window_analysis_plain",
]

# Launches of each CUDA kernel, counted by its wrapper.
LAUNCHES = {"window1d": 0, "nbh_cheb": 0, "nbh_ns": 0, "window2d": 0}

# K1's last launch: its two ints of scratch on the card (the sortedness
# flag, then the count of blocks that took the union route) and its block
# count. Nothing reads the tensor during a call; window1d_union_share does,
# with a synchronise.
WINDOW1D_UNION_BLOCKS = {"flag": None, "blocks": 0}

# K6's last launch: its int32[9] on the card, the columns its register
# route solved at each width of K6_WIDTHS, then the blocks that staged
# their slice; and its block count. Nothing reads the tensor during a
# call; window2d_width_counts and window2d_staged_share do, with a
# synchronise.
WINDOW2D_WIDTHS = {"counts": None, "blocks": 0}

# Why a direct launch refuses an input that requires a gradient.
_NO_GRAD_LAUNCH = {
    "window1d": "call letkf_window_analysis_fused, whose autograd.Function "
                "launches on detached inputs",
    "nbh_cheb": "call letkf_nbh_analysis_cheb, whose autograd.Function "
                "launches on detached inputs",
    "window2d": "call window2d_banded, whose autograd.Function launches on "
                "detached inputs",
    "nbh_ns": "K5 has no VJP, as the JAX package's letkf_nbh_analysis_fused "
              "has none; method='cheb' (K4) is the differentiable "
              "neighborhood solve",
}

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
    # each branch's argument clamped into its segment's reach: the 1/z term
    # stays finite at z ~ 0, and the powers at the +float32.max coordinates
    # of pad slots, so that no inf meets a zero cotangent in the backward
    if taper == "gc2":
        z_safe = torch.clamp(z, min=0.5, max=2.0)
        w = torch.where(z < 2.0, GaspariCohn._f2(z_safe), zero)
        w = torch.where(z < 1.0, GaspariCohn._f1(torch.clamp(z, max=1.0)),
                        w)
    elif taper == "gcinf":
        z_safe = torch.clamp(z, min=0.25, max=2.0)
        w = torch.where(z < 2.0, GaspariCohnInf._f4(z_safe), zero)
        w = torch.where(z < 1.5, GaspariCohnInf._f3(z_safe), w)
        w = torch.where(z < 1.0, GaspariCohnInf._f2(z_safe), w)
        w = torch.where(z < 0.5,
                        GaspariCohnInf._f1(torch.clamp(z, max=0.5)), w)
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
    # (preferred_element_type=f32), and kept in f32: the Clenshaw products
    # promote them, so that their cotangents also round to f32 as the
    # twin's do
    half_w = 0.5 * (lam_ub - 1.0)[None, :]
    x_nodes = (1.0 + half_w) + half_w * nodes.reshape(-1, 1)   # [d+1, T]
    sq = torch.sqrt(x_nodes)
    dct32 = dct_mat.to(torch.float32)
    c1 = dct32 @ (1.0 / x_nodes).to(torch.float32)
    c2 = dct32 @ (1.0 / (sq * (1.0 + sq))).to(torch.float32)
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


def _window_starts(obs_x, grid_x, sup, nb):
    """Each grid column's first window observation, as the kernel's
    find_window selects it (``start`` clipped onto ``[0, o - nb]`` as
    ``min(max(., 0), o - nb)``), and the column's in-support count ``high -
    low``; ``sup`` is the taper's support in coordinate units."""
    center = torch.searchsorted(obs_x, grid_x, right=True)
    low = torch.searchsorted(obs_x, grid_x - sup, right=True)
    high = torch.searchsorted(obs_x, grid_x + sup)
    start = torch.minimum(torch.maximum(center - nb // 2, high - nb), low)
    return torch.clamp(start, min=0, max=obs_x.shape[0] - nb), high - low


def window_analysis_plain(perts, innov, obs_x, grid_x, sp, mean, reg,
                          radius, *, ens_size, nb, degree, epsilon, taper,
                          strict):
    """Plain PyTorch version of the CUDA kernel, in the dtype of its inputs.

    perts [k, o], innov [o], obs_x [o] (sorted), grid_x [g], sp [ns, k, g],
    mean [ns, g], ``reg`` a number or a 0-d tensor (its graph kept),
    ``radius`` a number -> analysis [ns, k, g].

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
    start, in_support = _window_starts(obs_x, grid_x, sup, nb)
    idx = start[:, None] + torch.arange(nb, device=device)[None, :]  # [g, nb]
    valid = (idx >= 0) & (idx < o)
    idx = torch.clamp(idx, 0, o - 1)
    z = torch.abs(obs_x[idx] - grid_x[:, None]) / radius
    w = torch.where(valid, _taper_poly(z, taper, epsilon), 0.0)
    sw = safe_sqrt(w).T                                         # [nb, g]
    zh = perts[:, idx].permute(2, 0, 1) * sw[:, None, :]        # [nb, k, g]
    yh = torch.where(valid, innov[idx], 0.0).T * sw             # [nb, g]
    if strict and o > nb:
        yh = yh + torch.where(in_support > nb, math.nan, 0.0).to(dtype)
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
        [ptr] * 10 + [i32] * 6 + [f32] * 4 + [i32] * 5 + [ptr])
    lib.window1d_launch.restype = i32
    lib.window1d_union_slots.argtypes = [i32]
    lib.window1d_union_slots.restype = i32
    lib.window1d_smem_bytes.argtypes = [i32] * 6
    lib.window1d_smem_bytes.restype = ctypes.c_size_t
    lib.window1d_cols_per_warp.argtypes = [i32] * 2
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
    """The checks of every kernel wrapper before a CUDA launch: no input
    that requires a gradient (a launch records no graph), contiguous
    inputs, and ``smem`` bytes of shared memory (the smallest block the
    launch may take) within a Hopper block's."""
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the CUDA kernel {name} records no graph for its inputs that "
            f"require a gradient: {_NO_GRAD_LAUNCH[name]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"the CUDA kernel {name} needs contiguous inputs")
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"{name}: these shapes need {smem} bytes of shared memory per "
            f"block; a Hopper block has {SMEM_PER_BLOCK}")


def _records_graph(*values) -> bool:
    """Whether a call must record a graph: grad mode is on and one of
    ``values`` is a tensor that requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)


def _reg_tensor(reg, like: torch.Tensor) -> torch.Tensor:
    """``reg`` (a number or a tensor of one element) as a 0-d tensor of
    ``like``'s dtype and device, its graph kept."""
    return torch.as_tensor(reg, dtype=like.dtype,
                           device=like.device).reshape(())


def _pullback(ctx, replay, grad):
    """The backward of the kernels' Functions: ``replay`` (the plain
    version) run with autograd on the saved inputs, and the cotangent
    ``grad`` pulled back through it. Returns a gradient for each saved
    input that ``ctx.needs_input_grad`` asks for, None for the others."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = replay(*inputs)
        wanted = [x for x, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, grad,
                                         allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)


# K1's and K4's routes (csrc/letkf_window1d.cu, csrc/letkf_nbh_cheb.cu): the
# register route (csrc/cheb_pack.cuh) holds the Gram matrix in registers for
# windows of up to CHEB_REG_MAX_NB observations (K1's from 33, below its
# union route), nb rounded up to 4 (nbc) a template argument, a column on
# nbc rounded up to a power of 2 lanes (at most 32) and 32 // lanes columns
# a warp; the shared route (csrc/cheb_core.cuh) takes larger windows, one
# warp a column. Both take up to CHEB_MAX_WARPS warps a block.
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
               shared_floats: int, register: bool) -> dict:
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    route = "register" if register else "shared"
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


# K1's union route (csrc/letkf_window1d.cu): up to CHEB_UNION_MAX_NB a
# block stages the raw perturbations of union_slots(nbc) consecutive
# observations, its windows' union, and their Gram matrix once, row stride
# union_slots + 1, beside the warps' slices, which hold the Clenshaw rows,
# the sqrt weights and the columns' own blocks but no per-column window.
CHEB_UNION_MAX_NB = 32

# A Hopper SM's shared memory (228 KB), the part the runtime reserves a
# block, and its most resident blocks and warps.
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
MAX_BLOCKS_PER_SM = 32
MAX_WARPS_PER_SM = 64


def _union_slots(nbc: int) -> int:
    """Window slots a block stages on K1's union route
    (letkf_window1d.cu:union_slots): nbc + 8."""
    return nbc + 8


def _union_warp_floats(k: int, nbc: int, ns: int, degree: int) -> int:
    """Shared floats of one warp's slice on the union route: the register
    route's slice with a row of sqrt taper weights in place of its
    per-column window rows zt."""
    return _cheb_pack_warp_floats(k, nbc, ns, degree) - (
        32 // _cheb_pack_lanes(nbc)) * nbc * (k - 1)


def _union_block_floats(k: int, nbc: int) -> int:
    """Shared floats of the union route's block part: the staged union
    [k][U + 1], its Gram matrix [U][U + 1], the warps' window bounds."""
    u = _union_slots(nbc)
    return (k + u) * (u + 1) + 2 * CHEB_MAX_WARPS


def _union_launch_blocks(nbc: int) -> int:
    """Blocks of CHEB_MAX_WARPS warps an SM whose registers K1's union
    kernel is built for (its __launch_bounds__): 5 up to nbc 8, 4 up to 16
    (48 registers spill there), 2 above."""
    return 5 if nbc <= 8 else 4 if nbc <= 16 else 2


def _blocks_per_sm(warps: int, smem: int, reg_blocks: int) -> int:
    """Blocks of ``warps`` warps and ``smem`` bytes of shared memory that
    an SM holds, with registers for ``reg_blocks`` blocks of
    CHEB_MAX_WARPS warps."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK),
               MAX_BLOCKS_PER_SM, MAX_WARPS_PER_SM // warps,
               reg_blocks * CHEB_MAX_WARPS // warps)


def window1d_plan(k: int, nb: int, ns: int, degree: int, g: int) -> dict:
    """K1's launch for ``g`` columns, windows of ``nb`` observations, ``k``
    members, ``ns`` state slices and Chebyshev degree ``degree``: the route
    (``"register"`` for the union route up to ``CHEB_UNION_MAX_NB`` and the
    register route up to ``CHEB_REG_MAX_NB``, else ``"shared"``), the
    template argument ``nbc`` (None on the shared route), the columns a
    warp, the warps a block, the block's shared memory in bytes, the blocks
    that cover ``g``, ``union`` (the window slots a block stages on the
    union route, 0 off it) and ``blocks_per_sm`` (the blocks an SM holds).

    Up to ``CHEB_UNION_MAX_NB`` the union route is taken wherever its block
    fits, with the warps a block of 8, 4, 2, 1 that an SM holds the most of
    (the larger block on a tie), and the shared route where it does not (k
    above about 1300). The register and shared routes take the most of 8,
    4, 2, 1 warps whose slices fit a Hopper block's shared memory. Raises
    ``ValueError`` when not even one warp fits."""
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    nbc = _round4(nb)
    best = None
    if nb <= CHEB_UNION_MAX_NB:
        per_warp = _union_warp_floats(k, nbc, ns, degree)
        for warps in (8, 4, 2, 1):
            smem = 4 * (warps * per_warp + _union_block_floats(k, nbc))
            if smem > SMEM_PER_BLOCK:
                continue
            held = warps * _blocks_per_sm(warps, smem,
                                         _union_launch_blocks(nbc))
            if best is None or held > best[0]:
                best = (held, warps, smem)
    if best is not None:
        held, warps, smem = best
        cols = 32 // _cheb_pack_lanes(nbc)
        return {"route": "register", "nbc": nbc, "cols_per_warp": cols,
                "warps": warps, "smem": smem,
                "blocks": -(-g // (warps * cols)),
                "union": _union_slots(nbc), "blocks_per_sm": held // warps}
    plan = _cheb_plan("window1d", k, nb, ns, degree, g,
                      _round4(_cheb_core_floats(k, nb, ns, degree) + nb),
                      CHEB_UNION_MAX_NB < nb <= CHEB_REG_MAX_NB)
    plan["union"] = 0
    plan["blocks_per_sm"] = _blocks_per_sm(plan["warps"], plan["smem"], 1)
    return plan


def nbh_cheb_plan(k: int, nb: int, ns: int, degree: int, g: int) -> dict:
    """K4's launch for ``g`` columns, windows of ``nb``, ``k`` members,
    ``ns`` state slices and Chebyshev degree ``degree``: the route
    (``"register"`` up to ``CHEB_REG_MAX_NB``, else ``"shared"``), the
    template argument ``nbc`` (None on the shared route), the columns a
    warp, the most warps a block of 8, 4, 2, 1 whose slices fit a Hopper
    block's shared memory, the block's shared memory in bytes and the
    blocks that cover ``g``. Raises ``ValueError`` when not even one warp
    fits."""
    return _cheb_plan("nbh_cheb", k, nb, ns, degree, g,
                      _cheb_core_floats(k, nb, ns, degree),
                      nb <= CHEB_REG_MAX_NB)


@functools.lru_cache(maxsize=256)
def _launch_plan(name: str, *shape) -> dict:
    """The plan of K1 (``name`` "window1d"), K4 ("nbh_cheb"), K5
    ("nbh_ns") or K6 ("window2d") for ``shape``, its plan function's
    arguments, checked once per shape against its library's own layout:
    the block's shared bytes, and the columns a warp and K1's union slots
    where the kernel has them."""
    if name == "window1d":
        plan = window1d_plan(*shape)
        k, nb, ns, degree, _ = shape
        lib = _window1d_lib()
        slots = lib.window1d_union_slots(nb) if plan["union"] else 0
        ours = (plan["smem"], plan["cols_per_warp"], plan["union"])
        theirs = (lib.window1d_smem_bytes(k, nb, ns, degree, plan["warps"],
                                          slots),
                  lib.window1d_cols_per_warp(nb, slots), slots)
    elif name == "nbh_cheb":
        plan = nbh_cheb_plan(*shape)
        k, nb, ns, degree, _ = shape
        lib = _nbh_cheb_lib()
        ours = (plan["smem"], plan["cols_per_warp"])
        theirs = (lib.nbh_cheb_smem_bytes(k, nb, ns, degree, plan["warps"]),
                  lib.nbh_cheb_cols_per_warp(nb))
    elif name == "nbh_ns":
        plan = nbh_ns_plan(*shape)
        k, nb, _ = shape
        lib = _nbh_ns_lib()
        ours = (plan["smem"], plan["cols_per_warp"])
        theirs = (lib.nbh_ns_smem_bytes(k, nb, plan["warps"]),
                  lib.nbh_ns_cols_per_warp(nb))
    else:
        plan = window2d_plan(*shape)
        k, nb, ns, degree, width, _, _, n_dims = shape
        ours = (plan["smem"],)
        theirs = (_window2d_lib().window2d_smem_bytes(
            K6_ROUTES.index(plan["route"]), k, nb, ns, degree, width,
            plan["warps"], n_dims, int(plan["staged"])),)
    if ours != theirs:
        raise RuntimeError(
            f"{name}: the plan {plan} differs from the kernel's layout "
            f"{theirs} (shared bytes, columns a warp, union slots)")
    return plan


def _launch_window1d(perts, innov, obs_x, grid_x, sp, mean, reg, radius, nb,
                     degree, epsilon, taper, strict):
    lib = _window1d_lib()
    k, o = perts.shape
    ns, _, g = sp.shape
    plan = _launch_plan("window1d", k, nb, ns, degree, g)
    _check_launchable("window1d", (perts, innov, obs_x, grid_x, sp, mean),
                      plan["smem"])
    device = perts.device
    nodes, dct = _cheb_tables(degree, device)
    out = torch.empty_like(sp)
    flag = torch.empty(2, dtype=torch.int32, device=device)
    # the support bound rounds to f32 as f32(z*) * f32(radius), as on the TPU
    sup = float(np.float32(taper_support_z(taper, epsilon))
                * np.float32(radius))
    with span("kernel.window1d"), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.window1d_launch(
            perts.data_ptr(), innov.data_ptr(), obs_x.data_ptr(),
            grid_x.data_ptr(), sp.data_ptr(), mean.data_ptr(),
            nodes.data_ptr(), dct.data_ptr(), flag.data_ptr(),
            out.data_ptr(), k, o, g, ns, nb, degree, float(reg),
            float(radius), sup, float(epsilon), _TAPERS.index(taper),
            int(bool(strict)), plan["warps"], plan["blocks"], plan["union"],
            stream)
    if err != 0:
        raise RuntimeError("window1d kernel launch failed: "
                           + lib.window1d_error_string(err).decode())
    LAUNCHES["window1d"] += 1
    WINDOW1D_UNION_BLOCKS.update(flag=flag, blocks=plan["blocks"])
    return out


def window1d_union_share():
    """The share of K1's last launch's blocks that took the union route
    (0.0 where none did), read from the card with a synchronise; None
    before any launch."""
    flag = WINDOW1D_UNION_BLOCKS["flag"]
    if flag is None:
        return None
    return int(flag[1].item()) / WINDOW1D_UNION_BLOCKS["blocks"]


def _window1d_forward(perts, innov, obs_x, grid_x, sp, mean, reg, radius,
                      ens_size, nb, degree, epsilon, taper, strict):
    """K1's dispatch: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if perts.device.type == "cpu":
        return window_analysis_plain(
            perts, innov, obs_x, grid_x, sp, mean, reg, radius,
            ens_size=ens_size, nb=nb, degree=degree, epsilon=epsilon,
            taper=taper, strict=strict)
    return _launch_window1d(perts, innov, obs_x, grid_x, sp, mean, reg,
                            radius, nb, degree, epsilon, taper, strict)


class _Window1D(torch.autograd.Function):
    """K1 with a VJP (the port of ``_window_call``,
    ``tpu_assim/ops/pallas/letkf.py:1279-1310``).

    The forward dispatches as :func:`letkf_window_analysis_fused` does, on
    detached inputs. The backward replays :func:`window_analysis_plain` on
    the saved inputs and pulls the cotangent back through it, as JAX's
    replays ``_window_analysis_ref``: gradients in ``perts``, ``innov``,
    ``obs_x`` and ``grid_x`` (through the taper; the window is piecewise
    constant), ``sp``, ``mean`` and ``reg``. The replay runs with
    ``strict=False``: JAX's reference has no strict poison, so a poisoned
    column's NaN reaches a loss through the forward alone. It keeps the
    kernel's window, each observation counted once, also where ``o < nb``
    and JAX's reference clamps its gather (ROADMAP Queue 3)."""

    @staticmethod
    def forward(ctx, perts, innov, obs_x, grid_x, sp, mean, reg, radius,
                ens_size, nb, degree, epsilon, taper, strict):
        ctx.save_for_backward(perts, innov, obs_x, grid_x, sp, mean, reg)
        ctx.statics = dict(radius=radius, ens_size=ens_size, nb=nb,
                           degree=degree, epsilon=epsilon, taper=taper)
        return _window1d_forward(
            *(t.detach() for t in (perts, innov, obs_x, grid_x, sp, mean,
                                   reg)),
            radius, ens_size, nb, degree, epsilon, taper, strict)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        st = ctx.statics

        def replay(perts, innov, obs_x, grid_x, sp, mean, reg):
            return window_analysis_plain(
                perts, innov, obs_x, grid_x, sp, mean, reg, st["radius"],
                ens_size=st["ens_size"], nb=st["nb"], degree=st["degree"],
                epsilon=st["epsilon"], taper=st["taper"], strict=False)

        return _pullback(ctx, replay, grad) + (None,) * 7


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
    [ns, k, g]). Differentiable in every tensor and in ``reg`` through
    :class:`_Window1D` when grad mode is on and one of them requires a
    gradient.
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
    args = (perts, innov, obs_x, grid_x, sp3, mean2)
    statics = (radius, ens_size, nb, degree, epsilon, taper, strict)
    if _records_graph(*args, reg):
        out = _Window1D.apply(*args, _reg_tensor(reg, perts), *statics)
    else:
        out = _window1d_forward(*args, reg, *statics)
    return out if multi else out[0]


# -- K4: the Chebyshev/Clenshaw solve over gathered neighborhoods -------------

def nbh_cheb_plain(zh, yh, sp, mean, reg, ens_size, degree):
    """Plain PyTorch version of K4, in the dtype of its inputs.

    zh [nb, k, g] sqrt-taper-scaled neighborhood perturbations; yh [nb, g]
    scaled innovations; sp [ns, k, g] state perturbations; mean [ns, g];
    ``reg`` a number or a 0-d tensor (its graph kept) -> analysis
    [ns, k, g].
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
    plan = _launch_plan("nbh_cheb", k, nb, ns, degree, g)
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


def _nbh_cheb_forward(zh, yh, sp, mean, reg, ens_size, degree):
    """K4's dispatch: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if zh.device.type == "cpu":
        return nbh_cheb_plain(zh, yh, sp, mean, reg, ens_size, degree)
    return _launch_nbh_cheb(zh, yh, sp, mean, reg, degree)


class _NbhCheb(torch.autograd.Function):
    """K4 with a VJP (the port of ``_cheb_call``,
    ``tpu_assim/ops/pallas/letkf.py:627-661``): the forward dispatches as
    :func:`letkf_nbh_analysis_cheb` does, on detached inputs; the backward
    replays :func:`nbh_cheb_plain` on the saved inputs and pulls the
    cotangent back through it, as JAX's replays ``_cheb_solve_apply``:
    gradients in ``zh``, ``yh``, ``sp``, ``mean`` and ``reg``, the exact
    gradient of the degree-``degree`` Chebyshev approximation that the
    forward computes."""

    @staticmethod
    def forward(ctx, zh, yh, sp, mean, reg, ens_size, degree):
        ctx.save_for_backward(zh, yh, sp, mean, reg)
        ctx.statics = (ens_size, degree)
        return _nbh_cheb_forward(
            *(t.detach() for t in (zh, yh, sp, mean, reg)), ens_size, degree)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        ens_size, degree = ctx.statics

        def replay(zh, yh, sp, mean, reg):
            return nbh_cheb_plain(zh, yh, sp, mean, reg, ens_size, degree)

        return _pullback(ctx, replay, grad) + (None, None)


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
    [ns, k, g]). Differentiable in every tensor and in ``reg`` through
    :class:`_NbhCheb` when grad mode is on and one of them requires a
    gradient.
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
    args = (zh, yh, sp3, mean2)
    if _records_graph(*args, reg):
        out = _NbhCheb.apply(*args, _reg_tensor(reg, zh), ens_size, degree)
    else:
        out = _nbh_cheb_forward(*args, reg, ens_size, degree)
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
    plan = _launch_plan("nbh_ns", k, nb, g)
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
    ``epsilon``; a slot of zero weight takes no part (its perturbations and
    innovation are zeroed, not multiplied by its zero weight, so a NaN there
    poisons nothing); ``strict`` (with ``width > nb``) NaN-poisons columns
    whose counts differ by more than ``nb``; then the Chebyshev solve and
    apply. Runs ``chunk`` columns at a time, to bound the gathered windows.
    """
    dtype, device = table.dtype, table.device
    k = ens_size
    reg = scal[0]
    nodes, dct = (torch.from_numpy(a).to(dtype=dtype, device=device)
                  for a in _cheb_nodes_dct(degree))
    outs = []
    for cols, sel, w, overflow in _window2d_windows(
            table, bands, grid, scal, width=width, nb=nb, k=k,
            epsilon=epsilon, taper=taper, tile=tile, chunk=chunk):
        n_c = w.shape[0] * w.shape[1]
        sw = safe_sqrt(w).reshape(n_c, nb).T                  # [nb, C]
        weighs = sw > 0
        zh = torch.where(weighs[:, None], sel[..., :k].reshape(
            n_c, nb, k).permute(1, 2, 0), 0.0) * sw[:, None]
        yh = torch.where(weighs, sel[..., k].reshape(n_c, nb).T, 0.0) * sw
        if strict and width > nb:
            yh = yh + torch.where(overflow, math.nan, 0.0).to(
                dtype).reshape(1, n_c)
        outs.append(_cheb_solve_apply(nodes, dct, zh, yh, sp[:, :, cols],
                                      mean[:, None, cols], reg, ens_size,
                                      degree))
    return torch.cat(outs, dim=2)


def _window2d_windows(table, bands, grid, scal, *, width, nb, k, epsilon,
                      taper, tile, chunk):
    """The windows of :func:`window2d_plain`, ``chunk`` columns at a time:
    per chunk of tiles its grid columns (a slice), the window's table rows
    [T, tile, nb, rows], their product-taper weights [T, tile, nb] (zero
    outside the slice and at or under ``epsilon``) and whether a column has
    more than ``nb`` band observations in its x-cutoff [T, tile]."""
    dtype, device = table.dtype, table.device
    n_dims = grid.shape[0]
    n_tiles = grid.shape[1] // tile
    radii = scal[1:]
    sup = torch.as_tensor(taper_support_z(taper, epsilon), dtype=dtype,
                          device=device) * radii[0]
    iota = torch.arange(width, device=device)
    slots = torch.arange(nb, device=device)
    per = max(chunk // tile, 1)
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
        yield cols, sel, w, high - low > nb


@functools.lru_cache(maxsize=None)
def _window2d_lib():
    from tpu_assim_torch._build import load_library

    lib = load_library("letkf_window2d")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.window2d_launch.argtypes = (
        [ptr] * 10 + [i32] * 11 + [f32] * 2 + [i32] * 4 + [ptr])
    lib.window2d_launch.restype = i32
    lib.window2d_smem_bytes.argtypes = [i32] * 9
    lib.window2d_smem_bytes.restype = ctypes.c_size_t
    lib.window2d_error_string.argtypes = [i32]
    lib.window2d_error_string.restype = ctypes.c_char_p
    return lib


# K6's routes (csrc/letkf_window2d.cu): the register route holds the Gram
# matrix in registers for windows of at most K6_REG_MAX_NB observations in
# blocks of K6_REG_WARPS warps, or of K6_STAGED_WARPS (K6_REG_WARPS at
# K6_REG_MAX_NB) where its blocks stage their slice, built for
# K6_STAGED_BLOCKS blocks an SM: the same warps an SM by registers; the
# shared route takes larger windows, up to K6_SMEM_MAX_WARPS warps a block.
K6_ROUTES = ("register", "shared")
K6_REG_MAX_NB = 64
K6_REG_WARPS = 4
K6_STAGED_WARPS = 6
K6_STAGED_BLOCKS = 2
K6_SMEM_MAX_WARPS = 8
# The widths the register route solves a column at: its observations of
# nonzero weight rounded up to 8.
K6_WIDTHS = tuple(range(8, K6_REG_MAX_NB + 1, 8))
# A Hopper card's SMs; unstaged blocks that fill it: each SM holding 2-3
# of them, several waves over, so that the last wave's imbalance is small.
_K6_SMS = 132
_K6_FILL_BLOCKS = 16 * _K6_SMS
# Staged blocks copy their tile's whole slice each, so a tile spreads over
# no more of them than keep the launch within two waves of
# K6_STAGED_BLOCKS blocks an SM, each of K6_STAGED_MIN_COLS columns or
# more (on the card, config 7's 128 tiles ran fastest as 512 blocks of 32
# columns, the 2-D halo's 16 as 256 blocks of 8).
_K6_STAGED_FILL_BLOCKS = 2 * K6_STAGED_BLOCKS * _K6_SMS
K6_STAGED_MIN_COLS = 8
# The smallest window whose blocks stage. Below it (NBC 8-24) the kernel
# takes 100-121 registers, so unstaged blocks of 4 warps hold 16 warps an
# SM, staged blocks of 6 only 12: on config 8's network staging lost 3-10%
# at windows of 16 and 24 and gained 2-8% at 32-52 (an H100).
K6_STAGED_MIN_NB = 25


def _band_bytes(width: int) -> tuple:
    """Shared memory of a tile's sorted band (letkf_window2d.cu:band_bytes,
    key_bytes): the sorted x and slot of each slot, 16-byte aligned, and
    the block's counts of columns at each width; and the sort's 64-bit
    keys over the width rounded up to a power of 2, which the warps'
    workspaces overwrite once the band is sorted."""
    pow2 = 1 << max(width - 1, 0).bit_length()
    return ((8 * width + 15) & ~15) + 4 * len(K6_WIDTHS), 8 * pow2


def _k6_stage_bytes(width: int, rows: int) -> int:
    """Shared memory of a staged slice (letkf_window2d.cu:stage_bytes):
    ``width`` table rows of ``rows`` floats at the odd row stride
    ``rows | 1``, 16-byte aligned."""
    return (4 * width * (rows | 1) + 15) & ~15


def _k6_floats_per_warp(route: str, k: int, nb: int, ns: int,
                        degree: int) -> int:
    """Shared floats of one column's workspace on ``route``
    (cheb_reg.cuh:workspace_floats at the widest width plus the kept
    slots' rows and weights; cheb_core.cuh:workspace_floats plus the
    window's weights and rows)."""
    if route == "register":
        nbc = (nb + 7) & ~7
        return _round4(2 * K6_REG_MAX_NB + k * (nbc + 4)
                       + 4 * (1 + ns) * nbc + ns * k + ns
                       + 4 * (degree + 1)) + 2 * nbc
    return _round4(_cheb_core_floats(k, nb, ns, degree) + 2 * nb)


def _k6_splits(n_tiles: int, tile: int, min_cols: int) -> int:
    """Blocks a tile, unstaged: doubled while fewer than
    ``_K6_FILL_BLOCKS`` blocks are in flight and each block keeps at least
    ``min_cols`` columns."""
    splits = 1
    while (n_tiles * splits < _K6_FILL_BLOCKS and tile % (2 * splits) == 0
           and tile // (2 * splits) >= min_cols):
        splits *= 2
    return splits


def _k6_staged_splits(n_tiles: int, tile: int) -> int:
    """Blocks a tile, staged: doubled while twice as many blocks stay
    within ``_K6_STAGED_FILL_BLOCKS`` and each keeps at least
    ``K6_STAGED_MIN_COLS`` columns."""
    splits = 1
    while (2 * n_tiles * splits <= _K6_STAGED_FILL_BLOCKS
           and tile % (2 * splits) == 0
           and tile // (2 * splits) >= K6_STAGED_MIN_COLS):
        splits *= 2
    return splits


def window2d_plan(k: int, nb: int, ns: int, degree: int, width: int,
                  n_tiles: int, tile: int = 128, n_dims: int = 2) -> dict:
    """K6's launch for ``n_tiles`` tiles of ``tile`` columns, each reading
    a slice of ``width`` table rows of ``k + 1 + n_dims`` floats: the
    route, the warps a block, the blocks a tile (``splits``), the block's
    shared memory in bytes and ``staged``, whether its blocks stage their
    slice in shared memory.

    Windows of up to ``K6_REG_MAX_NB`` take the register route, larger
    ones the shared route. On the register route, for windows of at
    least ``K6_STAGED_MIN_NB``, the blocks stage their slice where a
    block of ``K6_STAGED_WARPS`` warps (``K6_REG_WARPS`` at windows of
    57-64) with the slice beside its workspaces fits
    ``K6_STAGED_BLOCKS`` times in an SM's shared memory and holds at least
    ``K6_STAGED_MIN_COLS`` columns; a grid of few tiles spreads each tile
    over blocks of no fewer columns while the launch stays within two
    waves of ``K6_STAGED_BLOCKS`` blocks an SM.
    Elsewhere each column reads its window from the table: the warps are
    the route's most that fit a Hopper block's shared memory beside the
    band, and a grid of few tiles spreads each tile over up to
    ``tile / (2 warps)`` blocks (each sorts the band itself; every warp
    keeps at least two columns) until about ``16 * 132`` blocks are in
    flight. Raises ``ValueError`` when not even one warp fits."""
    from tpu_assim_torch._build import SMEM_PER_BLOCK

    route = "register" if nb <= K6_REG_MAX_NB else "shared"
    band, keys = _band_bytes(width)
    per_warp = 4 * _k6_floats_per_warp(route, k, nb, ns, degree)
    if route == "register" and nb >= K6_STAGED_MIN_NB:
        warps = K6_STAGED_WARPS if nb <= K6_REG_MAX_NB - 8 else K6_REG_WARPS
        smem = (band + _k6_stage_bytes(width, k + 1 + n_dims)
                + max(warps * per_warp, keys))
        splits = _k6_staged_splits(n_tiles, tile)
        if (SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)
                >= K6_STAGED_BLOCKS
                and tile // splits >= K6_STAGED_MIN_COLS):
            return {"route": route, "warps": warps, "splits": splits,
                    "smem": smem, "staged": True}
    cap = K6_REG_WARPS if route == "register" else K6_SMEM_MAX_WARPS
    warps = min(cap, tile, (SMEM_PER_BLOCK - band) // per_warp)
    if warps < 1 or band + keys > SMEM_PER_BLOCK:
        raise ValueError(
            f"window2d: these shapes need {band + max(per_warp, keys)} bytes "
            f"of shared memory per block; a Hopper block has "
            f"{SMEM_PER_BLOCK}")
    return {"route": route, "warps": warps,
            "splits": _k6_splits(n_tiles, tile, 2 * warps),
            "smem": band + max(warps * per_warp, keys), "staged": False}


def _launch_window2d(table, bands, grid, sp, mean, scal, width, nb, degree,
                     tile, epsilon, taper, strict):
    lib = _window2d_lib()
    n_rows = table.shape[0]
    n_dims, g = grid.shape
    ns, k, _ = sp.shape
    plan = _launch_plan("window2d", k, nb, ns, degree, width, g // tile, tile,
                        n_dims)
    _check_launchable("window2d", (table, bands, grid, sp, mean, scal),
                      plan["smem"])
    nodes, dct = _cheb_tables(degree, table.device)
    out = torch.empty_like(sp)
    counts = torch.empty(len(K6_WIDTHS) + 1, dtype=torch.int32,
                         device=table.device)
    with span("kernel.window2d"), torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.window2d_launch(
            table.data_ptr(), bands.data_ptr(), grid.data_ptr(),
            sp.data_ptr(), mean.data_ptr(), scal.data_ptr(),
            nodes.data_ptr(), dct.data_ptr(), out.data_ptr(),
            counts.data_ptr(), k, n_dims, n_rows, g, ns, nb, degree, width,
            tile, _TAPERS.index(taper),
            int(bool(strict)), taper_support_z(taper, epsilon),
            float(epsilon), K6_ROUTES.index(plan["route"]), plan["warps"],
            plan["splits"], int(plan["staged"]), stream)
    if err != 0:
        raise RuntimeError("window2d kernel launch failed: "
                           + lib.window2d_error_string(err).decode())
    LAUNCHES["window2d"] += 1
    WINDOW2D_WIDTHS.update(counts=counts,
                           blocks=(g // tile) * plan["splits"])
    return out


def window2d_width_counts():
    """The columns K6's last launch solved at each width of its register
    route, ``{8: n, 16: n, ..., 64: n}`` (all 0 on the shared route), read
    from the card with a synchronise; None before any launch."""
    counts = WINDOW2D_WIDTHS["counts"]
    if counts is None:
        return None
    return dict(zip(K6_WIDTHS, counts[:len(K6_WIDTHS)].tolist()))


def window2d_staged_share():
    """The share of K6's last launch's blocks that read their windows
    from their slice staged in shared memory (0.0 where none did), read
    from the card with a synchronise; None before any launch."""
    counts = WINDOW2D_WIDTHS["counts"]
    if counts is None:
        return None
    blocks = WINDOW2D_WIDTHS["blocks"]
    return int(counts[len(K6_WIDTHS)].item()) / blocks if blocks else 0.0


def _window2d_forward(table, bands, grid, sp, mean, scal, width, ens_size,
                      nb, degree, epsilon, taper, strict, tile):
    """K6's dispatch: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if table.device.type == "cpu":
        return window2d_plain(table, bands, grid, sp, mean, scal,
                              width=width, ens_size=ens_size, nb=nb,
                              degree=degree, epsilon=epsilon, taper=taper,
                              strict=strict, tile=tile)
    return _launch_window2d(table, bands, grid, sp, mean, scal, width, nb,
                            degree, tile, epsilon, taper, strict)


class _Window2D(torch.autograd.Function):
    """K6 with a VJP (the port of ``_window2d_dma_call``,
    ``tpu_assim/ops/pallas/letkf.py:1951-1983``, and of ``_window2d_call``,
    ``:1832-1859``): the forward dispatches as :func:`window2d_banded`
    does, on detached inputs; the backward replays :func:`window2d_plain`
    with ``strict=False`` (JAX's ``_window2d_dma_ref`` has no strict
    poison) on the saved inputs and pulls the cotangent back through it:
    gradients in ``table``, ``grid``, ``sp``, ``mean`` and ``scal`` (reg
    and the radii). ``bands`` is int32 and gets None (JAX's f32 bands get
    zero)."""

    @staticmethod
    def forward(ctx, table, bands, grid, sp, mean, scal, width, ens_size, nb,
                degree, epsilon, taper, strict, tile):
        ctx.save_for_backward(table, bands, grid, sp, mean, scal)
        ctx.statics = dict(width=width, ens_size=ens_size, nb=nb,
                           degree=degree, epsilon=epsilon, taper=taper,
                           tile=tile)
        return _window2d_forward(
            *(t.detach() for t in (table, bands, grid, sp, mean, scal)),
            width, ens_size, nb, degree, epsilon, taper, strict, tile)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        st = ctx.statics

        def replay(table, bands, grid, sp, mean, scal):
            return window2d_plain(table, bands, grid, sp, mean, scal,
                                  strict=False, **st)

        return _pullback(ctx, replay, grad) + (None,) * 8


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

    Returns the analysis [ns, k, G]. Differentiable in every tensor but
    ``bands`` through :class:`_Window2D` when grad mode is on and one of
    them requires a gradient.
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
    args = (table, bands, grid, sp, mean, scal, width, k, nb, degree,
            epsilon, taper, strict, tile)
    if _records_graph(table, grid, sp, mean, scal):
        return _Window2D.apply(*args)
    return _window2d_forward(*args)


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
