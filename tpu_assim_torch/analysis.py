"""
Analysis and cycle steps (PyTorch port of :mod:`tpu_assim.analysis`).

The complete analysis — obs operator, R^{-1/2} normalization, innovation,
Gaspari-Cohn taper, weight solve and weight application — runs on the
device of the state tensor. The LETKF solvers:

- ``method="eigh"``: exact eigendecomposition, over the dense taper (the
  f64 oracle) or over fixed-size neighborhoods (``max_obs``);
- ``method="newton"``: coupled Newton-Schulz iterations on the K x K
  matrices; ``method="woodbury"``: the same on the nb x nb dual matrices of
  the neighborhoods;
- ``method="cheb"``: the Chebyshev solve and apply over gathered
  neighborhoods in one CUDA kernel
  (:func:`tpu_assim_torch.ops.cuda.letkf.letkf_nbh_analysis_cheb`);
- ``method="pallas"``: the Woodbury solve by Newton-Schulz iterations and
  apply over gathered neighborhoods in one CUDA kernel
  (:func:`tpu_assim_torch.ops.cuda.letkf.letkf_nbh_analysis_fused`; the
  name is the JAX package's);
- ``method="fused1d"``: the whole analysis in one CUDA kernel
  (:func:`tpu_assim_torch.ops.cuda.letkf.letkf_window_analysis_fused`);
- ``method="fused2d"``: the whole 2-D analysis in one CUDA kernel
  (:func:`tpu_assim_torch.ops.cuda.letkf.letkf_window_analysis_fused_2d`).

:func:`make_strip_letkf_2d` splits a wide 2-D grid into x-strips that run
through one launch of the 2-D kernel. :func:`make_lienks_step` is the
localized IEnKS smoother.
"""

from typing import Callable, Optional

import numpy as np
import torch

from tpu_assim_torch.interface.mixin_local import map_grid_chunked
from tpu_assim_torch.models.cuda_forecast import (
    fused_rk4_steps,
    supports_fused_rk4,
)
from tpu_assim_torch.ops.cuda.letkf import (
    letkf_nbh_analysis_cheb,
    letkf_nbh_analysis_fused,
    letkf_window_analysis_fused,
    letkf_window_analysis_fused_2d,
    max_in_support_1d,
    max_in_support_2d,
    raise_if_overflow,
    required_obs_block_2d,
    taper_name,
    window2d_banded,
)
from tpu_assim_torch.ops.etkf import (
    etkf_weights,
    letkf_weights_dense,
    letkf_weights_nbh,
)
from tpu_assim_torch.ops.ienks import ienks_bundle_step, ienks_transform_step
from tpu_assim_torch.ops.localization import (
    safe_sqrt,
    safe_sqrt_keep_nan,
    select_neighborhoods,
    taper_support_z,
)
from tpu_assim_torch.utils.profiling import span

__all__ = ["make_cycle_step", "make_etkf_analysis", "make_letkf_analysis",
           "make_lienks_step", "make_strip_letkf_2d"]

_METHODS = ("eigh", "newton", "woodbury", "cheb", "pallas", "fused1d",
            "fused2d")
# methods that need a localization and max_obs
_NBH_METHODS = ("woodbury", "cheb", "pallas", "fused1d", "fused2d")


def _normalized_obs_space(ens_obs, obs_vals, obs_var):
    """R^{-1/2} normalization of innovations and obs-space perturbations.

    ens_obs [k, o], obs_vals [o], obs_var [o] (diagonal) or [o, o] (full
    correlated covariance, whitened by its Cholesky factor through a
    triangular solve) -> (perts [k, o], innov [o]).
    """
    mean = torch.mean(ens_obs, dim=0, keepdim=True)
    if obs_var.ndim == 2:
        chol = torch.linalg.cholesky(obs_var)
        perts = torch.linalg.solve_triangular(
            chol, (ens_obs - mean).T, upper=False).T
        innov = torch.linalg.solve_triangular(
            chol, (obs_vals - mean[0])[:, None], upper=False)[:, 0]
        return perts, innov
    rcinv = 1.0 / torch.sqrt(obs_var)
    return (ens_obs - mean) * rcinv, (obs_vals - mean[0]) * rcinv


def _with_time(coords):
    """Localization info rows: a time column (zero), then the coords."""
    return torch.cat([torch.zeros_like(coords[:, :1]), coords], dim=1)


def radii_2d(localization, n_dims: int = 2):
    """``(rx, ry, extra)`` of a Gaspari-Cohn localization for the 2-D
    window analysis: the first radius for x, the second (else the first)
    for y, and for each further coordinate dim its radius, else the last
    one."""
    radii = np.atleast_1d(np.asarray(localization.radius, dtype=float))
    extra = tuple(float(radii[j] if j < radii.size else radii[-1])
                  for j in range(2, n_dims))
    return (float(radii[0]), float(radii[1] if radii.size > 1 else radii[0]),
            extra)


def _check_selection(selection: str) -> None:
    if selection not in ("topk", "window"):
        raise ValueError(f"selection must be 'topk' or 'window'; got "
                         f"{selection!r}")


def _forecast(integrator, n_steps: int, state_data):
    """``n_steps`` of ``integrator``: the fused RK4 kernel wherever
    :func:`supports_fused_rk4` holds, else the integrator's own steps."""
    with span("forecast"):
        if supports_fused_rk4(integrator, state_data.shape,
                              state_data.element_size()):
            return fused_rk4_steps(integrator.model, state_data.contiguous(),
                                   integrator.dt, n_steps)
        for _ in range(n_steps):
            state_data = integrator.integrate(state_data)
        return state_data


def make_letkf_analysis(
    localization,
    inf_factor: float = 1.0,
    chunksize: Optional[int] = None,
    obs_operator: Optional[Callable] = None,
    method: str = "eigh",
    newton_iters: int = 25,
    max_obs: Optional[int] = None,
    cheb_degree: int = 16,
    selection: str = "topk",
    obs_block: Optional[int] = None,
    max_obs_strict: bool = True,
    geometry: Optional[tuple] = None,
):
    """Build a single-cycle LETKF analysis (the parameters of
    :func:`tpu_assim.analysis.make_letkf_analysis`, in its order).

    Parameters
    ----------
    localization : Gaspari-Cohn taper object (or None: unlocalized).
    inf_factor : inflation rho.
    chunksize : grid columns per chunk (memory bound): of the dense taper
        and the weights, or of the neighborhoods of ``cheb`` (one kernel
        launch per chunk).
    obs_operator : optional callable ``[..., grid] -> [..., obs]``; by
        default the observations are point observations at ``obs_idx``.
    method : ``"eigh"`` — exact eigendecomposition, over the dense taper or,
        with ``max_obs``, over each column's ``max_obs`` selected
        observations; ``"newton"`` — the same weights by coupled
        Newton-Schulz iterations; ``"woodbury"`` — Newton-Schulz on the
        neighborhoods' nb x nb dual matrices; ``"cheb"`` — the Chebyshev
        solve and apply over the neighborhoods in one kernel; ``"pallas"``
        — the Woodbury solve and apply over the neighborhoods in one
        kernel; ``"fused1d"`` — the whole analysis in one kernel, for
        sorted 1-D obs coordinates (column 0 of the coordinates) and a
        single-radius Gaspari-Cohn taper; ``"fused2d"`` — the whole 2-D
        analysis in one kernel, over coordinate columns (x, y, ...) in any
        order, with per-dimension radii. ``woodbury``, ``cheb``,
        ``pallas``, ``fused1d`` and ``fused2d`` need a localization and
        ``max_obs``.
    newton_iters : Newton-Schulz iterations of ``newton``, ``woodbury`` and
        ``pallas``.
    max_obs : the neighborhood size (None with ``eigh``/``newton``: the
        dense taper) and the window size of ``fused1d`` and ``fused2d``.
    cheb_degree : Chebyshev degree of ``cheb``, ``fused1d`` and
        ``fused2d``.
    selection : how the neighborhoods are picked: ``"topk"`` (largest
        taper weights) or ``"window"`` (sorted 1-D obs coordinates; see
        :func:`tpu_assim_torch.ops.localization.neighborhood_select_window`).
    obs_block : the per-tile y-band width of ``fused2d``; None computes the
        exact one (:func:`required_obs_block_2d`) from the coordinates at
        each call (or once, with ``geometry``). ``fused1d`` ignores it: its
        kernel searches the whole coordinate table.
    max_obs_strict : the window selections NaN-poison columns with more
        in-support observations than ``max_obs``, and ``fused1d`` and
        ``fused2d`` also raise at call (or build) time; False accepts
        truncation to the nearest.
    geometry : optional ``(obs_idx, grid_coords, obs_coords)`` arrays
        (``obs_idx`` None with an ``obs_operator``), fixed across calls:
        the returned function then takes ``(state_data, obs_vals,
        obs_var)``, the host-side checks run once here, and the arrays move
        to each device once.

    Returns
    -------
    analysis_fn(state_data [k, g], obs_vals [o], obs_var, obs_idx [o],
                grid_coords [g, d], obs_coords [o, d]) -> analysis [k, g]
    """
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    _check_selection(selection)
    if method in _NBH_METHODS and (localization is None or max_obs is None):
        raise ValueError(f"method={method!r} needs a localization and "
                         "max_obs")
    fused = method == "fused1d"
    if fused:
        radius = np.atleast_1d(np.asarray(localization.radius, dtype=float))
        if radius.size != 1:
            raise ValueError("method='fused1d' supports a single "
                             f"localization radius; got {radius}")
        radius = float(radius[0])
    if method in ("fused1d", "fused2d"):
        taper = taper_name(localization)
        epsilon = float(localization.epsilon)

    def _host_harden(obs_coords_np, grid_coords_np):
        """The host checks of the window kernels: for fused1d sortedness
        and, when strict, the in-support bound; for fused2d, unless
        ``obs_block`` is given (the kernel's NaN poison then guards), the
        exact band width and, when strict, the in-support bound. Returns
        the band width of fused2d."""
        if method == "fused2d":
            if obs_block is not None:
                return obs_block
            rx, ry, _ = radii_2d(localization)
            if max_obs_strict:
                raise_if_overflow(max_in_support_2d(
                    obs_coords_np[:, :2], grid_coords_np[:, :2], rx, ry,
                    taper=taper, epsilon=epsilon), max_obs)
            return required_obs_block_2d(obs_coords_np[:, 1],
                                         grid_coords_np[:, 1], ry)
        if not fused:
            return obs_block
        ox = obs_coords_np[:, 0]
        if ox.shape[0] > 1 and np.any(ox[1:] < ox[:-1]):
            raise ValueError("method='fused1d' needs obs coordinates sorted "
                             "ascending along dimension 0")
        if max_obs_strict:
            raise_if_overflow(
                max_in_support_1d(ox, grid_coords_np[:, 0], radius,
                                  taper=taper, epsilon=epsilon),
                max_obs)
        return obs_block

    def _impl(state_data, obs_vals, obs_var, obs_idx, grid_coords,
              obs_coords, block):
        if obs_operator is None:
            ens_obs = state_data[:, obs_idx]                       # [k, o]
        else:
            ens_obs = obs_operator(state_data)
        perts, innov = _normalized_obs_space(ens_obs, obs_vals, obs_var)
        k = state_data.shape[0]

        if fused:
            f32 = torch.float32
            mean = torch.mean(state_data, dim=0)
            sp = state_data - mean[None, :]
            return letkf_window_analysis_fused(
                *(t.to(f32).contiguous() for t in (
                    perts, innov, obs_coords[:, 0], grid_coords[:, 0], sp,
                    mean)),
                (k - 1) / inf_factor, radius, k, nb=max_obs,
                degree=cheb_degree, taper=taper, epsilon=epsilon,
                strict=max_obs_strict,
            )

        if method == "fused2d":
            n_dims = min(obs_coords.shape[1], grid_coords.shape[1])
            rx, ry, extra = radii_2d(localization, n_dims)
            mean = torch.mean(state_data, dim=0)
            sp = state_data - mean[None, :]
            return letkf_window_analysis_fused_2d(
                *(t.to(torch.float32).contiguous()
                  for t in (perts, innov)),
                obs_coords[:, :n_dims], grid_coords[:, :n_dims],
                *(t.to(torch.float32).contiguous() for t in (sp, mean)),
                (k - 1) / inf_factor, rx, ry, k, obs_block=block,
                nb=max_obs, degree=cheb_degree, taper=taper,
                epsilon=epsilon, strict=max_obs_strict, extra_radii=extra)

        obs_info = _with_time(obs_coords)
        grid_info = _with_time(grid_coords)

        def select(g_chunk):
            return select_neighborhoods(localization, g_chunk, obs_info,
                                        max_obs, selection, max_obs_strict)

        def neighborhoods(g_chunk):
            """The chunk's neighborhood indices and sqrt taper weights."""
            idx, w_nbh = select(g_chunk)
            return idx, safe_sqrt_keep_nan(w_nbh).to(perts.dtype)

        if method in ("cheb", "pallas"):
            f32 = torch.float32
            reg = (k - 1) / inf_factor
            mean = torch.mean(state_data, dim=0)
            sp = state_data - mean[None, :]

        if method == "cheb":
            def cheb_chunk(sl):
                idx, sw = neighborhoods(grid_info[sl])             # [c, nb]
                zh = perts[:, idx].permute(2, 0, 1) * sw.T[:, None, :]
                yh = innov[idx].T * sw.T                           # [nb, c]
                return letkf_nbh_analysis_cheb(
                    *(t.to(f32).contiguous() for t in (
                        zh, yh, sp[:, sl], mean[sl])),
                    reg, k, degree=cheb_degree)

            g = grid_info.shape[0]
            step = g if chunksize is None else max(int(chunksize), 1)
            return torch.cat([cheb_chunk(slice(i, i + step))
                              for i in range(0, g, step)], dim=1)

        if method == "pallas":
            idx, sw = neighborhoods(grid_info)
            zh = perts[:, idx].permute(1, 2, 0) * sw[:, :, None]   # [g, nb, k]
            out = letkf_nbh_analysis_fused(
                *(t.to(f32).contiguous() for t in (
                    zh, innov[idx] * sw, sp.T, mean)),
                reg, k, num_iters=newton_iters)
            return out.T.contiguous()

        def chunk_fn(g_chunk):
            if localization is not None and max_obs is not None:
                idx, w_nbh = select(g_chunk)
                return letkf_weights_nbh(perts, innov, idx,
                                         w_nbh.to(perts.dtype), inf_factor,
                                         method=method,
                                         newton_iters=newton_iters)
            if localization is None:
                w_loc = torch.ones(g_chunk.shape[0], obs_info.shape[0],
                                   dtype=perts.dtype, device=perts.device)
            else:
                w_loc = localization.taper_weights(g_chunk, obs_info).to(
                    perts.dtype)
            return letkf_weights_dense(perts, innov, w_loc, inf_factor,
                                       method=method,
                                       newton_iters=newton_iters)

        weights = map_grid_chunked(chunk_fn, grid_info, chunksize)  # [g,k,k]
        mean = torch.mean(state_data, dim=0, keepdim=True)
        return mean + torch.einsum("kg,gkm->mg", state_data - mean, weights)

    if geometry is not None:
        g_idx, g_grid, g_obs = (None if a is None else np.asarray(a)
                                for a in geometry)
        block = _host_harden(g_obs, g_grid)
        on_device = {}

        def analysis_fn_static(state_data, obs_vals, obs_var):
            dev = state_data.device
            if dev not in on_device:
                on_device[dev] = tuple(
                    None if a is None else torch.as_tensor(a, device=dev)
                    for a in (g_idx, g_grid, g_obs))
            with span("letkf.analysis"):
                return _impl(state_data, obs_vals, obs_var, *on_device[dev],
                             block)

        return analysis_fn_static

    def analysis_fn(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                    obs_coords):
        block = obs_block
        if method in ("fused1d", "fused2d"):
            block = _host_harden(obs_coords.detach().cpu().numpy(),
                                 grid_coords.detach().cpu().numpy())
        with span("letkf.analysis"):
            return _impl(state_data, obs_vals, obs_var, obs_idx,
                         grid_coords, obs_coords, block)

    return analysis_fn


def make_strip_letkf_2d(
    localization,
    geometry: tuple,
    n_strips: int,
    inf_factor: float = 1.0,
    max_obs: Optional[int] = None,
    cheb_degree: int = 16,
    max_obs_strict: bool = True,
    tile: int = 128,
):
    """The 2-D LETKF for wide grids: the grid split into ``n_strips``
    x-strips, each analysed over only the observations inside its columns'
    x-support, all strips in one launch of the 2-D window kernel, scattered
    back into the grid's order. Exact: every strip sees every observation
    inside its columns' taper support; the strict in-support checks run per
    strip, here.

    Parameters
    ----------
    geometry : ``(obs_cells, grid_xy, obs_xy)``: the flat observed cell
        index [o], the grid coordinates [g, 2] (x in column 0) and the obs
        coordinates [o, 2]; fixed across calls.
    n_strips : number of x-strips.
    max_obs : window size; None takes the exact worst per-column count
        under the strip tiling, rounded up to a multiple of 4 (at least 8).

    Returns ``fn(state_data [k, g], obs_vals [o], obs_var [o]) -> [k, g]``
    (obs_var diagonal, or [o, o] correlated).
    """
    plan = _strip_plan_2d(localization, geometry[1], geometry[2], n_strips,
                          max_obs, max_obs_strict, tile)
    cells = np.asarray(geometry[0]).astype(np.int64)
    on_device = {}

    def analysis_fn(state_data, obs_vals, obs_var):
        dev = state_data.device
        if dev not in on_device:
            on_device[dev] = torch.as_tensor(cells, device=dev)
        k = state_data.shape[0]
        with span("strip.analysis"):
            perts, innov = _normalized_obs_space(
                state_data[:, on_device[dev]], obs_vals, obs_var)
            mean = torch.mean(state_data, dim=0)
            sp = state_data - mean[None, :]
            out = _strip_apply_2d(plan, perts, innov, sp[None], mean[None],
                                  (k - 1) / inf_factor, cheb_degree)
            return out[0].to(state_data.dtype)

    return analysis_fn


def _strip_plan_2d(localization, grid_xy, obs_xy, n_strips, max_obs,
                   max_obs_strict, tile: int = 128):
    """The x-strip plan of concrete 2-D geometry (host-side numpy, shared by
    :func:`make_strip_letkf_2d` and ``LETKF(method="fused2d")``): the
    row-major column order of every strip, padded to whole tiles by the
    strip's first cell; the per-strip observations within the x-cutoff; the
    window size (auto: the worst per-column count under the strip tiling);
    one table of ``n_strips`` y-sorted segments of ``p`` slots each (pad
    slots last); each tile's slice offset and band within its segment; and
    the scatter back into the grid's order."""
    gxy = np.asarray(grid_xy, dtype=np.float32)
    oxy = np.asarray(obs_xy, dtype=np.float32)
    g = gxy.shape[0]
    rx, ry, _ = radii_2d(localization)
    taper = taper_name(localization)
    eps = float(localization.epsilon)
    cut = taper_support_z(taper, eps) * rx

    gx, gy = gxy[:, 0], gxy[:, 1]
    bounds = np.linspace(gx.min(), gx.max() + 1e-6, n_strips + 1)
    strip_of = np.clip(
        np.searchsorted(bounds, gx, side="right") - 1, 0, n_strips - 1)
    cell_idx = []
    gs = 0
    for s in range(n_strips):
        idx = np.nonzero(strip_of == s)[0]
        idx = idx[np.lexsort((gx[idx], gy[idx]))]   # row-major in the strip
        cell_idx.append(idx)
        gs = max(gs, idx.shape[0])
    gs = -(-gs // tile) * tile
    # a ragged strip repeats its first cell: the copy's analysis equals the
    # real one's, and the scatter-back reads the real one
    cell_idx = [
        np.concatenate([idx, np.full(gs - len(idx), idx[0], idx.dtype)])
        if len(idx) < gs else idx
        for idx in cell_idx
    ]

    ox = oxy[:, 0]
    sel, p = [], 0
    for s in range(n_strips):
        lo = gx[cell_idx[s]].min() - cut
        hi = gx[cell_idx[s]].max() + cut
        sel.append(np.nonzero((ox > lo) & (ox < hi))[0])
        p = max(p, sel[-1].shape[0])
    p = max(-(-p // 8) * 8, 8)
    big = np.float32(np.finfo(np.float32).max)
    worst = 0
    if max_obs_strict or max_obs is None:
        for s in range(n_strips):
            worst = max(worst, max_in_support_2d(
                oxy[sel[s]], gxy[cell_idx[s]], rx, ry, taper=taper,
                epsilon=eps, tile=tile))
    if max_obs is None:
        # the strip tiles are taller than the grid's, so their bands are
        # wider: size the window under this tiling
        max_obs = max(-(-worst // 4) * 4, 8)
    elif max_obs_strict:
        raise_if_overflow(worst, max_obs)

    ord_sel = np.zeros((n_strips, p), dtype=np.int64)
    seg_valid = np.zeros((n_strips, p), dtype=np.float32)
    seg_ox = np.full((n_strips, p), big, dtype=np.float32)
    seg_oy = np.full((n_strips, p), big, dtype=np.float32)
    for s in range(n_strips):
        n_s = sel[s].shape[0]
        ys = np.argsort(oxy[sel[s], 1], kind="stable")
        ord_sel[s, :n_s] = sel[s][ys]
        seg_valid[s, :n_s] = 1.0
        seg_ox[s, :n_s] = oxy[sel[s][ys], 0]
        seg_oy[s, :n_s] = oxy[sel[s][ys], 1]

    # each tile's band [min(gy) - 2 ry, max(gy) + 2 ry] within its strip's
    # segment, as a slice of o_bd slots from an 8-aligned offset
    tiles_per_strip = gs // tile
    n_tiles = n_strips * tiles_per_strip
    bands = np.zeros((n_tiles, 3), dtype=np.float32)
    o_bd = 8
    for s in range(n_strips):
        seg_y = seg_oy[s]
        ty = gy[cell_idx[s]].reshape(tiles_per_strip, tile)
        lo = ty.min(axis=1) - 2.0 * ry
        hi = ty.max(axis=1) + 2.0 * ry
        iy0 = np.clip(np.searchsorted(seg_y, lo), 0, p - 1)
        iy1 = np.searchsorted(seg_y, hi, side="right")
        off = np.minimum(iy0, np.maximum(p - 8, 0))
        off = off - off % 8
        width = int((iy1 - off).max()) if tiles_per_strip else 8
        o_bd = max(o_bd, -(-width // 8) * 8)
        t0 = s * tiles_per_strip
        bands[t0:t0 + tiles_per_strip, 0] = s * p + off
        bands[t0:t0 + tiles_per_strip, 1] = iy0 - off
        bands[t0:t0 + tiles_per_strip, 2] = iy1 - off
    o_bd = min(o_bd, p)
    # a slice running past its segment's end shifts down instead
    over = np.maximum((bands[:, 0] % p) + o_bd - p, 0)
    bands[:, 0] -= over
    bands[:, 1] += over
    bands[:, 2] += over

    perm = np.concatenate(cell_idx)
    inv = np.zeros(g, dtype=np.int64)
    inv[perm] = np.arange(perm.shape[0])

    return {
        "osel": ord_sel.reshape(-1).astype(np.int32),
        "oval": seg_valid.reshape(-1),
        "seg_ox": seg_ox.reshape(-1),
        "seg_oy": seg_oy.reshape(-1),
        "bands": np.ascontiguousarray(bands.T),       # [3, n_tiles]
        "o_bd": int(o_bd),
        "perm": perm.astype(np.int32),
        "inv": inv.astype(np.int32),
        "grid2": np.stack([gx[perm], gy[perm]], axis=0),
        "max_obs": int(max_obs),
        "rx": rx, "ry": ry, "taper": taper, "eps": eps,
        "strict": bool(max_obs_strict), "tile": int(tile),
        "n_strips": int(n_strips), "on_device": {},
    }


def _strip_plan_on(plan, device):
    """The plan's index, coordinate and band arrays as tensors on
    ``device``, moved there once."""
    if device not in plan["on_device"]:
        dev = {n: torch.as_tensor(plan[n], device=device)
               for n in ("oval", "seg_ox", "seg_oy", "grid2")}
        for n in ("osel", "perm", "inv"):
            dev[n] = torch.as_tensor(plan[n].astype(np.int64), device=device)
        dev["bands"] = torch.as_tensor(plan["bands"].astype(np.int32),
                                       device=device)
        plan["on_device"][device] = dev
    return plan["on_device"][device]


def _strip_apply_2d(plan, perts, innov, sp, mean, reg, cheb_degree):
    """One launch of the 2-D window kernel over every strip of ``plan``,
    for R^{-1/2}-normalized ``perts [k, o]``, ``innov [o]`` and the state
    slices ``sp [ns, k, g]``, ``mean [ns, g]``; ``reg`` = (k - 1)/rho.
    Returns the analysis [ns, k, g] in the grid's order."""
    args, kwargs = _strip_inputs_2d(plan, perts, innov, sp, mean, reg,
                                    cheb_degree)
    inv = _strip_plan_on(plan, perts.device)["inv"]
    out = window2d_banded(*args, **kwargs)
    with span("strip.scatter"):
        return out[..., inv]


def _strip_inputs_2d(plan, perts, innov, sp, mean, reg, cheb_degree):
    """The arguments ``(args, kwargs)`` of the strip plan's one call of
    :func:`window2d_banded` (the analysis in strip order)."""
    f32 = torch.float32
    dev = _strip_plan_on(plan, perts.device)
    k = perts.shape[0]
    table = torch.cat([
        (perts.to(f32)[:, dev["osel"]] * dev["oval"]).T,
        (innov.to(f32)[dev["osel"]] * dev["oval"])[:, None],
        dev["seg_ox"][:, None], dev["seg_oy"][:, None]], dim=1)  # [S p, k+3]
    if isinstance(reg, torch.Tensor):
        # reg keeps its graph: the inflation is learnable through the strips
        scal = torch.cat([
            torch.as_tensor(reg, dtype=f32, device=perts.device).reshape(1),
            torch.tensor([plan["rx"], plan["ry"]], dtype=f32,
                         device=perts.device)])
    else:
        # a number: copied to the device once, since a copy from the host
        # waits for the stream and would stall a caller dispatching ahead
        key = ("scal", float(reg))
        if key not in dev:
            dev[key] = torch.tensor([reg, plan["rx"], plan["ry"]],
                                    dtype=f32, device=perts.device)
        scal = dev[key]
    args = (table.contiguous(), dev["bands"], dev["grid2"],
            sp.to(f32)[..., dev["perm"]].contiguous(),
            mean.to(f32)[..., dev["perm"]].contiguous(), scal)
    return args, dict(width=plan["o_bd"], ens_size=k, nb=plan["max_obs"],
                      degree=cheb_degree, tile=plan["tile"],
                      epsilon=plan["eps"], taper=plan["taper"],
                      strict=plan["strict"])


def make_etkf_analysis(inf_factor: float = 1.0,
                       obs_operator: Optional[Callable] = None):
    """Build a global-ETKF analysis with the signature of
    :func:`make_letkf_analysis` (grid/obs coords ignored)."""

    def analysis_fn(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                    obs_coords):
        if obs_operator is None:
            ens_obs = state_data[:, obs_idx]
        else:
            ens_obs = obs_operator(state_data)
        perts, innov = _normalized_obs_space(ens_obs, obs_vals, obs_var)
        weights = etkf_weights(perts, innov[None, :], inf_factor)
        mean = torch.mean(state_data, dim=0, keepdim=True)
        return mean + torch.einsum("kg,km->mg", state_data - mean, weights)

    return analysis_fn


def make_cycle_step(
    integrator,
    n_int_steps: int,
    localization,
    inf_factor: float = 1.0,
    chunksize: Optional[int] = None,
    **analysis_opts,
):
    """Build a forecast + analysis cycle step for a [k, g] ensemble:
    integrate every member ``n_int_steps`` steps, then run the LETKF
    analysis. The forecast is the fused RK4 kernel wherever
    :func:`supports_fused_rk4` holds, else the integrator's own steps.

    ``analysis_opts`` pass through to :func:`make_letkf_analysis`. With
    ``geometry=(obs_idx, grid_coords, obs_coords)`` the returned step takes
    only ``(state_data, obs_vals, obs_var)``.

    Returns step(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                 obs_coords) -> analysis [k, g] (first three args only
    when ``geometry`` is bound).
    """
    analyse = make_letkf_analysis(localization, inf_factor, chunksize,
                                  **analysis_opts)

    def step(state_data, *args):
        with span("cycle.step"):
            return analyse(_forecast(integrator, n_int_steps, state_data),
                           *args)

    return step


def make_lienks_step(
    localization,
    integrator,
    n_int_steps: int,
    n_outer: int = 3,
    kind: str = "transform",
    tau: float = 1.0,
    epsilon: float = 1e-4,
    max_obs: Optional[int] = None,
    selection: str = "window",
    max_obs_strict: bool = True,
    obs_operator: Optional[Callable] = None,
):
    """Build a localized-IEnKS analysis (the 4D-Var-shaped smoother) for a
    [k, g] ensemble over a fixed assimilation window.

    Per outer iteration: apply the current per-column weights to the prior
    ensemble, propagate the weighted ensemble ``n_int_steps`` model steps
    (the fused RK4 kernel wherever :func:`supports_fused_rk4` holds), apply
    the obs operator, normalize by R^{-1/2}, and run one localized
    Gauss-Newton inner step per grid column
    (:func:`tpu_assim_torch.ops.ienks.ienks_transform_step` /
    ``ienks_bundle_step``, batched [g, k, k]). Each inner step takes two
    batched K x K SVDs, which go to the one-sided Jacobi kernel for large
    f32 batches on CUDA. The neighborhood selection and its sqrt taper
    weights are computed once per call, before the outer loop, which runs
    on the device without a host sync.

    Parameters
    ----------
    localization : Gaspari-Cohn taper (or None for global).
    integrator / n_int_steps : forward model for the window (e.g.
        ``RK4Integrator(Lorenz96(), dt)``); None or 0 steps skips
        propagation.
    kind : ``"transform"`` (dH/dW through the inverted weight
        perturbations) or ``"bundle"`` (finite-difference scale
        ``epsilon``).
    max_obs / selection / max_obs_strict : fixed-size neighborhood
        selection, as in :func:`make_letkf_analysis`; ``max_obs=None``
        takes the dense taper. A column that the strict window poisons
        (more in-support observations than ``max_obs``) comes out NaN; the
        inner steps solve it with zero weights, so no SVD sees a NaN.

    Returns
    -------
    step(state_data [k, g], obs_vals [o], obs_var [o], obs_idx [o],
         grid_coords [g, d], obs_coords [o, d]) -> analysis [k, g]
    """
    if kind not in ("transform", "bundle"):
        raise ValueError(f"kind must be 'transform' or 'bundle', got {kind!r}")
    _check_selection(selection)

    def _forward(state_data):
        if integrator is None or n_int_steps == 0:
            return state_data
        return _forecast(integrator, n_int_steps, state_data)

    def step(state_data, obs_vals, obs_var, obs_idx, grid_coords,
             obs_coords):
        with span("lienks.step"):
            k, g = state_data.shape
            mean = torch.mean(state_data, dim=0)
            perts = state_data - mean[None, :]                 # [k, g]
            dtype, device = state_data.dtype, state_data.device
            idx, sqrt_w, poisoned = _lienks_taper(
                localization, max_obs, selection, max_obs_strict,
                grid_coords, obs_coords, dtype, device)
            eye = torch.eye(k, dtype=dtype, device=device)
            weights = eye.expand(g, k, k)
            for _ in range(n_outer):
                with span("lienks.outer"):
                    pseudo = _forward(_lienks_pseudo(mean, perts, weights,
                                                     kind, epsilon, eye))
                    if obs_operator is None:
                        ens_obs = pseudo[:, obs_idx]           # [k, o]
                    else:
                        ens_obs = obs_operator(pseudo)
                    perts_o, innov = _normalized_obs_space(ens_obs, obs_vals,
                                                           obs_var)
                    weights = _lienks_inner(weights, perts_o, innov, idx,
                                            sqrt_w, kind, tau, epsilon)
            return _lienks_apply(mean, perts, weights, poisoned)

    return step


# -- the localized IEnKS's per-column pieces ----------------------------------
# make_lienks_step runs them on every column of the grid, and
# parallel.lienks.sharded_lienks_step on each shard's columns.

def _lienks_taper(localization, max_obs, selection, max_obs_strict,
                  grid_coords, obs_coords, dtype, device):
    """The per-column neighborhood selection and sqrt taper weights:
    ``(idx [g, nb] or None, sqrt_w [g, nb] (or [g, o] dense), poisoned [g]
    or None)``. ``poisoned`` marks the columns the strict window poisons;
    their weights are zero, so that no inner SVD sees a NaN."""
    with span("lienks.taper"):
        grid_info = _with_time(grid_coords)
        obs_info = _with_time(obs_coords)
        if localization is not None and max_obs is not None:
            idx, w_nbh = select_neighborhoods(localization, grid_info,
                                              obs_info, max_obs, selection,
                                              max_obs_strict)
            sqrt_w = safe_sqrt_keep_nan(w_nbh).to(dtype)      # [g, nb]
            poisoned = torch.isnan(sqrt_w).any(-1)            # [g]
            return idx, torch.where(poisoned[:, None], 0.0, sqrt_w), poisoned
        if localization is None:
            w_loc = torch.ones(grid_info.shape[0], obs_info.shape[0],
                               dtype=dtype, device=device)
        else:
            w_loc = localization.taper_weights(grid_info, obs_info).to(dtype)
        return None, safe_sqrt(w_loc), None                    # [g, o]


def _lienks_pseudo(mean, perts, weights, kind, epsilon, eye):
    """The pseudo-ensemble [k, g] of the per-column weights [g, k, k]
    (the bundle propagates with ``eps I + mean(W)``)."""
    if kind == "bundle":
        weights = epsilon * eye + torch.mean(weights, dim=-1, keepdim=True)
    return mean[None, :] + torch.einsum("kg,gkm->mg", perts, weights)


def _lienks_inner(weights, perts_o, innov, idx, sqrt_w, kind, tau,
                  epsilon):
    """One localized Gauss-Newton inner step per column: the normalized
    obs-space perturbations [k, o] and innovations [o] (replicated over
    the columns) scaled by each column's sqrt taper, through the
    transform or bundle step; returns the new weights [g, k, k]."""
    with span("lienks.inner"):
        if idx is not None:
            scaled_perts = (perts_o[:, idx].permute(1, 0, 2)
                            * sqrt_w[:, None, :])              # [g, k, nb]
            scaled_obs = (innov[idx] * sqrt_w)[:, None, :]
        else:
            scaled_perts = perts_o[None, :, :] * sqrt_w[:, None, :]
            scaled_obs = (innov[None, :] * sqrt_w)[:, None, :]
        if kind == "bundle":
            return ienks_bundle_step(weights, scaled_perts, scaled_obs, tau,
                                     epsilon)
        return ienks_transform_step(weights, scaled_perts, scaled_obs, tau)


def _lienks_apply(mean, perts, weights, poisoned):
    """The analysis [k, g] of the final weights, NaN in the poisoned
    columns."""
    out = mean[None, :] + torch.einsum("kg,gkm->mg", perts, weights)
    if poisoned is None:
        return out
    return torch.where(poisoned[None, :], torch.nan, out)
