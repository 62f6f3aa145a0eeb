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
  (:func:`tpu_assim_torch.ops.cuda.letkf.letkf_window_analysis_fused`).

``method="fused2d"`` raises ``NotImplementedError`` and names its
ROADMAP.md item. :func:`make_lienks_step` is the localized IEnKS smoother.
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
    max_in_support_1d,
    raise_if_overflow,
    taper_name,
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
)

__all__ = ["make_cycle_step", "make_etkf_analysis", "make_letkf_analysis",
           "make_lienks_step"]

_NOT_PORTED = {
    "fused2d": "ROADMAP.md Queue 2 K6 (method='fused2d', kernel K6)",
}
_METHODS = ("eigh", "newton", "woodbury", "cheb", "pallas", "fused1d")
# methods that need a localization and max_obs
_NBH_METHODS = ("woodbury", "cheb", "pallas", "fused1d")


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


def _check_selection(selection: str) -> None:
    if selection not in ("topk", "window"):
        raise ValueError(f"selection must be 'topk' or 'window'; got "
                         f"{selection!r}")


def _forecast(integrator, n_steps: int, state_data):
    """``n_steps`` of ``integrator``: the fused RK4 kernel wherever
    :func:`supports_fused_rk4` holds, else the integrator's own steps."""
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
        single-radius Gaspari-Cohn taper. ``woodbury``, ``cheb``,
        ``pallas`` and ``fused1d`` need a localization and ``max_obs``.
    newton_iters : Newton-Schulz iterations of ``newton``, ``woodbury`` and
        ``pallas``.
    max_obs : the neighborhood size (None with ``eigh``/``newton``: the
        dense taper) and the window size of ``fused1d``.
    cheb_degree : Chebyshev degree of ``cheb`` and ``fused1d``.
    selection : how the neighborhoods are picked: ``"topk"`` (largest
        taper weights) or ``"window"`` (sorted 1-D obs coordinates; see
        :func:`tpu_assim_torch.ops.localization.neighborhood_select_window`).
    obs_block : accepted for parity with the JAX signature and ignored: the
        window kernel searches the whole coordinate table.
    max_obs_strict : the window selections NaN-poison columns with more
        in-support observations than ``max_obs``, and ``fused1d`` also
        raises at call (or build) time; False accepts truncation to the
        nearest.
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
    del obs_block
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet: {_NOT_PORTED[method]}")
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
        taper = taper_name(localization)
        epsilon = float(localization.epsilon)

    def _host_harden(obs_coords_np, grid_coords_np):
        """Sortedness and, when strict, the in-support bound of fused1d,
        checked on the host."""
        if not fused:
            return
        ox = obs_coords_np[:, 0]
        if ox.shape[0] > 1 and np.any(ox[1:] < ox[:-1]):
            raise ValueError("method='fused1d' needs obs coordinates sorted "
                             "ascending along dimension 0")
        if max_obs_strict:
            raise_if_overflow(
                max_in_support_1d(ox, grid_coords_np[:, 0], radius,
                                  taper=taper, epsilon=epsilon),
                max_obs)

    def _impl(state_data, obs_vals, obs_var, obs_idx, grid_coords,
              obs_coords):
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
        _host_harden(g_obs, g_grid)
        on_device = {}

        def analysis_fn_static(state_data, obs_vals, obs_var):
            dev = state_data.device
            if dev not in on_device:
                on_device[dev] = tuple(
                    None if a is None else torch.as_tensor(a, device=dev)
                    for a in (g_idx, g_grid, g_obs))
            return _impl(state_data, obs_vals, obs_var, *on_device[dev])

        return analysis_fn_static

    def analysis_fn(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                    obs_coords):
        if fused:
            _host_harden(obs_coords.detach().cpu().numpy(),
                         grid_coords.detach().cpu().numpy())
        return _impl(state_data, obs_vals, obs_var, obs_idx, grid_coords,
                     obs_coords)

    return analysis_fn


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
        return analyse(_forecast(integrator, n_int_steps, state_data), *args)

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
    f32 batches on CUDA. The neighborhood selection and its ``safe_sqrt``
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
        takes the dense taper.

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
        k, g = state_data.shape
        dtype, device = state_data.dtype, state_data.device
        mean = torch.mean(state_data, dim=0)
        perts = state_data - mean[None, :]                     # [k, g]
        grid_info = _with_time(grid_coords)
        obs_info = _with_time(obs_coords)
        if localization is not None and max_obs is not None:
            idx, w_nbh = select_neighborhoods(localization, grid_info,
                                              obs_info, max_obs, selection,
                                              max_obs_strict)
            sqrt_w = safe_sqrt(w_nbh).to(dtype)               # [g, nb]
        else:
            idx = None
            if localization is None:
                w_loc = torch.ones(g, obs_info.shape[0], dtype=dtype,
                                   device=device)
            else:
                w_loc = localization.taper_weights(grid_info,
                                                   obs_info).to(dtype)
            sqrt_w = safe_sqrt(w_loc)                          # [g, o]

        eye = torch.eye(k, dtype=dtype, device=device)
        weights = eye.expand(g, k, k)
        for _ in range(n_outer):
            if kind == "bundle":
                # the bundle propagates with eps I + mean(W)
                w_model = epsilon * eye + torch.mean(weights, dim=-1,
                                                     keepdim=True)
            else:
                w_model = weights
            pseudo = mean[None, :] + torch.einsum("kg,gkm->mg", perts,
                                                  w_model)
            pseudo = _forward(pseudo)
            if obs_operator is None:
                ens_obs = pseudo[:, obs_idx]                   # [k, o]
            else:
                ens_obs = obs_operator(pseudo)
            perts_o, innov = _normalized_obs_space(ens_obs, obs_vals,
                                                   obs_var)
            if idx is not None:
                scaled_perts = (perts_o[:, idx].permute(1, 0, 2)
                                * sqrt_w[:, None, :])          # [g, k, nb]
                scaled_obs = (innov[idx] * sqrt_w)[:, None, :]
            else:
                scaled_perts = perts_o[None, :, :] * sqrt_w[:, None, :]
                scaled_obs = (innov[None, :] * sqrt_w)[:, None, :]
            if kind == "bundle":
                weights = ienks_bundle_step(weights, scaled_perts,
                                            scaled_obs, tau, epsilon)
            else:
                weights = ienks_transform_step(weights, scaled_perts,
                                               scaled_obs, tau)
        return mean[None, :] + torch.einsum("kg,gkm->mg", perts, weights)

    return step
