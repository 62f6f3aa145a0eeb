"""
Analysis and cycle steps (PyTorch port of :mod:`tpu_assim.analysis`).

The complete analysis — obs operator, R^{-1/2} normalization, innovation,
Gaspari-Cohn taper, weight solve and weight application — runs on the
device of the state tensor. Two LETKF solvers are ported:

- ``method="eigh"``: exact eigendecomposition over the dense taper, the f64
  oracle;
- ``method="fused1d"``: the whole analysis in one CUDA kernel
  (:func:`tpu_assim_torch.ops.cuda.letkf.letkf_window_analysis_fused`).

The other solvers of the JAX package raise ``NotImplementedError`` and name
their ROADMAP.md item.
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
    letkf_window_analysis_fused,
    max_in_support_1d,
)
from tpu_assim_torch.ops.etkf import etkf_weights, letkf_weights_dense
from tpu_assim_torch.ops.localization import GaspariCohnInf

__all__ = ["make_cycle_step", "make_etkf_analysis", "make_letkf_analysis"]

_NOT_PORTED = {
    "newton": "ROADMAP.md Queue 1 item 2 (Newton-Schulz solves)",
    "woodbury": "ROADMAP.md Queue 1 item 2 (Woodbury solve)",
    "cheb": "ROADMAP.md Queue 1 item 9 (method='cheb', kernel K4)",
    "pallas": "ROADMAP.md Queue 1 item 9 (method='pallas', kernel K5)",
    "fused2d": "ROADMAP.md Queue 1 item 9 (method='fused2d', kernel K6)",
}


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


def _raise_if_overflow(worst: int, max_obs: int) -> None:
    """Loud failure for the window kernel's exactness condition."""
    if worst > max_obs:
        raise ValueError(
            f"a grid column has {worst} in-support (nonzero-taper) "
            f"observations but max_obs={max_obs}: the window selection "
            f"would truncate. Raise max_obs to >= {worst} or pass "
            "max_obs_strict=False to accept truncation to the nearest "
            "observations."
        )


def _taper_name(localization) -> str:
    return "gcinf" if isinstance(localization, GaspariCohnInf) else "gc2"


def make_letkf_analysis(
    localization,
    inf_factor: float = 1.0,
    chunksize: Optional[int] = None,
    obs_operator: Optional[Callable] = None,
    method: str = "eigh",
    max_obs: Optional[int] = None,
    cheb_degree: int = 16,
    max_obs_strict: bool = True,
    geometry: Optional[tuple] = None,
):
    """Build a single-cycle LETKF analysis.

    Parameters
    ----------
    localization : Gaspari-Cohn taper object (or None: unlocalized).
    inf_factor : inflation rho.
    chunksize : grid columns per chunk of the dense taper (memory bound).
    obs_operator : optional callable ``[..., grid] -> [..., obs]``; by
        default the observations are point observations at ``obs_idx``.
    method : ``"eigh"`` — exact eigendecomposition over the dense taper
        (``max_obs`` must be None); ``"fused1d"`` — the whole analysis in
        one kernel, for sorted 1-D obs coordinates (column 0 of the
        coordinates) and a single-radius Gaspari-Cohn taper; needs
        ``max_obs``.
    max_obs : the window size of ``fused1d``.
    cheb_degree : Chebyshev degree of ``fused1d``.
    max_obs_strict : ``fused1d`` raises at call (or build) time when a
        column has more in-support observations than ``max_obs``, and the
        kernel NaN-poisons such columns; False accepts truncation to the
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
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet: {_NOT_PORTED[method]}")
    if method not in ("eigh", "fused1d"):
        raise ValueError(f"unknown method {method!r}")
    if method == "eigh" and max_obs is not None:
        raise NotImplementedError(
            "method='eigh' with max_obs needs the neighborhood selections, "
            "not ported yet: ROADMAP.md Queue 1 item 2 "
            "(neighborhood_select, neighborhood_select_window)")
    fused = method == "fused1d"
    if fused:
        if localization is None or max_obs is None:
            raise ValueError("method='fused1d' needs a localization and "
                             "max_obs")
        radius = np.atleast_1d(np.asarray(localization.radius, dtype=float))
        if radius.size != 1:
            raise ValueError("method='fused1d' supports a single "
                             f"localization radius; got {radius}")
        radius = float(radius[0])
        taper = _taper_name(localization)
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
            _raise_if_overflow(
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

        # localization info rows: a time column (zero), then the coords
        def with_time(coords):
            return torch.cat([torch.zeros_like(coords[:, :1]), coords], dim=1)

        obs_info = with_time(obs_coords)

        def chunk_fn(g_chunk):
            if localization is None:
                w_loc = torch.ones(g_chunk.shape[0], obs_info.shape[0],
                                   dtype=perts.dtype, device=perts.device)
            else:
                w_loc = localization.taper_weights(g_chunk, obs_info).to(
                    perts.dtype)
            return letkf_weights_dense(perts, innov, w_loc, inf_factor)

        weights = map_grid_chunked(chunk_fn, with_time(grid_coords),
                                   chunksize)                      # [g,k,k]
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

    def _forecast(state_data):
        if supports_fused_rk4(integrator, state_data.shape,
                              state_data.element_size()):
            return fused_rk4_steps(integrator.model, state_data,
                                   integrator.dt, n_int_steps)
        for _ in range(n_int_steps):
            state_data = integrator.integrate(state_data)
        return state_data

    def step(state_data, *args):
        return analyse(_forecast(state_data), *args)

    return step
