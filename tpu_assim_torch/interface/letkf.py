"""
Localized ETKF (PyTorch port of :mod:`tpu_assim.interface.letkf`): an
independent ETKF solve per grid column with spatially localized
observations, batched over the grid (in chunks of ``chunksize`` columns).

The weight-based methods (``eigh``, ``newton``, ``woodbury``) build the
[grid, k, k] weights and apply them. The fused methods never build them:
``cheb`` gathers each column's neighborhood and runs one Chebyshev solve per
column for every (var, time) slice of the state in kernel K4; ``fused1d``
runs the whole analysis, selection included, in kernel K1; ``fused2d`` the
whole 2-D analysis in kernel K6, wide grids as x-strips.
"""

import logging
from typing import List, Optional

import numpy as np
import torch

from tpu_assim_torch.analysis import _strip_apply_2d, _strip_plan_2d, radii_2d
from tpu_assim_torch.interface.etkf import ETKF
from tpu_assim_torch.interface.mixin_local import (
    DomainLocalizedMixin,
    map_grid_chunked,
)
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops.cuda.letkf import (
    cheb_degree_for,
    letkf_nbh_analysis_cheb,
    letkf_window_analysis_fused,
    letkf_window_analysis_fused_2d,
    max_in_support_1d,
    max_in_support_2d,
    raise_if_overflow,
    required_obs_block_2d,
    taper_name,
)
from tpu_assim_torch.ops.etkf import letkf_weights_dense, letkf_weights_nbh
from tpu_assim_torch.ops.localization import (
    GaspariCohn,
    GaspariCohnInf,
    safe_sqrt_keep_nan,
    select_neighborhoods,
)
from tpu_assim_torch.state import EnsembleState

__all__ = ["LETKF"]

logger = logging.getLogger(__name__)

_WEIGHT_METHODS = ("eigh", "newton", "woodbury")
_FUSED_METHODS = ("cheb", "fused1d", "fused2d")


class LETKF(DomainLocalizedMixin, ETKF):
    """Localized ensemble transform Kalman filter.

    Parameters
    ----------
    localization : Gaspari-Cohn taper (or None: a per-column ETKF without
        localization).
    inf_factor : multiplicative inflation rho.
    chunksize : grid columns per chunk (memory bound); None: the whole grid
        at once. ``cheb`` launches its kernel once per chunk.
    method : weight-based ``"eigh"`` (exact, default), ``"newton"``,
        ``"woodbury"`` (needs ``max_obs``); fused ``"cheb"`` (kernel K4) and
        ``"fused1d"`` (kernel K1; a single-radius Gaspari-Cohn taper on the
        first coordinate) and ``"fused2d"`` (kernel K6; a Gaspari-Cohn
        taper with per-dimension radii over the coordinates (x, y, ...)),
        which need ``localization`` and ``max_obs`` and compute in f32.
    max_obs / selection / max_obs_strict : fixed-size neighborhoods of
        ``max_obs`` observations per column, picked by ``"topk"`` taper
        weight or by ``"window"`` over sorted 1-D coordinates; strict
        window selections NaN-poison (and ``fused1d`` raises for) columns
        with more in-support observations than ``max_obs``.
    newton_iters : Newton-Schulz iterations of ``newton`` and ``woodbury``.
    cheb_degree : Chebyshev degree of the fused methods; None measures a
        spectral bound at each ``assimilate()`` and takes the smallest
        degree with truncation error below 1e-6 (:meth:`_auto_cheb_degree`).
    n_strips : the x-strips of ``fused2d`` on 2-D coordinates. None: a grid
        with more than 511 distinct x splits into strips of ~256 distinct x
        each (:func:`tpu_assim_torch.analysis.make_strip_letkf_2d`'s
        decomposition, one kernel launch for all strips); an int pins the
        count, 1 disables the split. The strip plan is built on the host
        with the strict checks and cached with the geometry and the
        localization.
    smoother, pre_transform, post_transform, weight_save_path,
    forward_model : see
        :class:`~tpu_assim_torch.interface.base.BaseAssimilation`.
    """

    def __init__(
        self,
        localization=None,
        inf_factor: float = 1.0,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        chunksize: Optional[int] = 8192,
        weight_save_path: Optional[str] = None,
        forward_model=None,
        max_obs: Optional[int] = None,
        selection: str = "topk",
        method: str = "eigh",
        newton_iters: int = 25,
        cheb_degree: Optional[int] = None,
        max_obs_strict: bool = True,
        n_strips: Optional[int] = None,
    ):
        if method not in _WEIGHT_METHODS + _FUSED_METHODS:
            raise ValueError(f"unknown method {method!r}; use one of "
                             f"{_WEIGHT_METHODS + _FUSED_METHODS}")
        if selection not in ("topk", "window"):
            raise ValueError(f"selection must be 'topk' or 'window'; got "
                             f"{selection!r}")
        if method in _FUSED_METHODS:
            if localization is None or max_obs is None:
                raise ValueError(f"method={method!r} needs localization and "
                                 "max_obs")
            if weight_save_path is not None:
                raise ValueError(
                    f"method={method!r} never builds the weight matrices; "
                    "use a weight-based method with weight_save_path")
        if method in ("fused1d", "fused2d"):
            if not isinstance(localization, (GaspariCohn, GaspariCohnInf)):
                raise TypeError(
                    f"method={method!r} needs a GaspariCohn or "
                    f"GaspariCohnInf localization; got {type(localization)}")
            if (method == "fused1d"
                    and np.atleast_1d(localization.radius).size != 1):
                raise ValueError(
                    "method='fused1d' needs a single-radius localization; "
                    f"got {localization.radius}")
        super().__init__(inf_factor=inf_factor, smoother=smoother,
                         pre_transform=pre_transform,
                         post_transform=post_transform,
                         weight_save_path=weight_save_path,
                         forward_model=forward_model)
        self.localization = localization
        self.chunksize = chunksize
        self.max_obs = max_obs
        self.selection = selection
        self.method = method
        self.newton_iters = newton_iters
        self.cheb_degree = cheb_degree
        self.max_obs_strict = max_obs_strict
        self.n_strips = n_strips
        self._warned_f32 = False
        # fused2d: (key, host-side results) of the last geometry
        self._geometry_cache = None

    def __str__(self):
        return (f"Localized ETKF(inf_factor={self.inf_factor}, "
                f"loc={self.localization})")

    def __repr__(self):
        return f"LETKF({self.inf_factor!r},{self.localization!r})"

    def _neighborhoods(self, grid_info, obs_info):
        """``(idx [c, max_obs], weights [c, max_obs])`` of the chunk's
        columns."""
        return select_neighborhoods(self.localization, grid_info, obs_info,
                                    self.max_obs, self.selection,
                                    self.max_obs_strict)

    def estimate_weights(self, state: EnsembleState,
                         filtered_obs: List[Observation],
                         ens_obs: List[torch.Tensor]) -> torch.Tensor:
        """Per-column weights [grid, k, k]; a fused instance returns the
        exact (eigh) ones."""
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs)
        method = "eigh" if self.method in _FUSED_METHODS else self.method
        dtype = ens_obs_perts.dtype

        def chunk_fn(grid_chunk):
            if self.localization is not None and self.max_obs is not None:
                idx, w_nbh = self._neighborhoods(grid_chunk, obs_info)
                return letkf_weights_nbh(
                    ens_obs_perts, innovations, idx, w_nbh.to(dtype),
                    self.inf_factor, method=method,
                    newton_iters=self.newton_iters)
            return letkf_weights_dense(
                ens_obs_perts, innovations,
                self._localized_obs_weights(grid_chunk, obs_info, dtype),
                self.inf_factor, method=method,
                newton_iters=self.newton_iters)

        return map_grid_chunked(chunk_fn, state.grid_info(), self.chunksize)

    def _auto_cheb_degree(self, ens_obs_perts, obs_info, grid_info) -> int:
        """Chebyshev degree from a measured spectral bound.

        Per column the solve operator ``X = I + Zh Zh^T / reg`` has its
        spectrum in ``[1, 1 + tr(S)/reg]`` with ``tr(S) = sum_o w_o
        ||z_o||^2`` and taper weights ``w <= 1``. For the window selections
        the bound is the largest sum of ``||z_o||^2`` over ``max_obs``
        consecutive sorted observations; otherwise ``max_c sum_o w_co
        ||z_o||^2``, chunked. The degree follows from the Chebyshev
        convergence rate (:func:`cheb_degree_for`, tol 1e-6).
        """
        k = ens_obs_perts.shape[0]
        reg = (k - 1) / float(self.inf_factor)
        znorm = torch.sum(ens_obs_perts.to(torch.float32) ** 2, dim=0)  # [o]
        if self.method == "fused1d" or self.selection == "window":
            zs = znorm[torch.argsort(obs_info[:, 1], stable=True)]
            cs = torch.cat([zs.new_zeros(1), torch.cumsum(zs, dim=0)])
            width = min(self.max_obs, zs.shape[0])
            tr_max = float(torch.max(cs[width:] - cs[:-width]))
        else:
            tr = map_grid_chunked(
                lambda gi: self.localization.taper_weights(
                    gi, obs_info).double() @ znorm.double(),
                grid_info, self.chunksize)
            tr_max = float(torch.max(tr))
        return cheb_degree_for(1.0 + tr_max / reg)

    def _estimate_and_apply(self, state: EnsembleState,
                            filtered_obs: List[Observation],
                            ens_obs: List[torch.Tensor]) -> EnsembleState:
        """The fused solve and apply of ``cheb``, ``fused1d`` and
        ``fused2d``: one obs-space solve per column shared by every (var,
        time) slice, the weights never built; the same analysis as
        estimate_weights and _apply_weights.

        On the host: ``fused1d`` sorts the stacked observations by
        coordinate (the taper is blind to time, so sorting is exact) and,
        when strict, checks the in-support bound; ``fused2d`` takes its
        band width, checks and strip plan from :meth:`_fused2d_geometry`;
        the Chebyshev degree is measured unless pinned. The kernels compute
        in f32: an f64 state comes back as f64 with f32 accuracy.
        """
        if self.method not in _FUSED_METHODS:
            return super()._estimate_and_apply(state, filtered_obs, ens_obs)
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs)
        grid_info = state.grid_info()
        if state.dtype == torch.float64 and not self._warned_f32:
            logger.warning(
                "LETKF(method=%r) computes in float32; the float64 analysis "
                "carries f32 accuracy (~1e-6 relative). Use method='eigh' "
                "for the f64 oracle path.", self.method)
            self._warned_f32 = True

        if self.method == "fused1d":
            obs_x = obs_info[:, 1].detach().cpu().numpy()
            if obs_x.shape[0] > 1 and np.any(obs_x[1:] < obs_x[:-1]):
                order = np.argsort(obs_x, kind="stable")
                obs_x = obs_x[order]
                order = torch.as_tensor(order, device=obs_info.device)
                innovations = innovations[order]
                ens_obs_perts = ens_obs_perts[:, order]
                obs_info = obs_info[order]
            if self.max_obs_strict:
                raise_if_overflow(max_in_support_1d(
                    obs_x, grid_info[:, 1].detach().cpu().numpy(),
                    float(np.atleast_1d(self.localization.radius)[0]),
                    taper=taper_name(self.localization),
                    epsilon=float(self.localization.epsilon)), self.max_obs)
        geometry = (self._fused2d_geometry(grid_info, obs_info)
                    if self.method == "fused2d" else None)
        degree = self.cheb_degree
        if degree is None:
            degree = self._auto_cheb_degree(ens_obs_perts, obs_info,
                                            grid_info)
            logger.debug("auto cheb_degree=%d", degree)
        return state.replace(data=self._fused_analysis(
            ens_obs_perts, innovations, grid_info, obs_info, state.data,
            degree, geometry))

    def _fused2d_geometry(self, grid_info, obs_info) -> dict:
        """The host side of ``fused2d`` for one grid, observation network
        and localization: the exact band width, the strict in-support
        check, the strip count (auto: distinct grid x // 256) and, with more
        than one strip on 2-D coordinates, the strip plan. Cached under a
        key of the localization (radii, taper, epsilon), ``max_obs``,
        ``max_obs_strict`` and ``n_strips``, together with a copy of the
        coordinates on their device: a repeated ``assimilate()`` compares
        the coordinates there (``torch.equal``) and copies nothing to the
        host."""
        n_dims = min(grid_info.shape[1], obs_info.shape[1]) - 1
        coords = tuple(info[:, 1:1 + n_dims].detach()
                       for info in (grid_info, obs_info))
        loc = self.localization
        taper, eps = taper_name(loc), float(loc.epsilon)
        key = (tuple(np.atleast_1d(loc.radius).tolist()), taper, eps,
               self.max_obs, self.max_obs_strict, self.n_strips)
        if (self._geometry_cache and self._geometry_cache[0] == key
                and all(a.shape == b.shape and a.dtype == b.dtype
                        and a.device == b.device and torch.equal(a, b)
                        for a, b in zip(self._geometry_cache[1]["coords"],
                                        coords))):
            return self._geometry_cache[1]
        gxy, oxy = (np.ascontiguousarray(c.cpu().numpy()) for c in coords)
        rx, ry, extra = radii_2d(loc, n_dims)
        if self.max_obs_strict:
            raise_if_overflow(max_in_support_2d(
                oxy[:, :2], gxy[:, :2], rx, ry, taper=taper, epsilon=eps),
                self.max_obs)
        n_strips = self.n_strips
        if n_strips is None and n_dims == 2:
            n_strips = max(1, np.unique(gxy[:, 0]).size // 256)
        plan = None
        if n_strips and n_strips > 1 and n_dims == 2:
            logger.debug("fused2d x-strips: n_strips=%d", n_strips)
            plan = _strip_plan_2d(loc, gxy, oxy, int(n_strips), self.max_obs,
                                  self.max_obs_strict)
        geometry = {"n_dims": n_dims, "radii": (rx, ry, extra), "plan": plan,
                    "obs_block": required_obs_block_2d(oxy[:, 1], gxy[:, 1],
                                                       ry),
                    "coords": tuple(c.clone() for c in coords)}
        self._geometry_cache = (key, geometry)
        return geometry

    def _fused_analysis(self, ens_obs_perts, innovations, grid_info,
                        obs_info, data, degree, geometry=None
                        ) -> torch.Tensor:
        """The [v, t, k, g] analysis through K1 (``fused1d``), K6
        (``fused2d``, one launch, over the strips of ``geometry["plan"]``
        where it has one) or K4 (``cheb``, one launch per chunk of
        ``chunksize`` columns), with the ns = v t state slices stacked."""
        f32 = torch.float32
        v, t, k, g = data.shape
        flat = data.reshape(v * t, k, g)
        mean = torch.mean(flat, dim=1)                           # [vt, g]
        sp = flat - mean[:, None, :]                             # [vt, k, g]
        reg = (k - 1) / float(self.inf_factor)

        if self.method == "fused2d" and geometry["plan"] is not None:
            out = _strip_apply_2d(geometry["plan"], ens_obs_perts,
                                  innovations, sp, mean, reg, degree)
        elif self.method == "fused2d":
            n_dims = geometry["n_dims"]
            rx, ry, extra = geometry["radii"]
            out = letkf_window_analysis_fused_2d(
                *(x.to(f32).contiguous() for x in (ens_obs_perts,
                                                   innovations)),
                obs_info[:, 1:1 + n_dims], grid_info[:, 1:1 + n_dims],
                *(x.to(f32).contiguous() for x in (sp, mean)), reg, rx, ry,
                k, obs_block=geometry["obs_block"], nb=self.max_obs,
                degree=degree, taper=taper_name(self.localization),
                epsilon=float(self.localization.epsilon),
                strict=self.max_obs_strict, extra_radii=extra)
        elif self.method == "fused1d":
            out = letkf_window_analysis_fused(
                *(x.to(f32).contiguous() for x in (
                    ens_obs_perts, innovations, obs_info[:, 1],
                    grid_info[:, 1], sp, mean)),
                reg, float(np.atleast_1d(self.localization.radius)[0]), k,
                nb=self.max_obs, degree=degree,
                taper=taper_name(self.localization),
                epsilon=float(self.localization.epsilon),
                strict=self.max_obs_strict)
        else:
            def cheb_chunk(sl):
                idx, w_nbh = self._neighborhoods(grid_info[sl], obs_info)
                sw = safe_sqrt_keep_nan(w_nbh).to(ens_obs_perts.dtype)
                zh = ens_obs_perts[:, idx].permute(2, 0, 1) * sw.T[:, None]
                yh = innovations[idx].T * sw.T                    # [nb, c]
                return letkf_nbh_analysis_cheb(
                    *(x.to(f32).contiguous() for x in (
                        zh, yh, sp[:, :, sl], mean[:, sl])),
                    reg, k, degree=degree)                        # [vt, k, c]

            step = g if self.chunksize is None else max(int(self.chunksize),
                                                        1)
            out = torch.cat([cheb_chunk(slice(i, i + step))
                             for i in range(0, g, step)], dim=2)
        return out.reshape(v, t, k, g).to(data.dtype)
