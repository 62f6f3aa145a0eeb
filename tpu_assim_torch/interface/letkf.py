"""
Localized ETKF (PyTorch port of :mod:`tpu_assim.interface.letkf`): an
independent ETKF solve per grid column with spatially localized
observations, batched over the grid (in chunks of ``chunksize`` columns).

The weight-based methods (``eigh``, ``newton``, ``woodbury``) build the
[grid, k, k] weights and apply them. The fused methods never build them:
``cheb`` gathers each column's neighborhood and runs one Chebyshev solve per
column for every (var, time) slice of the state in kernel K4; ``fused1d``
runs the whole analysis, selection included, in kernel K1.
"""

import logging
from typing import List, Optional

import numpy as np
import torch

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
    max_in_support_1d,
    raise_if_overflow,
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
_FUSED_METHODS = ("cheb", "fused1d")


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
        first coordinate), which need ``localization`` and ``max_obs`` and
        compute in f32. ``"fused2d"`` is not ported yet and raises.
    max_obs / selection / max_obs_strict : fixed-size neighborhoods of
        ``max_obs`` observations per column, picked by ``"topk"`` taper
        weight or by ``"window"`` over sorted 1-D coordinates; strict
        window selections NaN-poison (and ``fused1d`` raises for) columns
        with more in-support observations than ``max_obs``.
    newton_iters : Newton-Schulz iterations of ``newton`` and ``woodbury``.
    cheb_degree : Chebyshev degree of the fused methods; None measures a
        spectral bound at each ``assimilate()`` and takes the smallest
        degree with truncation error below 1e-6 (:meth:`_auto_cheb_degree`).
    n_strips : the x-strips of ``fused2d``; accepted for parity with the
        JAX signature.
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
        if method == "fused2d":
            raise NotImplementedError(
                "method='fused2d' is not ported yet: ROADMAP.md Queue 2 K6")
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
        if method == "fused1d":
            if not isinstance(localization, (GaspariCohn, GaspariCohnInf)):
                raise TypeError(
                    "method='fused1d' needs a GaspariCohn or GaspariCohnInf "
                    f"localization; got {type(localization)}")
            if np.atleast_1d(localization.radius).size != 1:
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
        """The fused solve and apply of ``cheb`` and ``fused1d``: one
        obs-space solve per column shared by every (var, time) slice, the
        weights never built; the same analysis as estimate_weights and
        _apply_weights.

        On the host: ``fused1d`` sorts the stacked observations by
        coordinate (the taper is blind to time, so sorting is exact) and,
        when strict, checks the in-support bound; the Chebyshev degree is
        measured unless pinned. The kernels compute in f32: an f64 state
        comes back as f64 with f32 accuracy.
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
        degree = self.cheb_degree
        if degree is None:
            degree = self._auto_cheb_degree(ens_obs_perts, obs_info,
                                            grid_info)
            logger.debug("auto cheb_degree=%d", degree)
        return state.replace(data=self._fused_analysis(
            ens_obs_perts, innovations, grid_info, obs_info, state.data,
            degree))

    def _fused_analysis(self, ens_obs_perts, innovations, grid_info,
                        obs_info, data, degree) -> torch.Tensor:
        """The [v, t, k, g] analysis through K1 (``fused1d``) or K4
        (``cheb``, one launch per chunk of ``chunksize`` columns), with the
        ns = v t state slices stacked."""
        f32 = torch.float32
        v, t, k, g = data.shape
        flat = data.reshape(v * t, k, g)
        mean = torch.mean(flat, dim=1)                           # [vt, g]
        sp = flat - mean[:, None, :]                             # [vt, k, g]
        reg = (k - 1) / float(self.inf_factor)

        if self.method == "fused1d":
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
