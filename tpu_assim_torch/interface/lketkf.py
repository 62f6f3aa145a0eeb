"""
Localized kernelized ETKF (PyTorch port of :mod:`tpu_assim.interface.lketkf`):
a kernelized ETKF solve per grid column over its sqrt(taper)-scaled
observations, batched over the grid in chunks.

For every built-in kernel but :class:`~tpu_assim_torch.ops.kernels.
ModuleKernel`, a kernel value depends on its inputs only through dot
products or pairwise distances, so zero-scaled (masked-out) observations
contribute nothing: the fixed-size formulation equals the reference's
ragged subsets. A ModuleKernel with a nonlinear feature map sees the padded
zeros.

A strict window selection (``max_obs`` with ``selection="window"`` and
``max_obs_strict``) NaN-poisons a column with more in-support observations
than ``max_obs``. The port keeps that poison (``safe_sqrt_keep_nan``), so
such a column comes out NaN as documented; the JAX package's ``safe_sqrt``
turns it into zero weights and gives the column its prior, silently.
"""

from typing import List, Optional

import torch

from tpu_assim_torch.interface.ketkf import KETKF
from tpu_assim_torch.interface.mixin_local import (
    DomainLocalizedMixin,
    map_grid_chunked,
)
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops.cuda.letkf import cheb_degree_for
from tpu_assim_torch.ops.ketkf import ketkf_cheb_analysis, ketkf_weights
from tpu_assim_torch.ops.localization import (
    safe_sqrt,
    safe_sqrt_keep_nan,
    select_neighborhoods,
)
from tpu_assim_torch.state import EnsembleState

__all__ = ["LKETKF"]

_METHODS = ("eigh", "newton", "cheb")


def _sqrt_taper(localization, max_obs, selection, strict, grid_chunk,
                obs_info, dtype, sqrt=safe_sqrt_keep_nan):
    """``(idx, sqrt_w)`` of the chunk's columns: over fixed-size
    neighborhoods (``max_obs``), ``idx [c, nb]`` and the square roots of
    their taper weights by ``sqrt`` (by default keeping a strict window's
    NaN poison); otherwise ``None`` and ``[c, l]`` over every
    observation."""
    if localization is not None and max_obs is not None:
        idx, w_nbh = select_neighborhoods(localization, grid_chunk, obs_info,
                                          max_obs, selection, strict)
        return idx, sqrt(w_nbh).to(dtype)
    if localization is None:
        w_loc = torch.ones(grid_chunk.shape[0], obs_info.shape[0],
                           dtype=dtype, device=grid_chunk.device)
    else:
        w_loc = localization.taper_weights(grid_chunk, obs_info).to(dtype)
    return None, safe_sqrt(w_loc)


def _scaled(x, idx, sqrt_w):
    """The obs-space rows ``x [r, o]`` per column, sqrt(taper)-scaled:
    ``[c, r, nb]`` (``idx``) or ``[c, r, l]``."""
    rows = x[None] if idx is None else x[:, idx].permute(1, 0, 2)
    return rows * sqrt_w[:, None, :]


def _lketkf_solve(
    localization, chunksize, method, newton_iters, max_obs, selection,
    strict, kernel, ens_obs_perts, innovations, grid_info, obs_info,
    inf_factor,
) -> torch.Tensor:
    """Per-column weights ``[g, k, k]`` (``method`` ``"eigh"`` or
    ``"newton"``), in chunks of ``chunksize`` columns. A NaN-poisoned
    column is solved with zero inputs and given NaN weights after, since
    LAPACK raises on a NaN matrix."""

    def chunk_fn(grid_chunk):
        idx, sqrt_w = _sqrt_taper(localization, max_obs, selection, strict,
                                  grid_chunk, obs_info, ens_obs_perts.dtype)
        poisoned = torch.isnan(sqrt_w).any(-1)[:, None, None]
        sqrt_w = torch.where(poisoned[:, 0], 0.0, sqrt_w)
        weights = ketkf_weights(
            _scaled(ens_obs_perts, idx, sqrt_w),
            _scaled(innovations[None], idx, sqrt_w), kernel, inf_factor,
            method=method, newton_iters=newton_iters)
        return torch.where(poisoned, torch.nan, weights)

    return map_grid_chunked(chunk_fn, grid_info, chunksize)


def _lketkf_gram_trace_bound(
    localization, chunksize, max_obs, selection, strict, kernel,
    ens_obs_perts, grid_info, obs_info,
) -> torch.Tensor:
    """The largest per-column bound of the centred kernel Gram's trace,
    ``tr(P K P) <= tr(K) = sum_m k(z_m, z_m)`` with ``z_m`` the member's
    sqrt(taper)-scaled feature vector: the kernelized analog of LETKF's
    auto-degree bound, from diagonal kernel values only. The window is
    taken non-strict on purpose: this pass only sizes the Chebyshev degree,
    which an overflow's NaN would poison; the solve enforces strictness."""
    k = ens_obs_perts.shape[0]

    def chunk_fn(grid_chunk):
        idx, sqrt_w = _sqrt_taper(localization, max_obs, selection, False,
                                  grid_chunk, obs_info, ens_obs_perts.dtype,
                                  sqrt=safe_sqrt)
        scaled = _scaled(ens_obs_perts, idx, sqrt_w)                 # [c, k, nb]
        c, _, nb = scaled.shape
        flat = scaled.reshape(c * k, 1, nb)
        return kernel(flat, flat).reshape(c, k).sum(-1)              # [c]

    return torch.max(map_grid_chunked(chunk_fn, grid_info, chunksize))


def _lketkf_cheb_analysis(
    localization, chunksize, max_obs, selection, strict, degree, kernel,
    ens_obs_perts, innovations, grid_info, obs_info, inf_factor, data,
) -> torch.Tensor:
    """The fused kernelized solve and apply: the [v, t, k, g] analysis
    without the [g, k, k] weights or an eigendecomposition
    (:func:`tpu_assim_torch.ops.ketkf.ketkf_cheb_analysis`), one solve per
    column shared by every (var, time) slice; chunks of ``chunksize``
    columns bound the [c, k, k] Grams and [c, k, nb] gathers."""
    v, t, k, g = data.shape
    flat = data.reshape(v * t, k, g)
    mean = torch.mean(flat, dim=1)                                   # [ns, g]
    sp = flat - mean[:, None, :]                                     # [ns, k, g]

    def chunk_fn(sl):
        idx, sqrt_w = _sqrt_taper(localization, max_obs, selection, strict,
                                  grid_info[sl], obs_info,
                                  ens_obs_perts.dtype)
        return ketkf_cheb_analysis(
            _scaled(ens_obs_perts, idx, sqrt_w),
            _scaled(innovations[None], idx, sqrt_w), kernel, inf_factor,
            sp[:, :, sl], mean[:, sl], degree=degree)

    step = g if chunksize is None else max(int(chunksize), 1)
    out = torch.cat([chunk_fn(slice(i, i + step)) for i in range(0, g, step)],
                    dim=2)
    return out.reshape(v, t, k, g).to(data.dtype)


class LKETKF(DomainLocalizedMixin, KETKF):
    """Localized kernelized ETKF.

    Parameters
    ----------
    localization : Gaspari-Cohn taper (or None: every observation counts
        fully in every column).
    kernel, inf_factor, newton_iters : see
        :class:`~tpu_assim_torch.interface.ketkf.KETKF`.
    chunksize : grid columns per chunk (memory bound); None: the whole grid
        at once. With ``method="eigh"`` each chunk of at least 256 columns
        is one launch of the Jacobi kernel on the card.
    method : ``"eigh"`` (exact, default), ``"newton"``, or ``"cheb"`` (the
        fused solve and apply of :func:`_lketkf_cheb_analysis`, no weights;
        ``estimate_weights`` on a cheb instance gives the exact eigh ones).
    max_obs / selection / max_obs_strict : fixed-size neighborhoods of
        ``max_obs`` observations per column, picked by ``"topk"`` taper
        weight or by ``"window"`` over sorted 1-D coordinates. Exact where
        no column has more nonzero-taper observations than ``max_obs`` and
        the kernel is dot-product or distance based; a strict window gives
        a column with more in-support observations NaN.
    cheb_degree : the Chebyshev degree of ``"cheb"``; None measures it at
        each ``assimilate()`` from :func:`_lketkf_gram_trace_bound`.
    smoother, pre_transform, post_transform, weight_save_path,
    forward_model : see
        :class:`~tpu_assim_torch.interface.base.BaseAssimilation`.
    """

    def __init__(
        self,
        localization=None,
        kernel=None,
        inf_factor: float = 1.0,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        chunksize: Optional[int] = 4096,
        weight_save_path: Optional[str] = None,
        forward_model=None,
        method: str = "eigh",
        newton_iters: int = 25,
        max_obs: Optional[int] = None,
        selection: str = "topk",
        max_obs_strict: bool = True,
        cheb_degree: Optional[int] = None,
    ):
        if method not in _METHODS:
            raise ValueError(f"unknown method {method!r}; use one of "
                             f"{_METHODS}")
        if selection not in ("topk", "window"):
            raise ValueError(f"selection must be 'topk' or 'window'; got "
                             f"{selection!r}")
        if method == "cheb" and weight_save_path is not None:
            raise ValueError(
                "method='cheb' never builds the weight matrices; use "
                "method='eigh'/'newton' with weight_save_path")
        super().__init__(kernel=kernel, inf_factor=inf_factor,
                         smoother=smoother, pre_transform=pre_transform,
                         post_transform=post_transform,
                         weight_save_path=weight_save_path,
                         forward_model=forward_model, method=method,
                         newton_iters=newton_iters)
        self.localization = localization
        self.chunksize = chunksize
        self.max_obs = max_obs
        self.selection = selection
        self.max_obs_strict = max_obs_strict
        self.cheb_degree = cheb_degree

    def __str__(self):
        return (f"Localized KETKF(inf_factor={self.inf_factor}, "
                f"loc={self.localization}, kernel={self.kernel})")

    def __repr__(self):
        return (f"LKETKF({self.inf_factor!r},{self.localization!r},"
                f"{self.kernel!r})")

    def _auto_cheb_degree(self, ens_obs_perts, grid_info, obs_info) -> int:
        """The smallest degree with truncation error below 1e-6 on the
        measured spectral bound ``1 + max tr(Gc)/reg`` of X."""
        reg = (ens_obs_perts.shape[0] - 1) / float(self.inf_factor)
        tr_max = float(_lketkf_gram_trace_bound(
            self.localization, self.chunksize, self.max_obs, self.selection,
            self.max_obs_strict, self.kernel, ens_obs_perts, grid_info,
            obs_info))
        return cheb_degree_for(1.0 + max(tr_max, 0.0) / reg)

    def _estimate_and_apply(self, state: EnsembleState,
                            filtered_obs: List[Observation],
                            ens_obs: List[torch.Tensor]) -> EnsembleState:
        """``method="cheb"``: the fused solve and apply, one obs-space solve
        per column shared by every (var, time) slice; the math of
        estimate_weights and _apply_weights."""
        if self.method != "cheb":
            return super()._estimate_and_apply(state, filtered_obs, ens_obs)
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs)
        grid_info = state.grid_info()
        degree = self.cheb_degree
        if degree is None:
            degree = self._auto_cheb_degree(ens_obs_perts, grid_info,
                                            obs_info)
        return state.replace(data=_lketkf_cheb_analysis(
            self.localization, self.chunksize, self.max_obs, self.selection,
            self.max_obs_strict, int(degree), self.kernel, ens_obs_perts,
            innovations, grid_info, obs_info, self.inf_factor, state.data))

    def estimate_weights(self, state: EnsembleState,
                         filtered_obs: List[Observation],
                         ens_obs: List[torch.Tensor]) -> torch.Tensor:
        """Per-column weights [grid, k, k]; a cheb instance returns the
        exact (eigh) ones."""
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs)
        return _lketkf_solve(
            self.localization, self.chunksize,
            "eigh" if self.method == "cheb" else self.method,
            self.newton_iters, self.max_obs, self.selection,
            self.max_obs_strict, self.kernel, ens_obs_perts, innovations,
            state.grid_info(), obs_info, self.inf_factor)
