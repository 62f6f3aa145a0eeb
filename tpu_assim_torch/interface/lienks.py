"""
Localized iterative ensemble Kalman smoother, transform and bundle
(PyTorch port of :mod:`tpu_assim.interface.lienks`): the IEnKS inner step
per grid column, batched [g, k, k], on sqrt-taper-scaled obs-space inputs.

The columns go in slices of ``chunksize`` (the JAX package pads its
chunks to one size; a slice has the same columns and spends no SVD on
padding). Each slice takes its taper weights, dense or over fixed-size
neighborhoods (``max_obs``), and its inner step, whose two batched SVDs
go to the one-sided Jacobi kernel for f32 slices of at least 256 columns
on the card.

A column that the strict window selection poisons (more in-support
observations than ``max_obs``) is solved with zero inputs, so its
weights stay finite through every outer iteration (the forward model
couples neighbouring columns, so a NaN weight would spread), and the
analysis carries NaN in that column. The JAX package scales by
``safe_sqrt``, which takes the poison for zero taper weights: it gives
such a column the same weights, and a finite analysis there.
"""

from typing import Callable, List, Optional, Tuple

import torch

from tpu_assim_torch.interface.ienks import IEnKSBundle, IEnKSTransform
from tpu_assim_torch.interface.mixin_local import DomainLocalizedMixin
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops.ienks import ienks_bundle_step, ienks_transform_step
from tpu_assim_torch.ops.localization import (
    safe_sqrt,
    safe_sqrt_keep_nan,
    select_neighborhoods,
)
from tpu_assim_torch.state import EnsembleState

__all__ = ["LocalizedIEnKSBundle", "LocalizedIEnKSTransform"]


class LocalizedIEnKSTransform(DomainLocalizedMixin, IEnKSTransform):
    """Localized IEnKS, transform version.

    Parameters
    ----------
    forward_model : callable ``(state, iter_num) -> (state, pseudo_state)``.
    localization : taper with ``taper_weights(grid_info, obs_info)``
        (None: every observation counts fully).
    tau : learning rate in [0, 1].
    chunksize : grid columns per slice (None: all at once).
    max_obs / selection / max_obs_strict : fixed-size neighborhoods of the
        ``max_obs`` largest taper weights (``"topk"``) or a window around
        each column's rank among the sorted observations (``"window"``;
        strict: a column with more in-support observations than
        ``max_obs`` comes out NaN). ``max_obs=None`` takes the dense taper.
    max_iter, smoother, pre_transform, post_transform, weight_save_path :
        see :class:`~tpu_assim_torch.interface.variational.VarAssimilation`.
    """

    _step_kind = "transform"

    def __init__(
        self,
        forward_model: Callable,
        localization=None,
        tau: float = 1.0,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        chunksize: Optional[int] = 4096,
        weight_save_path: Optional[str] = None,
        max_obs: Optional[int] = None,
        selection: str = "topk",
        max_obs_strict: bool = True,
    ):
        super().__init__(
            forward_model=forward_model,
            tau=tau,
            max_iter=max_iter,
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
        )
        self._set_localized(localization, chunksize, max_obs, selection,
                            max_obs_strict)

    def _set_localized(self, localization, chunksize, max_obs, selection,
                       max_obs_strict):
        if selection not in ("topk", "window"):
            raise ValueError(f"selection must be 'topk' or 'window'; got "
                             f"{selection!r}")
        self.localization = localization
        self.chunksize = chunksize
        self.max_obs = max_obs
        self.selection = selection
        self.max_obs_strict = max_obs_strict
        # [grid] columns the strict window poisons, set by inner_loop
        self._poisoned = None

    def __str__(self):
        return "Localized IEnKSTransform(loc={0}, tau={1})".format(
            str(self.localization), self.tau
        )

    def __repr__(self):
        return "LIEnKSTransform({0},{1})".format(
            repr(self.localization), repr(self.tau)
        )

    def _initial_weights(self, state: EnsembleState) -> torch.Tensor:
        """The identity of every column, [g, k, k] (a view). The weights are
        per column from the first inner step on; starting so makes the
        first propagation the batched product of ``make_lienks_step``,
        rounding included, where the JAX class propagates with [k, k]
        weights. The bundle divides the propagated perturbations by
        ``epsilon``, which magnifies that rounding in f32 to the size of
        the bundle's own f32 error."""
        eye = super()._initial_weights(state)
        return eye.expand(state.n_grid, *eye.shape)

    def _lienks_solve(
        self,
        weights: torch.Tensor,
        ens_obs_perts: torch.Tensor,
        innovations: torch.Tensor,
        grid_info: torch.Tensor,
        obs_info: torch.Tensor,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One inner step of every column: the weights [g, k, k], and the
        [g] mask of the columns the strict window poisons (None without
        neighborhoods)."""
        n_grid = grid_info.shape[0]
        ens_size = ens_obs_perts.shape[-2]
        dtype = ens_obs_perts.dtype
        if weights.ndim == 2:
            weights = weights.expand(n_grid, ens_size, ens_size)
        nbh = self.localization is not None and self.max_obs is not None
        epsilon = getattr(self, "epsilon", 0.0)

        def chunk_fn(grid_chunk, w_chunk):
            poisoned = None
            if nbh:
                idx, w_nbh = select_neighborhoods(
                    self.localization, grid_chunk, obs_info, self.max_obs,
                    self.selection, self.max_obs_strict)
                sqrt_w = safe_sqrt_keep_nan(w_nbh).to(dtype)   # [c, nb]
                # no SVD sees the poison: zero inputs in its place
                poisoned = torch.isnan(sqrt_w).any(-1)
                sqrt_w = torch.where(poisoned[:, None], 0.0, sqrt_w)
                scaled_perts = (ens_obs_perts[:, idx].permute(1, 0, 2)
                                * sqrt_w[:, None, :])          # [c, k, nb]
                scaled_obs = (innovations[idx] * sqrt_w)[:, None, :]
            else:
                # safe_sqrt: zero taper weights give a zero gradient
                sqrt_w = safe_sqrt(self._localized_obs_weights(
                    grid_chunk, obs_info, dtype))              # [c, l]
                scaled_perts = ens_obs_perts[None] * sqrt_w[:, None, :]
                scaled_obs = (innovations[None, :] * sqrt_w)[:, None, :]
            if self._step_kind == "bundle":
                w_chunk = ienks_bundle_step(w_chunk, scaled_perts,
                                            scaled_obs, self.tau, epsilon)
            else:
                w_chunk = ienks_transform_step(w_chunk, scaled_perts,
                                               scaled_obs, self.tau)
            return w_chunk, poisoned

        size = n_grid if self.chunksize is None else self.chunksize
        parts = [chunk_fn(grid_info[i:i + size], weights[i:i + size])
                 for i in range(0, n_grid, size)]
        weights = torch.cat([w for w, _ in parts])
        if not nbh:
            return weights, None
        return weights, torch.cat([p for _, p in parts])

    def inner_loop(
        self,
        state: EnsembleState,
        weights: torch.Tensor,
        filtered_obs: List[Observation],
        ens_obs: List[torch.Tensor],
    ) -> torch.Tensor:
        innovations, ens_obs_perts, obs_info = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        weights, self._poisoned = self._lienks_solve(
            weights, ens_obs_perts, innovations, state.grid_info(), obs_info)
        return weights

    def update_state(
        self,
        state: EnsembleState,
        observations,
        pseudo_state: Optional[EnsembleState],
        analysis_time: float,
    ) -> EnsembleState:
        """The outer loop; then NaN in the columns the strict window
        poisons."""
        self._poisoned = None
        analysis = super().update_state(state, observations, pseudo_state,
                                        analysis_time)
        poisoned, self._poisoned = self._poisoned, None
        if poisoned is None:
            return analysis
        return analysis.replace(
            data=torch.where(poisoned, torch.nan, analysis.data))


class LocalizedIEnKSBundle(LocalizedIEnKSTransform, IEnKSBundle):
    """Localized IEnKS, bundle version (finite-difference scale
    ``epsilon``); the parameters of :class:`LocalizedIEnKSTransform`."""

    _step_kind = "bundle"

    def __init__(
        self,
        forward_model: Callable,
        localization=None,
        tau: float = 1.0,
        epsilon: float = 1e-4,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        chunksize: Optional[int] = 4096,
        weight_save_path: Optional[str] = None,
        max_obs: Optional[int] = None,
        selection: str = "topk",
        max_obs_strict: bool = True,
    ):
        IEnKSBundle.__init__(
            self,
            forward_model=forward_model,
            tau=tau,
            epsilon=epsilon,
            max_iter=max_iter,
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
        )
        self._set_localized(localization, chunksize, max_obs, selection,
                            max_obs_strict)

    def __str__(self):
        return "Localized IEnKSBundle(loc={0}, eps={1}, tau={2})".format(
            str(self.localization), self.epsilon, self.tau
        )

    def __repr__(self):
        return "LIEnKSBundle({0},{1},{2})".format(
            repr(self.localization), repr(self.epsilon), repr(self.tau)
        )
