"""
Filtering-mode assimilation template (PyTorch port of
:mod:`tpu_assim.interface.filter`): subclasses implement
``estimate_weights``; this class slices to the analysis time, applies the
observation operators and applies the weights.
"""

from typing import List, Optional, Sequence, Tuple

import torch

from tpu_assim_torch.interface.base import BaseAssimilation
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.state import EnsembleState

__all__ = ["FilterAssimilation"]


class FilterAssimilation(BaseAssimilation):
    """Abstract class of the ensemble Kalman filters."""

    def _slice_analysis(
        self,
        analysis_time: float,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: EnsembleState,
    ) -> Tuple[EnsembleState, List[Observation], EnsembleState]:
        """State, observations and pseudo state at the analysis time."""
        state = state.sel_time_index(state.time_index(analysis_time))
        pseudo_state = pseudo_state.sel_time_index(
            pseudo_state.time_index(analysis_time))
        observations = [obs.sel_time(analysis_time) for obs in observations]
        return state, observations, pseudo_state

    def estimate_weights(self, state: EnsembleState,
                         filtered_obs: List[Observation],
                         ens_obs: List[torch.Tensor]) -> torch.Tensor:
        """The ensemble weights, global [k, m] or per column [grid, k, m]
        (abstract)."""
        raise NotImplementedError

    def update_state(self, state: EnsembleState,
                     observations: Sequence[Observation],
                     pseudo_state: Optional[EnsembleState],
                     analysis_time: float) -> EnsembleState:
        prior_weights = self.generate_prior_weights(
            state.ens_size, dtype=state.dtype, device=state.device)
        pseudo_state = self.get_pseudo_state(
            pseudo_state=pseudo_state, state=state, weights=prior_weights)
        self._validate_state(pseudo_state)
        if not self.smoother:
            state, observations, pseudo_state = self._slice_analysis(
                analysis_time, state, observations, pseudo_state)
        ens_obs, filtered_obs = self._apply_obs_operator(pseudo_state,
                                                         observations)
        return self._estimate_and_apply(state, filtered_obs, ens_obs)

    def _estimate_and_apply(self, state: EnsembleState,
                            filtered_obs: List[Observation],
                            ens_obs: List[torch.Tensor]) -> EnsembleState:
        """Estimate the weights, checkpoint and reload them when
        ``weight_save_path`` is set, and apply them; algorithms with a
        fused solve and apply override it."""
        weights = self.estimate_weights(state, filtered_obs, ens_obs)
        if self.weight_save_path is not None:
            self.store_weights(weights)
            weights = self.load_weights(device=weights.device,
                                        dtype=weights.dtype)
        return self._apply_weights(state, weights)
