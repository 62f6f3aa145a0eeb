"""
Variational (outer-loop) assimilation template (PyTorch port of
:mod:`tpu_assim.interface.variational`): an outer Gauss-Newton loop that
alternates model propagation, the observation operators and a
weight-space ``inner_loop``.

Each iteration's weights stay on the device; nothing waits for them
there. With ``weight_save_path`` they make a round trip through the HDF5
checkpoint after every iteration.
"""

from typing import Callable, List, Optional, Sequence

import torch

from tpu_assim_torch.interface.base import BaseAssimilation
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.state import EnsembleState

__all__ = ["VarAssimilation"]


class VarAssimilation(BaseAssimilation):
    """Abstract outer-loop variational assimilation.

    Parameters
    ----------
    forward_model : callable ``(state, iter_num) -> (state, pseudo_state)``
        propagating the weighted ensemble; required.
    max_iter : number of outer iterations.
    smoother, pre_transform, post_transform, weight_save_path : see
        :class:`~tpu_assim_torch.interface.base.BaseAssimilation`.
    """

    def __init__(
        self,
        forward_model: Callable,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
    ):
        super().__init__(
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            forward_model=forward_model,
            weight_save_path=weight_save_path,
        )
        self.max_iter = max_iter

    def precompute_weights(self, weights: torch.Tensor) -> torch.Tensor:
        """The weights of an outer iteration, through the checkpoint when
        ``weight_save_path`` is set (the JAX package also waits for them
        here; the port does not, so the loop runs on without a host
        sync)."""
        if self.weight_save_path is not None:
            self.store_weights(weights)
            weights = self.load_weights(device=weights.device,
                                        dtype=weights.dtype)
        return weights

    def _initial_weights(self, state: EnsembleState) -> torch.Tensor:
        """The weights the outer loop starts from: the identity."""
        return self.generate_prior_weights(
            state.ens_size, dtype=state.dtype, device=state.device)

    def inner_loop(
        self,
        state: EnsembleState,
        weights: torch.Tensor,
        filtered_obs: List[Observation],
        ens_obs: List[torch.Tensor],
    ) -> torch.Tensor:
        """The weights after one inner step (abstract)."""
        raise NotImplementedError

    def _outer_step(
        self,
        weights: torch.Tensor,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: Optional[EnsembleState],
        iter_num: int = 0,
    ) -> torch.Tensor:
        """Propagate with the current weights (unless a pseudo state is
        given), apply the observation operators, take one inner step."""
        pseudo_state = self.get_pseudo_state(
            pseudo_state=pseudo_state,
            state=state,
            weights=weights,
            iter_num=iter_num,
        )
        ens_obs, filtered_obs = self._apply_obs_operator(
            pseudo_state, observations
        )
        return self.inner_loop(state, weights, filtered_obs, ens_obs)

    def update_state(
        self,
        state: EnsembleState,
        observations: Sequence[Observation],
        pseudo_state: Optional[EnsembleState],
        analysis_time: float,
    ) -> EnsembleState:
        """``max_iter`` outer iterations from the identity weights, at the
        analysis time; a given pseudo state serves the first iteration
        only. In smoother mode the analysis is propagated once more."""
        weights = self._initial_weights(state)
        state = state.sel_time_index(state.time_index(analysis_time))
        for iter_num in range(self.max_iter):
            weights = self._outer_step(
                weights=weights,
                state=state,
                observations=observations,
                pseudo_state=pseudo_state,
                iter_num=iter_num,
            )
            weights = self.precompute_weights(weights)
            pseudo_state = None
        analysis_state = self._apply_weights(state, weights)
        if self.smoother:
            analysis_state, _ = self.forward_model(analysis_state,
                                                   self.max_iter)
        return analysis_state
