"""
Base assimilation interface: the ``assimilate()`` template method (PyTorch
port of :mod:`tpu_assim.interface.base`).

validate -> select the analysis time -> pre-transforms -> ``update_state``
-> post-transforms -> validate, over
:class:`~tpu_assim_torch.state.EnsembleState` and
:class:`~tpu_assim_torch.observation.Observation` on one device. Host code
only validates and selects times.
"""

import logging
import time as _time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpu_assim_torch.observation import Observation, ObservationError
from tpu_assim_torch.state import EnsembleState, StateError
from tpu_assim_torch.utils.checkpoint import load_weights, save_weights

logger = logging.getLogger(__name__)

__all__ = ["BaseAssimilation"]


class BaseAssimilation:
    """Abstract base of the assimilation algorithms.

    Parameters
    ----------
    smoother : apply the weights to the whole time window (True) or only at
        the analysis time (False).
    pre_transform / post_transform : iterables of
        :class:`~tpu_assim_torch.transform.BaseTransformer`, applied around
        ``update_state`` in order.
    forward_model : optional callable ``(state, iter_num) -> (state,
        pseudo_state)`` that propagates the model ensemble.
    weight_save_path : optional path; the estimated weights are
        checkpointed there (HDF5, :mod:`tpu_assim_torch.utils.checkpoint`)
        and reloaded before they are applied.
    """

    def __init__(
        self,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        forward_model: Optional[Callable] = None,
        weight_save_path: Optional[str] = None,
    ):
        self.smoother = smoother
        self.pre_transform = pre_transform
        self.post_transform = post_transform
        self.forward_model = forward_model
        self.weight_save_path = weight_save_path

    # ------------------------------------------------------------- validation
    @staticmethod
    def _validate_state(state: EnsembleState):
        if not isinstance(state, EnsembleState):
            raise TypeError("state must be an EnsembleState")
        if not state.valid:
            raise StateError("Given state is not a valid state!")

    @staticmethod
    def _validate_single_obs(observation: Observation):
        if not isinstance(observation, Observation):
            raise TypeError("observations must be Observation instances")
        if not observation.valid:
            raise ObservationError("Given observation is not valid!")

    def _validate_observations(self, observations: Sequence[Observation]):
        for obs in observations:
            self._validate_single_obs(obs)

    # ---------------------------------------------------------- analysis time
    @staticmethod
    def _get_analysis_time(state: EnsembleState,
                           analysis_time: Optional[float] = None) -> float:
        """The last state time for None, else the nearest state time."""
        times = state.times.detach().cpu().numpy()
        if analysis_time is None:
            return float(times[-1])
        return float(times[int(np.argmin(np.abs(times
                                                - float(analysis_time))))])

    # ------------------------------------------------------------ obs operator
    @staticmethod
    def _apply_obs_operator(
        pseudo_state: EnsembleState, observations: Sequence[Observation]
    ) -> Tuple[List[torch.Tensor], List[Observation]]:
        """Each observation's operator on the pseudo state, [time, ens,
        obs]; observations without an operator (or whose operator raises
        ``NotImplementedError``) are dropped."""
        ens_obs, filtered = [], []
        for obs in observations:
            if obs.operator is None:
                continue
            try:
                equivalent = obs.operator(obs, pseudo_state)
            except NotImplementedError:
                continue
            ens_obs.append(torch.as_tensor(equivalent))
            filtered.append(obs)
        return ens_obs, filtered

    # -------------------------------------------------- obs-space preparation
    @staticmethod
    def _get_obs_space_variables(
        ens_obs: Sequence[torch.Tensor], observations: Sequence[Observation]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Normalized innovations [obs_id], normalized ensemble perturbations
        [ens, obs_id] and the stacked obs coordinates [obs_id, 1 + n_coord],
        over every observation's flattened (time, obs)."""
        innov_list, perts_list, info_list = [], [], []
        for equivalent, obs in zip(ens_obs, observations):
            mean = torch.mean(equivalent, dim=1, keepdim=True)  # [time, 1, o]
            innovation = obs.mul_rcinv(obs.observations - mean[:, 0, :])
            # [ens, time, obs], so that a time-dependent R broadcasts
            perts = obs.mul_rcinv((equivalent - mean).transpose(0, 1))
            innov_list.append(innovation.reshape(-1))
            perts_list.append(perts.reshape(perts.shape[0], -1))
            info_list.append(obs.stacked_coords())
        return (torch.cat(innov_list), torch.cat(perts_list, dim=1),
                torch.cat(info_list))

    # --------------------------------------------------------------- weights
    @staticmethod
    def generate_prior_weights(ens_size: int, dtype=None,
                               device=None) -> torch.Tensor:
        """Identity prior weights."""
        return torch.eye(ens_size, dtype=dtype, device=device)

    @staticmethod
    def _apply_weights(state: EnsembleState,
                       weights: torch.Tensor) -> EnsembleState:
        """Analysis = mean + perturbations W, contracting the ensemble
        dimension; weights global [k, m] or per column [grid, k, m]."""
        state_mean, state_perts = state.split_mean_perts()
        if weights.ndim == 2:
            perts = torch.einsum("vtkg,km->vtmg", state_perts, weights)
        elif weights.ndim == 3:
            perts = torch.einsum("vtkg,gkm->vtmg", state_perts, weights)
        else:
            raise ValueError("weights must be [k, m] or [grid, k, m], got "
                             f"shape {tuple(weights.shape)}")
        return state.replace(data=state_mean + perts)

    # ------------------------------------------------------- weight checkpoint
    def store_weights(self, weights: torch.Tensor) -> None:
        """Checkpoint the weights to ``weight_save_path``."""
        save_weights(self.weight_save_path, weights)

    def load_weights(self, device=None, dtype=None) -> torch.Tensor:
        """The weights of ``weight_save_path`` on ``device`` in ``dtype``
        (the caller passes those of the weights it stored)."""
        return load_weights(self.weight_save_path, device=device,
                            dtype=dtype)

    # --------------------------------------------------------- model coupling
    def _get_model_weights(self, weights: torch.Tensor) -> torch.Tensor:
        return weights

    def propagate_model(self, weights: torch.Tensor, state: EnsembleState,
                        iter_num: int = 0) -> EnsembleState:
        """Apply the (model) weights and run the forward model."""
        model_state = self._apply_weights(state,
                                          self._get_model_weights(weights))
        _, pseudo_state = self.forward_model(model_state, iter_num)
        self._validate_state(pseudo_state)
        return pseudo_state

    def get_pseudo_state(self, pseudo_state: Optional[EnsembleState],
                         state: EnsembleState, weights: torch.Tensor,
                         iter_num: int = 0) -> EnsembleState:
        if pseudo_state is None and self.forward_model is not None:
            return self.propagate_model(weights, state, iter_num)
        if pseudo_state is None:
            return state
        return pseudo_state

    # -------------------------------------------------------------- template
    def update_state(self, state: EnsembleState,
                     observations: Sequence[Observation],
                     pseudo_state: Optional[EnsembleState],
                     analysis_time: float) -> EnsembleState:
        raise NotImplementedError

    def assimilate(
        self,
        state: EnsembleState,
        observations: Union[Observation, Sequence[Observation]],
        pseudo_state: Optional[EnsembleState] = None,
        analysis_time: Optional[float] = None,
    ) -> EnsembleState:
        """Validate, resolve the analysis time, run the pre-transforms,
        ``update_state`` and the post-transforms, and validate the analysis.
        Without observations the background state comes back, with a
        warning."""
        start = _time.time()
        if observations is None or (
            isinstance(observations, (list, tuple, set)) and not observations
        ):
            warnings.warn(
                "No observation is given, I will return the background state!",
                UserWarning)
            return state
        if not isinstance(observations, (list, set, tuple)):
            observations = (observations,)
        observations = tuple(observations)
        self._validate_state(state)
        self._validate_observations(observations)
        analysis_time = self._get_analysis_time(state, analysis_time)
        for trans in self.pre_transform or ():
            state, observations, pseudo_state = trans.pre(
                state, observations, pseudo_state)
        analysis = self.update_state(state, observations, pseudo_state,
                                     analysis_time)
        for trans in self.post_transform or ():
            analysis = trans.post(analysis, state, observations, pseudo_state)
        self._validate_state(analysis)
        logger.info("Finished assimilation after %.2f s", _time.time() - start)
        return analysis
