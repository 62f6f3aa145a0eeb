"""
Global ETKF (PyTorch port of :mod:`tpu_assim.interface.etkf`): one set of
ensemble weights from every observation, applied to the whole state.
"""

from typing import List

import torch

from tpu_assim_torch.interface.filter import FilterAssimilation
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops.etkf import etkf_weights
from tpu_assim_torch.state import EnsembleState

__all__ = ["ETKF"]


class ETKF(FilterAssimilation):
    """Ensemble transform Kalman filter with global weights.

    Parameters
    ----------
    inf_factor : multiplicative covariance inflation rho (the weight solve's
        regularizer is ``(K-1)/rho``).
    smoother, pre_transform, post_transform, weight_save_path,
    forward_model : see
        :class:`~tpu_assim_torch.interface.base.BaseAssimilation`.
    """

    def __init__(self, inf_factor: float = 1.0, smoother: bool = False,
                 pre_transform=None, post_transform=None,
                 weight_save_path=None, forward_model=None):
        super().__init__(smoother=smoother, pre_transform=pre_transform,
                         post_transform=post_transform,
                         weight_save_path=weight_save_path,
                         forward_model=forward_model)
        self.inf_factor = inf_factor

    def __str__(self):
        return f"Global ETKF(inf_factor={self.inf_factor})"

    def __repr__(self):
        return f"ETKF({self.inf_factor!r})"

    def estimate_weights(self, state: EnsembleState,
                         filtered_obs: List[Observation],
                         ens_obs: List[torch.Tensor]) -> torch.Tensor:
        innovations, ens_obs_perts, _ = self._get_obs_space_variables(
            ens_obs, filtered_obs)
        return etkf_weights(ens_obs_perts, innovations[None, :],
                            self.inf_factor)
