"""
Multiplicative covariance inflation (PyTorch port of
:mod:`tpu_assim.transform.mul_inflation`): the ensemble perturbations are
scaled by ``sqrt(inf_factor)``, so the ensemble covariance grows by
``inf_factor``. ``pre`` inflates the background (and the first guess),
``post`` the analysis.
"""

import math
from typing import Iterable, Optional

import torch

from tpu_assim_torch.observation import Observation
from tpu_assim_torch.state import EnsembleState
from tpu_assim_torch.transform.base import BaseTransformer

__all__ = ["MultiplicativeInflation"]


class MultiplicativeInflation(BaseTransformer):
    """Parameters: ``inf_factor``, a number or a tensor that broadcasts
    against the [var, time, ens, grid] state."""

    def __init__(self, inf_factor=1.0):
        super().__init__()
        self.inf_factor = inf_factor

    def _inflate_array(self, state: EnsembleState) -> EnsembleState:
        mean = torch.mean(state.data, dim=2, keepdim=True)
        scale = (torch.sqrt(self.inf_factor)
                 if isinstance(self.inf_factor, torch.Tensor)
                 else math.sqrt(self.inf_factor))
        return state.replace(data=mean + scale * (state.data - mean))

    def pre(
        self,
        background: EnsembleState,
        observations: Iterable[Observation],
        first_guess: Optional[EnsembleState] = None,
    ):
        if isinstance(first_guess, EnsembleState):
            first_guess = self._inflate_array(first_guess)
        return self._inflate_array(background), observations, first_guess

    def post(
        self,
        analysis: EnsembleState,
        background: EnsembleState,
        observations: Iterable[Observation],
        first_guess: Optional[EnsembleState] = None,
    ) -> EnsembleState:
        return self._inflate_array(analysis)
