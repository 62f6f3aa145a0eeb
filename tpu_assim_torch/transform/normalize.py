"""
Z-score normalization (PyTorch port of :mod:`tpu_assim.transform.normalize`):
``pre`` normalizes the background, the observations and the first guess by
given (mean, std) statistics; ``post`` de-normalizes the analysis.
"""

from typing import Iterable, Optional, Sequence

from tpu_assim_torch.observation import Observation
from tpu_assim_torch.state import EnsembleState
from tpu_assim_torch.transform.base import BaseTransformer

__all__ = ["Normalizer"]


class Normalizer(BaseTransformer):
    """``ens_stat`` and ``fg_stat`` are (mean, std) pairs for the background
    and the first guess; ``obs_stat`` is a sequence of (mean, std) pairs,
    one per observation. Each statistic is a number or a tensor that
    broadcasts against what it normalizes."""

    def __init__(self, ens_stat, obs_stat: Sequence, fg_stat):
        self.ens_stat = ens_stat
        self.obs_stat = obs_stat
        self.fg_stat = fg_stat

    def pre(
        self,
        background: EnsembleState,
        observations: Iterable[Observation],
        first_guess: Optional[EnsembleState] = None,
    ):
        background = (background - self.ens_stat[0]) / self.ens_stat[1]
        if first_guess is not None:
            first_guess = (first_guess - self.fg_stat[0]) / self.fg_stat[1]
        obs_list = []
        for k, obs in enumerate(observations):
            mean, std = self.obs_stat[k]
            obs_list.append(
                obs.replace(observations=(obs.observations - mean) / std))
        return background, obs_list, first_guess

    def post(
        self,
        analysis: EnsembleState,
        background: EnsembleState,
        observations: Iterable[Observation],
        first_guess: Optional[EnsembleState] = None,
    ) -> EnsembleState:
        return analysis * self.ens_stat[1] + self.ens_stat[0]
