"""
Pre/post-processing transforms (PyTorch port of
:mod:`tpu_assim.transform.base`).
"""

from typing import Iterable, Optional, Tuple

from tpu_assim_torch.observation import Observation
from tpu_assim_torch.state import EnsembleState

__all__ = ["BaseTransformer"]


class BaseTransformer:
    """A transform applied around ``update_state``: ``pre`` maps
    (background, observations, first guess) before the analysis, ``post``
    maps the analysis after it. The base class changes nothing."""

    def pre(
        self,
        background: EnsembleState,
        observations: Iterable[Observation],
        first_guess: Optional[EnsembleState] = None,
    ) -> Tuple[EnsembleState, Iterable[Observation], Optional[EnsembleState]]:
        return background, observations, first_guess

    def post(
        self,
        analysis: EnsembleState,
        background: EnsembleState,
        observations: Iterable[Observation],
        first_guess: Optional[EnsembleState] = None,
    ) -> EnsembleState:
        return analysis
