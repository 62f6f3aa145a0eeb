"""
Observation operator base class (PyTorch port of
:mod:`tpu_assim.obs_ops.base_ops`).

An operator maps an :class:`~tpu_assim_torch.state.EnsembleState` into
observation space. :meth:`BaseOperator.torch_operator` returns the same map
as a plain callable ``[..., grid] -> [..., obs]`` on tensors, the form the
functional analyses take as ``obs_operator``.
"""

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["BaseOperator"]


class BaseOperator:
    """Base observation operator.

    Parameters
    ----------
    len_grid : number of model grid points.
    random_state : numpy RandomState for random obs-point draws.
    """

    def __init__(self, len_grid: int = 40,
                 random_state: Optional[np.random.RandomState] = None):
        self.len_grid = len_grid
        self.random_state = random_state

    def __call__(self, obs_ds, input_state, *args, **kwargs) -> torch.Tensor:
        """``obs_op`` at the observation times (each must be one of the
        state's times): [obs_time, ens, obs]."""
        pseudo_obs = self.obs_op(input_state, *args, **kwargs)
        state_times = input_state.times.detach().cpu().numpy()
        t_idx = []
        for t in obs_ds.times.detach().cpu().numpy():
            match = np.nonzero(state_times == t)[0]
            if match.size == 0:
                raise KeyError(f"observation time {t} not present in state "
                               "times")
            t_idx.append(int(match[0]))
        return pseudo_obs[torch.as_tensor(t_idx, device=pseudo_obs.device)]

    def obs_op(self, in_state, *args, **kwargs) -> torch.Tensor:
        """Map a state to obs space, [time, ens, obs] at the state's times
        (abstract)."""
        raise NotImplementedError

    def torch_operator(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """A plain callable ``[..., grid] -> [..., obs]`` (abstract)."""
        raise NotImplementedError
