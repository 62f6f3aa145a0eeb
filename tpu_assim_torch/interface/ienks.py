"""
Iterative ensemble Kalman smoother, transform and bundle (PyTorch port of
:mod:`tpu_assim.interface.ienks`).

The inner loop is one call of the IEnKS inner step
(:mod:`tpu_assim_torch.ops.ienks`) on the global weights; its single
K x K SVD stays on :func:`torch.linalg.svd` (the Jacobi kernel's gate
takes batches of at least 256 matrices). The learning rate ``tau`` is
bounded to [0, 1] and ``epsilon`` to >= 0.
"""

from typing import Callable, List, Optional

import torch

from tpu_assim_torch.interface.variational import VarAssimilation
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops.ienks import ienks_bundle_step, ienks_transform_step
from tpu_assim_torch.state import EnsembleState
from tpu_assim_torch.utils.decorators import bound_scalar

__all__ = ["IEnKSBundle", "IEnKSTransform"]


class IEnKSTransform(VarAssimilation):
    """IEnKS, transform version: the linearized observation operator
    through the inverted weight perturbations.

    Parameters
    ----------
    forward_model : callable ``(state, iter_num) -> (state, pseudo_state)``.
    tau : learning rate in [0, 1].
    max_iter, smoother, pre_transform, post_transform, weight_save_path :
        see :class:`~tpu_assim_torch.interface.variational.VarAssimilation`.
    """

    def __init__(
        self,
        forward_model: Callable,
        tau: float = 1.0,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
    ):
        super().__init__(
            forward_model=forward_model,
            max_iter=max_iter,
            smoother=smoother,
            pre_transform=pre_transform,
            post_transform=post_transform,
            weight_save_path=weight_save_path,
        )
        self.tau = tau

    def __str__(self):
        return "IEnKSTransform(tau={0})".format(self.tau)

    def __repr__(self):
        return "IEnKSTransform({0})".format(repr(self.tau))

    @property
    def tau(self) -> float:
        return self._tau

    @tau.setter
    def tau(self, new_tau):
        self._tau = bound_scalar(new_tau, min_val=0.0, max_val=1.0, name="tau")

    def inner_loop(
        self,
        state: EnsembleState,
        weights: torch.Tensor,
        filtered_obs: List[Observation],
        ens_obs: List[torch.Tensor],
    ) -> torch.Tensor:
        innovations, ens_obs_perts, _ = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        return ienks_transform_step(weights, ens_obs_perts,
                                    innovations[None, :], self.tau)


class IEnKSBundle(IEnKSTransform):
    """IEnKS, bundle version: the linearized observation operator by finite
    differences of scale ``epsilon`` (>= 0)."""

    def __init__(
        self,
        forward_model: Callable,
        tau: float = 1.0,
        epsilon: float = 1e-4,
        max_iter: int = 10,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
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
        self.epsilon = epsilon

    def __str__(self):
        return "IEnKSBundle(epsilon={0}, tau={1})".format(self.epsilon,
                                                          self.tau)

    def __repr__(self):
        return "IEnKSBundle({0},{1})".format(repr(self.epsilon),
                                             repr(self.tau))

    @property
    def epsilon(self) -> float:
        return self._epsilon

    @epsilon.setter
    def epsilon(self, new_epsilon):
        self._epsilon = bound_scalar(new_epsilon, min_val=0.0, max_val=None,
                                     name="epsilon")

    def _get_model_weights(self, weights: torch.Tensor) -> torch.Tensor:
        """The bundle propagates with ``epsilon I + mean(W)``."""
        eye = torch.eye(weights.shape[-2], dtype=weights.dtype,
                        device=weights.device)
        return self.epsilon * eye + torch.mean(weights, dim=-1, keepdim=True)

    def inner_loop(
        self,
        state: EnsembleState,
        weights: torch.Tensor,
        filtered_obs: List[Observation],
        ens_obs: List[torch.Tensor],
    ) -> torch.Tensor:
        innovations, ens_obs_perts, _ = self._get_obs_space_variables(
            ens_obs, filtered_obs
        )
        return ienks_bundle_step(weights, ens_obs_perts, innovations[None, :],
                                 self.tau, self.epsilon)
