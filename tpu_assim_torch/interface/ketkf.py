"""
Global kernelized ETKF (PyTorch port of :mod:`tpu_assim.interface.ketkf`):
the ETKF weight solve with the double-centred Gram matrix of an arbitrary
kernel instead of the linear dot product.
"""

from typing import List, Optional

import torch

from tpu_assim_torch.interface.etkf import ETKF
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.ops.kernels import BaseKernel, LinearKernel
from tpu_assim_torch.ops.ketkf import ketkf_weights
from tpu_assim_torch.state import EnsembleState

__all__ = ["KETKF"]


class KETKF(ETKF):
    """Kernelized ensemble transform Kalman filter.

    Parameters
    ----------
    kernel : a :class:`~tpu_assim_torch.ops.kernels.BaseKernel` (or any
        Gram function over the trailing two dims). Default: the linear
        kernel, which makes KETKF the ETKF.
    inf_factor : inflation rho, the l2 regularization of the GP weights.
    method : ``"eigh"`` (exact, default) or ``"newton"`` (Newton-Schulz; the
        centred Gram of a PSD kernel is PSD).
    newton_iters : iterations of ``"newton"``.
    smoother, pre_transform, post_transform, weight_save_path,
    forward_model : see
        :class:`~tpu_assim_torch.interface.base.BaseAssimilation`.
    """

    def __init__(
        self,
        kernel: Optional[BaseKernel] = None,
        inf_factor: float = 1.0,
        smoother: bool = False,
        pre_transform=None,
        post_transform=None,
        weight_save_path: Optional[str] = None,
        forward_model=None,
        method: str = "eigh",
        newton_iters: int = 25,
    ):
        super().__init__(inf_factor=inf_factor, smoother=smoother,
                         pre_transform=pre_transform,
                         post_transform=post_transform,
                         weight_save_path=weight_save_path,
                         forward_model=forward_model)
        self.kernel = kernel if kernel is not None else LinearKernel()
        self.method = method
        self.newton_iters = newton_iters

    def __str__(self):
        return (f"Global KETKF(inf_factor={self.inf_factor}, "
                f"kernel={self.kernel})")

    def __repr__(self):
        return f"KETKF({self.inf_factor!r},{self.kernel!r})"

    def estimate_weights(self, state: EnsembleState,
                         filtered_obs: List[Observation],
                         ens_obs: List[torch.Tensor]) -> torch.Tensor:
        innovations, ens_obs_perts, _ = self._get_obs_space_variables(
            ens_obs, filtered_obs)
        return ketkf_weights(ens_obs_perts, innovations[None, :], self.kernel,
                             self.inf_factor, method=self.method,
                             newton_iters=self.newton_iters)
