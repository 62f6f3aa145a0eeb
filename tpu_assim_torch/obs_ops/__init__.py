"""Observation operators (PyTorch port of :mod:`tpu_assim.obs_ops`)."""

from tpu_assim_torch.obs_ops.base_ops import BaseOperator
from tpu_assim_torch.obs_ops.lorenz96 import (
    BernoulliOperator,
    IdentityOperator,
)

__all__ = ["BaseOperator", "BernoulliOperator", "IdentityOperator"]
