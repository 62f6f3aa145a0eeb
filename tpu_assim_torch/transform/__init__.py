"""Pre/post transforms (port of :mod:`tpu_assim.transform`)."""

from tpu_assim_torch.transform.base import BaseTransformer
from tpu_assim_torch.transform.mul_inflation import MultiplicativeInflation
from tpu_assim_torch.transform.normalize import Normalizer

__all__ = ["BaseTransformer", "MultiplicativeInflation", "Normalizer"]
