"""Algorithm interface layer (port of :mod:`tpu_assim.interface`): the
filters and the smoothers."""

from tpu_assim_torch.interface.base import BaseAssimilation
from tpu_assim_torch.interface.etkf import ETKF
from tpu_assim_torch.interface.filter import FilterAssimilation
from tpu_assim_torch.interface.ienks import IEnKSBundle, IEnKSTransform
from tpu_assim_torch.interface.ketkf import KETKF
from tpu_assim_torch.interface.letkf import LETKF
from tpu_assim_torch.interface.lienks import (
    LocalizedIEnKSBundle,
    LocalizedIEnKSTransform,
)
from tpu_assim_torch.interface.lketkf import LKETKF
from tpu_assim_torch.interface.variational import VarAssimilation

__all__ = ["BaseAssimilation", "ETKF", "FilterAssimilation", "IEnKSBundle",
           "IEnKSTransform", "KETKF", "LETKF", "LKETKF",
           "LocalizedIEnKSBundle", "LocalizedIEnKSTransform",
           "VarAssimilation"]
