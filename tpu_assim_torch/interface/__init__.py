"""Algorithm interface layer (port of :mod:`tpu_assim.interface`; the
smoother classes are not ported yet)."""

from tpu_assim_torch.interface.base import BaseAssimilation
from tpu_assim_torch.interface.etkf import ETKF
from tpu_assim_torch.interface.filter import FilterAssimilation
from tpu_assim_torch.interface.ketkf import KETKF
from tpu_assim_torch.interface.letkf import LETKF
from tpu_assim_torch.interface.lketkf import LKETKF

__all__ = ["BaseAssimilation", "ETKF", "FilterAssimilation", "KETKF", "LETKF",
           "LKETKF"]
