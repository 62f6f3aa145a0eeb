"""
tpu_assim_torch — the PyTorch/CUDA port of :mod:`tpu_assim`.

Module paths mirror the JAX package (``tpu_assim_torch.ops.localization``
is the port of ``tpu_assim.ops.localization``; the Pallas modules
``ops/pallas/letkf.py`` and ``models/pallas_forecast.py`` become
``ops/cuda/letkf.py`` and ``models/cuda_forecast.py``). The package imports
torch and numpy only. Its CUDA kernels live in ``csrc/`` and are built with
nvcc at their first launch.

The class API: :class:`EnsembleState`, :class:`Observation`, the filters
:class:`ETKF`, :class:`LETKF`, the kernelized :class:`KETKF` and
:class:`LKETKF`, the smoothers :class:`IEnKSTransform`,
:class:`IEnKSBundle`, :class:`LocalizedIEnKSTransform` and
:class:`LocalizedIEnKSBundle`, and the transforms of
:mod:`tpu_assim_torch.transform`.
"""

__version__ = "0.1.0"

from tpu_assim_torch.interface import (
    ETKF,
    KETKF,
    LETKF,
    LKETKF,
    IEnKSBundle,
    IEnKSTransform,
    LocalizedIEnKSBundle,
    LocalizedIEnKSTransform,
)
from tpu_assim_torch.observation import Observation
from tpu_assim_torch.state import EnsembleState

__all__ = ["ETKF", "EnsembleState", "IEnKSBundle", "IEnKSTransform", "KETKF",
           "LETKF", "LKETKF", "LocalizedIEnKSBundle",
           "LocalizedIEnKSTransform", "Observation"]
