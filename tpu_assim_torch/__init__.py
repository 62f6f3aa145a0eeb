"""
tpu_assim_torch — the PyTorch/CUDA port of :mod:`tpu_assim`.

Module paths mirror the JAX package (``tpu_assim_torch.ops.localization``
is the port of ``tpu_assim.ops.localization``; the Pallas modules
``ops/pallas/letkf.py`` and ``models/pallas_forecast.py`` become
``ops/cuda/letkf.py`` and ``models/cuda_forecast.py``). The package imports
torch and numpy only. Its CUDA kernels live in ``csrc/`` and are built with
nvcc at their first launch.
"""

__version__ = "0.1.0"
