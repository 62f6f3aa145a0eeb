"""
Kernel base classes with operator composition (PyTorch port of
:mod:`tpu_assim.ops.kernels.base`).

A kernel is an ``nn.Module`` whose ``forward(x, y)`` gives the Gram matrix
over the trailing (samples x features) dims; kernels compose with ``+``,
``*`` and ``**``. Parameters are buffers, not ``nn.Parameter``s: a Gram
that requires grad makes the CUDA Jacobi wrappers raise, so gradients are
opt-in (set ``requires_grad`` on a buffer, on the CPU).
"""

import numpy as np
import torch
from torch import nn

__all__ = [
    "AdditiveKernel",
    "BaseKernel",
    "CompKernel",
    "MultiplicativeKernel",
    "PowerKernel",
]


class BaseKernel(nn.Module):
    """Base class of all kernels; subclasses implement ``forward(x, y)``."""

    def __add__(self, other):
        return AdditiveKernel(self, other)

    def __mul__(self, other):
        return MultiplicativeKernel(self, other)

    def __pow__(self, other):
        return PowerKernel(self, other)

    def _buffer(self, name: str, value) -> None:
        """Register ``value`` as the buffer ``name``: a tensor as it is,
        anything else as an f64 tensor. A 0-d buffer takes part in the
        Gram arithmetic without changing its dtype or device."""
        if not isinstance(value, torch.Tensor):
            value = torch.tensor(np.asarray(value, dtype=np.float64))
        self.register_buffer(name, value)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("Kernel must implement forward(x, y)")


class CompKernel(BaseKernel):
    """Composition of two kernels."""

    def __init__(self, kernel_1: BaseKernel, kernel_2: BaseKernel):
        super().__init__()
        self.kernel_1 = kernel_1
        self.kernel_2 = kernel_2


class AdditiveKernel(CompKernel):
    """``K1(x, y) + K2(x, y)``."""

    def forward(self, x, y):
        return self.kernel_1(x, y) + self.kernel_2(x, y)


class MultiplicativeKernel(CompKernel):
    """``K1(x, y) * K2(x, y)``."""

    def forward(self, x, y):
        return self.kernel_1(x, y) * self.kernel_2(x, y)


class PowerKernel(CompKernel):
    """``K1(x, y) ** K2(x, y)``."""

    def forward(self, x, y):
        return self.kernel_1(x, y) ** self.kernel_2(x, y)
