"""
Test decorators (the port of :mod:`tpu_assim.testing.decorators`). The JAX
package's accelerator check, ``tpu_available`` and ``if_tpu_decorator``,
becomes a CUDA check here: :func:`cuda_available` and
:func:`if_cuda_decorator` (also named :func:`if_gpu_decorator`, the
reference pytassim's name).
"""

import functools

import torch

__all__ = ["cuda_available", "if_cuda_decorator", "if_gpu_decorator"]


def cuda_available() -> bool:
    """Whether torch sees a CUDA card."""
    return torch.cuda.is_available()


def if_cuda_decorator(test_fn):
    """Skip the test unless a CUDA card is present (works for pytest and
    stdlib unittest)."""

    @functools.wraps(test_fn)
    def wrapper(*args, **kwargs):
        if not cuda_available():
            import pytest

            pytest.skip("no CUDA card available")
        return test_fn(*args, **kwargs)

    return wrapper


if_gpu_decorator = if_cuda_decorator
