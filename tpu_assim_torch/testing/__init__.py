"""Test support (the port of :mod:`tpu_assim.testing`): test doubles built
on the port's :class:`~tpu_assim_torch.state.EnsembleState` and
:class:`~tpu_assim_torch.ops.localization.BaseLocalization`, a decorator
that skips a test without a CUDA card, and random ensemble weights."""

from tpu_assim_torch.testing.decorators import (
    cuda_available,
    if_cuda_decorator,
    if_gpu_decorator,
)
from tpu_assim_torch.testing.dummy import (
    DummyLocalization,
    DummyNeuralModule,
    dummy_distance,
    dummy_model,
    dummy_obs_operator,
)
from tpu_assim_torch.testing.functions import generate_random_weights

__all__ = [
    "DummyLocalization",
    "DummyNeuralModule",
    "cuda_available",
    "dummy_distance",
    "dummy_model",
    "dummy_obs_operator",
    "generate_random_weights",
    "if_cuda_decorator",
    "if_gpu_decorator",
]
