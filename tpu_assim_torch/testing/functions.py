"""Test helper functions (the port of :mod:`tpu_assim.testing.functions`)."""

import torch

__all__ = ["generate_random_weights"]


def generate_random_weights(ens_size: int, seed: int = 42) -> torch.Tensor:
    """A random valid ensemble weight matrix [k, k] in f64 on the CPU: the
    identity plus a small random mean part (scale 0.1) and perturbation
    part (scale 0.05), drawn from a ``torch.Generator`` seeded with
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    w_mean = 0.1 * torch.randn((ens_size, 1), generator=gen,
                               dtype=torch.float64)
    w_perts = (torch.eye(ens_size, dtype=torch.float64)
               + 0.05 * torch.randn((ens_size, ens_size), generator=gen,
                                    dtype=torch.float64))
    return w_mean + w_perts
