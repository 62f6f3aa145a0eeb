"""
Lorenz (1996): ``dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F`` on a
periodic ring over the last axis, stepped by classic RK4.
"""

import torch


def tendency(x: torch.Tensor, forcing: float) -> torch.Tensor:
    return ((torch.roll(x, -1, -1) - torch.roll(x, 2, -1))
            * torch.roll(x, 1, -1) - x + forcing)


def rk4(x: torch.Tensor, forcing: float, dt: float,
        n_steps: int) -> torch.Tensor:
    """``n_steps`` RK4 steps of size ``dt``."""
    for _ in range(n_steps):
        k1 = tendency(x, forcing)
        k2 = tendency(x + 0.5 * dt * k1, forcing)
        k3 = tendency(x + 0.5 * dt * k2, forcing)
        k4 = tendency(x + dt * k3, forcing)
        x = x + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x
