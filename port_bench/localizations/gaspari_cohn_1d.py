"""
The Gaspari-Cohn taper of radius ``radius`` over ``|x_obs - x_grid|`` on
1-D coordinates, weights at or below ``epsilon`` cut; the window size the
smallest exact one (``exact_nb`` of the in-support maximum, a frozen copy
of the JAX package's ``bench.py:exact_nb``).
"""

import torch

from port_bench.reference.window import sqrt_taper, support_window


def exact_nb(worst: int, mult: int = 4, floor: int = 8) -> int:
    """The in-support maximum rounded up to a multiple of ``mult``, at
    least ``floor``."""
    return max(-(-worst // mult) * mult, floor)


def program(loc):
    from tpu_assim_torch.ops.localization import GaspariCohn

    def dist(grid_coord, obs_coords):
        # column 1: the coordinate after the time column the program
        # prepends
        return torch.abs(obs_coords[:, 1] - grid_coord[1])[None, :]

    return GaspariCohn((loc["radius"],), dist, epsilon=loc["epsilon"])


def max_obs(loc, inputs):
    from tpu_assim_torch.ops.cuda.letkf import max_in_support_1d

    return exact_nb(max_in_support_1d(inputs.obs_x[:, 0],
                                      inputs.grid_x[:, 0], loc["radius"],
                                      epsilon=loc["epsilon"]))


def reference(loc, inputs, products, device):
    obs_x = products.cast(torch.as_tensor(inputs.obs_x[:, 0], device=device))
    grid_x = products.cast(torch.as_tensor(inputs.grid_x[:, 0],
                                           device=device))

    def window(cols):
        idx, valid = support_window(obs_x, grid_x[cols], loc["radius"])
        return idx, sqrt_taper(obs_x, grid_x[cols], idx, valid,
                               loc["radius"], loc["epsilon"])

    return window
