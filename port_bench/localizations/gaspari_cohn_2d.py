"""
The 2-D Gaspari-Cohn taper of radii ``radius = [rx, ry]``: the product of
the tapers of ``|dx| / rx`` and ``|dy| / ry``, weights at or below
``epsilon`` cut (pytassim's ``GaspariCohn`` with a radius per dimension);
the program sizes its window itself (its strip plan, strict).
"""

import torch

from port_bench.reference.window2d import Window2D


def program(loc):
    from tpu_assim_torch.ops.localization import GaspariCohn

    def dist(grid_coord, obs_coords):
        # columns 1 and 2: x and y after the time column the program
        # prepends
        return torch.stack([torch.abs(obs_coords[:, 1] - grid_coord[1]),
                            torch.abs(obs_coords[:, 2] - grid_coord[2])], 0)

    return GaspariCohn(tuple(loc["radius"]), dist, epsilon=loc["epsilon"])


def max_obs(loc, inputs):
    return None


def reference(loc, inputs, products, device):
    """The windows (:class:`port_bench.reference.window2d.Window2D`) in the
    precision of ``products``."""
    return Window2D(
        products.cast(torch.as_tensor(inputs.obs_x, device=device)),
        products.cast(torch.as_tensor(inputs.grid_x, device=device)),
        loc["radius"], loc["epsilon"])
