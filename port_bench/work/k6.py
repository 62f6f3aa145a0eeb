"""
K6, the 2-D window LETKF analysis (``window2d_banded``,
``csrc/letkf_window2d.cu``): per grid column the Chebyshev solve and apply
of :func:`port_bench.work.k1.cheb_flops` over the observations that carry
weight there, counted from the network and not from the program's window;
the state perturbations and mean read once, the analysis written once, the
observation table (perturbations, innovation, x, y) and the grid's x and y
read once.
"""

import torch

from port_bench.work.k1 import cheb_flops

KERNEL_NAMES = ("window2d",)
COUNTER = ("tpu_assim_torch.ops.cuda.letkf", "window2d")


def work(k, g, o, counts, degree, bytes_per=4):
    """``(flops, bytes)`` of one analysis of ``k`` members on ``g`` columns
    with ``o`` observations, ``counts [g]`` each column's observations of
    nonzero weight."""
    m = torch.as_tensor(counts, dtype=torch.int64)
    flops = int(cheb_flops(k, m, 1, degree).sum())
    n_bytes = bytes_per * (2 * k * g + g + k * o + 3 * o + 2 * g)
    return flops, n_bytes
