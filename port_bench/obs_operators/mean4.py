"""Each observation the mean of the 4 columns from its own on, wrapping
round the grid's end (``bench.py:337-342``); the program's operator
gathers a frozen copy of ``chip_smoke.py``'s 4-point stencil."""

import numpy as np
import torch

from port_bench.reference import obs


def program(config, inputs, device):
    sten = torch.as_tensor(
        np.stack([(inputs.obs_idx + s) % config["grid"] for s in range(4)],
                 axis=1), device=device)

    def mean4(state):
        return state[:, sten].mean(-1)

    return mean4


def reference(config, inputs, device):
    idx = torch.as_tensor(inputs.obs_idx, device=device)
    return lambda x: obs.mean4(x, idx)
