"""Point observations: each observation the value of its column."""

import torch

from port_bench.reference import obs


def program(config, inputs, device):
    return None


def reference(config, inputs, device):
    idx = torch.as_tensor(inputs.obs_idx, device=device)
    return lambda x: obs.point(x, idx)
