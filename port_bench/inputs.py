"""
The general generator of a cell's inputs: one configuration, one traffic
mix and one seed give the prior ensemble, a pool of observation vectors
and the observation network (``networks/<obs_network>.py``), the tensors
made on the device.

The sizes come from the configuration alone, so every seed does the same
work; the seed draws the values.
"""

from types import SimpleNamespace

import torch

from port_bench.parts import load


class Inputs(SimpleNamespace):
    """What both the program and the reference are handed: ``prior [k,
    g]``, ``obs_pool [pool, o]`` and ``obs_var [o]`` on the device, and the
    arrays of the network's ``build`` under its own names."""


def make_inputs(config: dict, traffic: dict, seed: int,
                device: torch.device) -> Inputs:
    dtype = getattr(torch, config["dtype"])
    k, g, o = config["ens_size"], config["grid"], config["n_obs"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    prior = torch.randn(k, g, generator=gen, device=device, dtype=dtype)
    pool = torch.randn(traffic["obs_pool"], o, generator=gen, device=device,
                       dtype=dtype)
    var = torch.full((o,), float(config["obs_var"]), device=device,
                     dtype=dtype)
    network = load("networks", config["obs_network"]).build(config, seed)
    return Inputs(prior=prior, obs_pool=pool, obs_var=var, **network)
