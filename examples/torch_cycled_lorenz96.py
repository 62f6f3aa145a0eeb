#!/usr/bin/env python
"""
Cycled LETKF twin experiment on Lorenz-96: the PyTorch/CUDA counterpart of
``examples/cycled_lorenz96.py`` (the same arguments, defaults and seed, and
``--device``). Spin up a truth run, draw noisy observations every cycle,
forecast the ensemble with RK4 (``analysis._forecast``: K2 on the card for
an f32 state), assimilate with the localized ETKF (``--fast``: the fused
1-D window kernel K1), and report the ensemble-mean RMSE against the truth
and the phase timings of :mod:`tpu_assim_torch.utils.profiling`.

Arrays that the JAX example makes in JAX's default dtype are made here in
torch's default dtype (``torch.get_default_dtype()``, f32 unless set).

Run: python examples/torch_cycled_lorenz96.py [--cycles 100] [--ens 20]
     [--fast] [--device cuda]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from tpu_assim_torch.analysis import make_cycle_step
from tpu_assim_torch.models import (
    Lorenz96,
    RK4Integrator,
    integrate_trajectory,
)
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.utils.profiling import phase, report


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--cycles", type=int, default=100)
    p.add_argument("--ens", type=int, default=20)
    p.add_argument("--grid", type=int, default=40)
    p.add_argument("--obs-every", type=int, default=2)
    p.add_argument("--obs-var", type=float, default=0.5)
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--inf", type=float, default=1.1)
    p.add_argument("--dt", type=float, default=0.05)
    p.add_argument("--steps-per-cycle", type=int, default=4)
    p.add_argument("--fast", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    return p


def run(args, spinup=500):
    """The experiment (the truth spun up ``spinup`` RK4 steps): returns the
    RMSE of the ensemble mean after each cycle."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card found; pass --device cpu to run on "
                         "the CPU")
    dtype = torch.get_default_dtype()
    rng = np.random.RandomState(42)
    model = Lorenz96(forcing=8.0)
    integ = RK4Integrator(model, dt=args.dt)

    truth = torch.as_tensor(rng.normal(size=args.grid) + 8.0, dtype=dtype,
                            device=device)
    truth = integrate_trajectory(integ, truth, spinup)[-1]
    ens = truth[None, :] + torch.as_tensor(
        rng.normal(size=(args.ens, args.grid)), dtype=dtype, device=device)

    obs_idx = torch.as_tensor(
        np.arange(0, args.grid, args.obs_every, dtype=np.int32),
        device=device)
    n_obs = len(obs_idx)
    obs_var = torch.full((n_obs,), args.obs_var, dtype=dtype, device=device)
    grid_coords = torch.arange(args.grid, dtype=dtype, device=device)[:, None]
    obs_coords = grid_coords[obs_idx]

    def dist_periodic(gc, oi):
        d = torch.abs(oi[:, 1] - gc[1])
        return torch.minimum(d, args.grid - d)[None, :]

    def dist_abs(gc, oi):
        return torch.abs(oi[:, 1] - gc[1])[None, :]

    # --fast uses the monolithic fused kernel, which evaluates a plain
    # |x - y| taper on the sorted coordinate (no ring wrap at the domain
    # edge: a slightly different localization near the boundary)
    loc = GaspariCohn((args.radius,),
                      dist_abs if args.fast else dist_periodic)
    opts = dict(method="fused1d", max_obs=16) if args.fast else {}
    step = make_cycle_step(
        integ, args.steps_per_cycle, loc, inf_factor=args.inf, **opts)

    rmses = []
    for cycle in range(args.cycles):
        with phase("truth+obs"):
            truth = integrate_trajectory(integ, truth,
                                         args.steps_per_cycle)[-1]
            obs = truth[obs_idx] + torch.as_tensor(
                rng.normal(size=n_obs) * np.sqrt(args.obs_var), dtype=dtype,
                device=device)
        with phase("forecast+analysis", block=True):
            ens = step(ens, obs, obs_var, obs_idx, grid_coords, obs_coords)
        rmse = float(torch.sqrt(torch.mean((torch.mean(ens, 0) - truth)
                                           ** 2)))
        rmses.append(rmse)
        if (cycle + 1) % 10 == 0:
            print(f"cycle {cycle + 1:4d}  rmse {rmse:.4f}")
    return rmses


def main():
    args = parser().parse_args()
    t0 = time.time()
    rmses = run(args)
    half = len(rmses) // 2
    print(f"\nmean RMSE (2nd half): {np.mean(rmses[half:]):.4f} "
          f"(obs sigma {np.sqrt(args.obs_var):.3f})")
    print(f"wall: {time.time() - t0:.1f}s for {args.cycles} cycles")
    print()
    print(report())


if __name__ == "__main__":
    main()
