#!/usr/bin/env python
"""
Localized IEnKS smoother on Lorenz-96: the PyTorch/CUDA counterpart of
``examples/lienks_l96.py`` (its settings and seed, and ``--device``): the
cycled use of :func:`tpu_assim_torch.analysis.make_lienks_step`.

Per cycle: assimilate the window-end observations into the window-start
ensemble (3 outer Gauss-Newton iterations, each propagating the weighted
ensemble through the window), then advance the analysed ensemble to the
next window (``analysis._forecast``: K2 on the card for an f32 state). The
batched K x K SVDs inside every inner step go to the one-sided Jacobi
kernel K3 for f32 batches on the card.

Arrays that the JAX example makes in JAX's default dtype are made here in
torch's default dtype (``torch.get_default_dtype()``, f32 unless set).

Run: python examples/torch_lienks_l96.py [--device cuda]  (--device cpu
     runs the plain versions on the CPU)
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def run(device="cuda", n_cycles=20):
    """The experiment over ``n_cycles`` cycles: returns the RMSE of the
    smoothed and of the free ensemble mean for each cycle of the second
    half."""
    from tpu_assim_torch.analysis import _forecast, make_lienks_step
    from tpu_assim_torch.models import Lorenz96, RK4Integrator
    from tpu_assim_torch.models.integration import integrate_trajectory
    from tpu_assim_torch.ops.localization import GaspariCohn

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card found; pass --device cpu to run on "
                         "the CPU")
    dtype = torch.get_default_dtype()
    rng = np.random.RandomState(0)
    g, k, n_int = 40, 20, 4
    integ = RK4Integrator(Lorenz96(), dt=0.05)

    truth = torch.as_tensor(rng.normal(size=g) + 8.0, dtype=dtype,
                            device=device)
    truth = integrate_trajectory(integ, truth, 200)[-1]
    ens = truth[None, :] + torch.as_tensor(rng.normal(size=(k, g)),
                                           dtype=dtype, device=device)
    free = ens

    obs_idx = torch.arange(0, g, 2, dtype=torch.int32, device=device)
    obs_var = torch.full((g // 2,), 0.25, dtype=dtype, device=device)
    grid_coords = torch.arange(g, dtype=dtype, device=device)[:, None]
    obs_coords = grid_coords[obs_idx]

    def dist_fn(gc, oi):
        return torch.abs(oi[:, 1] - gc[1])[None, :]

    loc = GaspariCohn((4.0,), dist_fn)
    step = make_lienks_step(loc, integ, n_int, n_outer=3, tau=0.6,
                            max_obs=18, selection="window")

    rmse_da, rmse_free = [], []
    for c in range(n_cycles):
        truth_next = integrate_trajectory(integ, truth, n_int)[-1]
        obs = truth_next[obs_idx] + 0.5 * torch.as_tensor(
            rng.normal(size=g // 2), dtype=dtype, device=device)
        # smoother analysis of the window start, then advance the window
        ens = step(ens, obs, obs_var, obs_idx, grid_coords, obs_coords)
        ens = _forecast(integ, n_int, ens)
        free = _forecast(integ, n_int, free)
        truth = truth_next
        if c >= n_cycles // 2:
            rmse_da.append(float(torch.sqrt(torch.mean(
                (torch.mean(ens, 0) - truth) ** 2))))
            rmse_free.append(float(torch.sqrt(torch.mean(
                (torch.mean(free, 0) - truth) ** 2))))
    return rmse_da, rmse_free


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    rmse_da, rmse_free = run(ap.parse_args().device)
    print(json.dumps({
        "rmse_lienks": round(float(np.mean(rmse_da)), 3),
        "rmse_free": round(float(np.mean(rmse_free)), 3),
    }))


if __name__ == "__main__":
    main()
