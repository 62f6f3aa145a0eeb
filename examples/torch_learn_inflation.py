#!/usr/bin/env python
"""
Learn the inflation factor by gradient descent through the assimilation:
the PyTorch/CUDA counterpart of ``examples/learn_inflation.py`` (the same
arguments, defaults and seed, and ``--device``).

Setup: a cycled Lorenz-96 twin experiment. The loss is the analysis-mean
error against the (known) truth over a short window, ``rho = exp(log_rho)``
the learnable inflation, and autograd flows through the RK4 forecasts (K2,
its ``autograd.Function``) and the fused 1-D window analysis (K1, through
``_Window1D``): the kernels forward, the plain versions' replays backward.

The forecast goes through ``analysis._forecast`` (K2 on the card) where the
JAX example scans ``integ.integrate``: numerically the same, as K2 is bit
for bit its plain version. Arrays that the JAX example makes in JAX's
default dtype (f32, f64 with ``jax_enable_x64``) are made here in torch's
default dtype (``torch.get_default_dtype()``); the ensemble and the loss
are f32, as there.

Run: python examples/torch_learn_inflation.py [--steps 30] [--cycles 10]
     [--device cuda]  (--device cpu runs the plain versions on the CPU)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from tpu_assim_torch.analysis import _forecast, make_letkf_analysis
from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.models import (
    Lorenz96,
    RK4Integrator,
    integrate_trajectory,
)
from tpu_assim_torch.ops.localization import GaspariCohn


def device_or_exit(name: str) -> torch.device:
    """``name`` as a device; exits when it names a CUDA card that is not
    there (the examples never carry on on the CPU unasked)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card found; pass --device cpu to run on "
                         "the CPU")
    return device


def twin_experiment(cycles=10, ens=16, grid=40, device="cuda", *,
                    obs_every=2, n_int=2):
    """The twin experiment of ``examples/learn_inflation.py``: a truth run
    spun up 200 RK4 steps of dt 0.05, its states every ``n_int`` steps for
    ``cycles`` cycles, observations of every ``obs_every``-th point with
    variance 0.5, and an initial ensemble 1.5 off the truth; every draw
    from ``RandomState(7)`` in the JAX example's order. Returns a dict of
    tensors on ``device`` and the integrator."""
    dtype = torch.get_default_dtype()
    rng = np.random.RandomState(7)
    obs_idx_np = np.arange(0, grid, obs_every, dtype=np.int32)
    n_obs = obs_idx_np.shape[0]
    obs_var = 0.5
    integ = RK4Integrator(Lorenz96(), dt=0.05)

    # truth run + observations for the training window
    truth0 = torch.as_tensor(8.0 + rng.randn(grid), dtype=dtype,
                             device=device)
    spun = integrate_trajectory(integ, truth0, 200)[-1]
    truths = integrate_trajectory(
        integ, spun, cycles * n_int)[n_int - 1::n_int][:cycles]
    noise = np.sqrt(obs_var) * rng.randn(cycles, n_obs)
    obs_seq = torch.as_tensor(
        truths[:, torch.as_tensor(obs_idx_np, device=device)].cpu().numpy()
        + noise, dtype=dtype, device=device)
    ens0 = torch.as_tensor(spun.cpu().numpy()[None, :]
                           + 1.5 * rng.randn(ens, grid), dtype=dtype,
                           device=device)
    grid_coords = torch.arange(grid, dtype=torch.float32,
                               device=device)[:, None]
    obs_idx = torch.as_tensor(obs_idx_np, device=device)
    return dict(integ=integ, n_int=n_int, truths=truths, obs_seq=obs_seq,
                ens0=ens0, obs_idx=obs_idx, grid_coords=grid_coords,
                obs_coords=grid_coords[obs_idx],
                obs_var=torch.full((n_obs,), obs_var, dtype=torch.float32,
                                   device=device))


def make_loss(cycles=10, ens=16, grid=40, device="cuda", *, radius=4.0,
              max_obs=16, cheb_degree=16, **twin):
    """``loss(log_rho, ens0=None)``: the mean over ``cycles`` cycles of the
    squared analysis-mean error against the truth, each cycle ``n_int`` RK4
    steps and a fused1d analysis with ``rho = exp(log_rho)`` (GC radius
    ``radius``, window ``max_obs``, degree ``cheb_degree``), from the twin's
    initial ensemble or from ``ens0``. ``twin`` passes to
    :func:`twin_experiment`; the loss carries its dict as ``loss.twin``."""
    tw = twin_experiment(cycles, ens, grid, device, **twin)
    loc = GaspariCohn((radius,), coord1_distance)
    ens0 = tw["ens0"].to(torch.float32)
    truths = tw["truths"].to(torch.float32)
    geometry = (tw["obs_idx"].cpu().numpy(), tw["grid_coords"].cpu().numpy(),
                tw["obs_coords"].cpu().numpy())

    def loss(log_rho, ens0=ens0):
        """Mean analysis error vs truth over the window; rho =
        exp(log_rho) keeps inflation positive."""
        rho = torch.exp(log_rho)
        analyse = make_letkf_analysis(loc, rho, method="fused1d",
                                      max_obs=max_obs,
                                      cheb_degree=cheb_degree,
                                      geometry=geometry)
        state, errs = ens0, []
        for c in range(cycles):
            fc = _forecast(tw["integ"], tw["n_int"], state)
            state = analyse(fc, tw["obs_seq"][c], tw["obs_var"])
            errs.append(torch.mean((torch.mean(state, dim=0) - truths[c])
                                   ** 2))
        return torch.mean(torch.stack(errs))

    loss.twin = tw
    return loss


def descend(loss, steps, lr, device="cuda"):
    """Plain gradient descent on ``log_rho`` from 0 (rho = 1.0), as the JAX
    example runs it: returns ``[(loss, rho), ...]``, each step's loss before
    its update and rho after it."""
    log_rho = torch.zeros((), dtype=torch.get_default_dtype(), device=device)
    history = []
    for _ in range(steps):
        x = log_rho.detach().requires_grad_()
        val = loss(x)
        (g,) = torch.autograd.grad(val, x)
        log_rho = log_rho - lr * g
        history.append((float(val.detach()), float(torch.exp(log_rho))))
    return history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30, help="gradient steps")
    ap.add_argument("--cycles", type=int, default=10,
                    help="DA cycles inside the loss window")
    ap.add_argument("--ens", type=int, default=16)
    ap.add_argument("--grid", type=int, default=40)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args()
    device = device_or_exit(args.device)

    loss = make_loss(args.cycles, args.ens, args.grid, device)
    history = descend(loss, args.steps, args.lr, device)
    for step, (val, rho) in enumerate(history):
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:3d}  loss {val:.4f}  rho {rho:.4f}")
    print(f"learned inflation rho = {history[-1][1]:.4f}")


if __name__ == "__main__":
    main()
