"""
The port's driver entry points, the counterparts of the JAX package's
``__graft_entry__.py``:

* :func:`entry` — the flagship step on one card: a cycled Lorenz-96 step
  (the fused RK4 forecast K2, then the dense localized LETKF analysis,
  whose 256 per-column eighs go to the Jacobi kernel K3), and its
  arguments on the card;
* :func:`dryrun_multichip` — one sharded forecast + analysis step over
  ``n`` positions (members x grid for the forecast, the grid over every
  position for the analysis;
  :func:`tpu_assim_torch.parallel.forecast.sharded_cycle_step`), then the
  halo analyses (top-k by copies and by the exchange kernel K8, the
  window analysis K1), the grid-sharded localized IEnKS and, for even
  ``n``, the 2-D halo analysis, each checked.

    python -m tpu_assim_torch.entry            # on the card
    python -m tpu_assim_torch.entry --device cpu

The devices are the card's: ``n`` cards where ``n`` are visible, else ``n``
virtual shards of card 0. Nothing falls back to the CPU: without a card
both functions raise unless the caller names CPU devices.
"""

import argparse

import numpy as np
import torch

from tpu_assim_torch.analysis import make_cycle_step, make_lienks_step
from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.parallel.forecast import sharded_cycle_step
from tpu_assim_torch.parallel.halo import (
    halo_letkf_analysis,
    halo_letkf_analysis_2d,
    halo_width_for,
    shard_observations,
    shard_observations_2d,
)
from tpu_assim_torch.parallel.lienks import sharded_lienks_step
from tpu_assim_torch.parallel.mesh import (
    Mesh,
    make_forecast_analysis_mesh,
    make_grid_mesh,
)

__all__ = ["entry", "dryrun_multichip"]

DRYRUN_TOL = 1e-5       # the sharded steps against their unsharded twins
WINDOW_TOL = 1e-3       # the window analysis (K1, Chebyshev) against top-k


def _build_problem(ens_size, len_grid, nr_obs, dtype, device):
    """The JAX package's problem, drawn in its order from
    ``RandomState(7)``: (state [k, g], obs_vals [o], obs_var [o], obs_idx
    [o], grid_coords [g, 1], obs_coords [o, 1]) on ``device``."""
    rnd = np.random.RandomState(7)
    state = rnd.normal(size=(ens_size, len_grid)).astype(dtype)
    obs_locs = np.linspace(0, len_grid, num=nr_obs, endpoint=False)
    obs_idx = np.rint(obs_locs).astype(np.int32) % len_grid
    obs_vals = rnd.normal(size=(nr_obs,)).astype(dtype)
    obs_var = np.full(nr_obs, 0.5, dtype=dtype)
    grid_coords = np.arange(len_grid, dtype=dtype)[:, None]
    obs_coords = obs_locs.astype(dtype)[:, None]
    return tuple(torch.as_tensor(a, device=device) for a in (
        state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords))


def _dist_fn(grid_coord, obs_info):
    """Distance on column 1 of the info rows (column 0 is time)."""
    return torch.abs(obs_info[:, 1] - grid_coord[1])[None, :]


def _dist_2d(grid_coord, obs_info):
    return torch.abs(obs_info[:, 1:3] - grid_coord[1:3][None, :]).T


def _card():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; the entry points run "
                           "on the card unless given CPU devices (e.g. "
                           "device='cpu')")
    return torch.device("cuda", 0)


def entry(device=None, dtype="float32"):
    """Return ``(step, args)``: the cycled Lorenz-96 step (ens 20, grid
    256, 64 observations, Gaspari-Cohn r = 8, 4 RK4 steps of dt 0.05,
    inflation 1.1) and its arguments on ``device`` (default: the card),
    ``step(*args) -> analysis [20, 256]``."""
    device = _card() if device is None else torch.device(device)
    integrator = RK4Integrator(Lorenz96(), dt=0.05)
    loc = GaspariCohn((8.0,), _dist_fn)
    step = make_cycle_step(integrator, n_int_steps=4, localization=loc,
                           inf_factor=1.1)
    return step, _build_problem(20, 256, 64, dtype, device)


def _dryrun_devices(n_devices: int, devices):
    if devices is not None:
        devices = list(devices)
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have "
                             f"{len(devices)}")
        return devices[:n_devices]
    _card()
    if torch.cuda.device_count() >= n_devices:
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [torch.device("cuda", 0)] * n_devices


def _check(cond, what):
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def _max_abs(a, b) -> float:
    return float((a - b.to(a.device)).abs().max())


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run one sharded forecast + analysis step over ``n_devices``
    positions, then the halo analyses and the grid-sharded smoother, and
    raise on any failed check.

    ``devices``: the devices of the positions (repeats allowed; e.g.
    ``["cpu"] * 8``); by default ``n_devices`` cards, or that many virtual
    shards of card 0 where fewer are visible. Without a card and without
    ``devices`` it raises ``RuntimeError``.

    For even ``n_devices`` the step's mesh is ``(ens 2, grid n / 2)`` and
    the analysis splits the grid over both axes; for odd, a grid mesh.
    The problem: ens 8, grid 16 n, 32 observations, Gaspari-Cohn r = 4, 2
    RK4 steps of dt 0.01, inflation 1.1, f32."""
    devices = _dryrun_devices(n_devices, devices)
    home = torch.device(devices[0])
    ens_size, len_grid, nr_obs = 8, 16 * n_devices, 32
    args = _build_problem(ens_size, len_grid, nr_obs, "float32", home)
    state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords = args
    loc = GaspariCohn((4.0,), _dist_fn)
    integrator = RK4Integrator(Lorenz96(), dt=0.01)

    # the members x grid forecast and the analysis over every position
    if n_devices % 2 == 0:
        mesh = make_forecast_analysis_mesh(2, n_devices // 2, devices)
    else:
        mesh = make_grid_mesh(n_devices, devices)
    full_step = sharded_cycle_step(mesh, integrator, 2, loc, 1.1)
    out = full_step(*args)
    _check(out.shape == (ens_size, len_grid), f"step shape {out.shape}")
    _check(bool(torch.isfinite(out).all()), "the step is not finite")
    local = make_cycle_step(integrator, 2, loc, inf_factor=1.1)(*args)
    err = _max_abs(out, local)
    _check(err < DRYRUN_TOL, f"the sharded step differs from the unsharded "
           f"one by {err!r}")

    # the obs-sharded halo analyses over a grid ring of every position
    ring_mesh = make_grid_mesh(n_devices, devices)
    sharded_obs = shard_observations(
        *(a.cpu().numpy() for a in (obs_vals, obs_var, obs_idx, obs_coords)),
        len_grid, n_devices)
    halo_args = (state, *(torch.as_tensor(a, device=home)
                          for a in sharded_obs[:5]), grid_coords)
    opts = dict(max_obs=16, inf_factor=1.1,
                halo_width=halo_width_for(4.0, len_grid / n_devices))
    halo_out = halo_letkf_analysis(ring_mesh, loc, **opts)(*halo_args)
    _check(halo_out.shape == (ens_size, len_grid),
           f"halo shape {halo_out.shape}")
    _check(bool(torch.isfinite(halo_out).all()), "halo not finite")
    rdma_out = halo_letkf_analysis(ring_mesh, loc, comm="rdma",
                                   **opts)(*halo_args)
    _check(torch.equal(rdma_out, halo_out),
           "comm='rdma' differs from 'ppermute'")
    win_out = halo_letkf_analysis(ring_mesh, loc, local_method="window",
                                  cheb_degree=32, **opts)(*halo_args)
    _check(bool(torch.isfinite(win_out).all()), "window not finite")
    err = _max_abs(win_out, halo_out)
    _check(err < WINDOW_TOL, f"window differs from top-k by {err!r}")

    # the grid-sharded localized IEnKS against the unsharded step
    smoother = dict(n_outer=2, tau=0.8, max_obs=16, selection="window")
    li_local = make_lienks_step(loc, integrator, 2, **smoother)(*args)
    li_sh = sharded_lienks_step(ring_mesh, loc, integrator, 2,
                                **smoother)(*args)
    _check(bool(torch.isfinite(li_sh).all()), "sharded IEnKS not finite")
    err = _max_abs(li_sh, li_local)
    _check(err < DRYRUN_TOL, f"sharded IEnKS differs by {err!r}")

    if n_devices % 2 == 0:
        # the 2-D domain decomposition over (row, col) tiles
        m_rows, m_cols = 2, n_devices // 2
        n_rows, n_cols = 4 * m_rows, 4 * m_cols
        mesh2d = Mesh(np.asarray(devices, dtype=object).reshape(
            m_rows, m_cols), ("row", "col"))
        rnd = np.random.RandomState(3)
        state2d = rnd.normal(size=(ens_size, n_rows, n_cols))
        n_obs2 = n_rows * n_cols // 4
        flat = rnd.choice(n_rows * n_cols, size=n_obs2, replace=False)
        obs_ij = np.stack([flat // n_cols, flat % n_cols], 1).astype(
            np.int32)
        rr, cc = np.meshgrid(np.arange(n_rows, dtype=np.float64),
                             np.arange(n_cols, dtype=np.float64),
                             indexing="ij")
        gc2 = np.stack([rr, cc], axis=-1)
        sharded2 = shard_observations_2d(
            rnd.normal(size=n_obs2), np.full(n_obs2, 0.5), obs_ij,
            gc2[obs_ij[:, 0], obs_ij[:, 1]], (n_rows, n_cols),
            (m_rows, m_cols))
        f32 = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.float32 if a.dtype.kind == "f" else None,
            device=home)
        analyse2d = halo_letkf_analysis_2d(
            mesh2d, GaspariCohn((2.0,), _dist_2d), max_obs=16,
            grid_shape=(n_rows, n_cols), halo=(1, 1), inf_factor=1.1)
        out2d = analyse2d(f32(state2d), *map(f32, sharded2[:5]), f32(gc2))
        _check(out2d.shape == (ens_size, n_rows, n_cols),
               f"2-D halo shape {out2d.shape}")
        _check(bool(torch.isfinite(out2d).all()), "2-D halo not finite")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="a device such as 'cpu' (default: the card)")
    a = parser.parse_args(argv)
    step, args = entry(a.device)
    print(tuple(step(*args).shape))
    if a.device is None:
        dryrun_multichip(max(torch.cuda.device_count(), 2))
    else:
        dryrun_multichip(2, devices=[a.device] * 2)
    print("dryrun ok")


if __name__ == "__main__":
    main()
