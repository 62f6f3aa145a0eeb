#!/usr/bin/env python
"""
Shard-scaling harness for the obs-sharded halo LETKF: the PyTorch/CUDA
counterpart of ``examples/scaling.py`` (the same arguments and defaults,
and ``--device`` and ``--shards``). The same halo analysis
(``parallel.halo.halo_letkf_analysis``, top-k through kernel K4, degree
12) runs over 1, 2, 4 and 8 shards.

In one process the shards are virtual: ``--shards`` positions of one
device (``make_grid_mesh(n, devices=[device] * n)``). Under ``torchrun``
the mesh spans the processes, each contributing ``n / WORLD_SIZE``
positions of its own card, and the inputs are this process's blocks
(``host_local_to_global``):

    python examples/torch_scaling.py [--device cuda] [--weak]
    torchrun --nproc-per-node 4 examples/torch_scaling.py --shards 4,8

Prints one JSON line per shard count with grid-points/s and the
efficiency per shard against 1 shard. Shards that share a card measure
the dispatch of the shards, not scaling; a run of such shards carries
that caveat in every row.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.parallel import multihost
from tpu_assim_torch.parallel.halo import (
    halo_letkf_analysis,
    halo_width_for,
    shard_observations,
)
from tpu_assim_torch.parallel.mesh import Mesh

CAVEAT = ("virtual shards share one card: this row measures the dispatch "
          "of the shards on it, not scaling across devices")


def parser():
    p = argparse.ArgumentParser()
    p.add_argument("--ens", type=int, default=40)
    p.add_argument("--grid-per-dev", type=int, default=4096)
    p.add_argument("--obs-frac", type=float, default=0.1)
    p.add_argument("--radius", type=float, default=20.0)
    p.add_argument("--max-obs", type=int, default=16)
    p.add_argument("--weak", action="store_true",
                   help="weak scaling: grid grows with shards "
                        "(default: strong scaling on the largest grid)")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--shards", default="1,2,4,8",
                   help="comma-separated shard counts")
    p.add_argument("--device", default="cuda",
                   help="this process's device (under torchrun: "
                        "cuda:LOCAL_RANK)")
    return p


def build_workload(ens_size, len_grid, nr_obs, seed=42):
    """The reference benchmark's workload recipe (bench.py:build_workload):
    random ensemble, evenly spaced point observations, unit variances."""
    rnd = np.random.RandomState(seed)
    state = rnd.normal(size=(ens_size, len_grid)).astype("float32")
    obs_locs = np.linspace(0, len_grid, num=nr_obs, endpoint=False)
    obs_idx = np.rint(obs_locs).astype(np.int32) % len_grid
    obs_vals = rnd.normal(size=(nr_obs,)).astype("float32")
    obs_var = np.ones(nr_obs, dtype="float32")
    grid_coords = np.arange(len_grid, dtype="float32")[:, None]
    obs_coords = obs_locs.astype("float32")[:, None]
    return state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if multihost.process_count() > 1:
        torch.distributed.barrier()


def time_call(fn, args, device, reps):
    """Median seconds per call over ``reps`` calls (one warm-up)."""
    fn(*args)
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def make_mesh(n_shards, device):
    """``n_shards`` positions of this process's device, or, across
    processes, ``n_shards / WORLD_SIZE`` of each process's device."""
    procs = multihost.process_count()
    if n_shards % procs:
        raise ValueError(f"{n_shards} shards do not split over {procs} "
                         "processes")
    if procs == 1:
        return Mesh([device] * n_shards, ("grid",))
    return multihost.global_grid_mesh(devices=[device] * (n_shards // procs))


def inputs(mesh, w, g, n_shards, device):
    """The analysis's arguments: whole tensors in one process, this
    process's blocks across processes."""
    vals, var, lidx, coords, valid, _ = shard_observations(
        w[1], w[2], w[3], w[5], g, n_shards)
    whole = (w[0], vals, var, lidx, coords, valid, w[4])
    if multihost.process_count() == 1:
        return [torch.as_tensor(a, device=device) for a in whole]
    rank, procs = multihost.process_index(), multihost.process_count()

    def local(a, dim):
        a = torch.as_tensor(a)
        size = a.shape[dim] // procs
        return a.narrow(dim, rank * size, size)

    return [multihost.host_local_to_global(mesh, local(a, d), axis=d)
            for a, d in zip(whole, (1, 0, 0, 0, 0, 0, 0))]


def main(argv=None):
    args = parser().parse_args(argv)
    multihost.initialize_multihost()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    sizes = [int(n) for n in args.shards.split(",")]
    n_max = max(sizes)
    # several positions of one device anywhere in the run: every row is
    # virtual shards' dispatch
    shares = n_max // multihost.process_count() > 1
    base = None
    rows = []
    for n_shards in sizes:
        g = args.grid_per_dev * (n_shards if args.weak else n_max)
        o = int(g * args.obs_frac)
        w = build_workload(args.ens, g, o)
        mesh = make_mesh(n_shards, device)
        analyse = halo_letkf_analysis(
            mesh, GaspariCohn((args.radius,), coord1_distance),
            max_obs=args.max_obs,
            halo_width=halo_width_for(args.radius, g / n_shards),
            inf_factor=1.1, use_pallas=True,
            # pinned, as examples/scaling.py pins it (bench.py config 3)
            cheb_degree=12)
        t = time_call(analyse, inputs(mesh, w, g, n_shards, device), device,
                      args.reps)
        gps = g / t
        per_shard = gps / n_shards
        base = per_shard if base is None else base
        row = {"devices": n_shards,
               "processes": multihost.process_count(),
               "grid": g,
               "grid_points_per_s": gps,
               "efficiency_vs_1dev": per_shard / base}
        if shares:
            row["CAVEAT"] = CAVEAT
        rows.append(row)
        if multihost.process_index() == 0:
            print(json.dumps(row), flush=True)
    multihost.shutdown_multihost()
    return rows


if __name__ == "__main__":
    main()
