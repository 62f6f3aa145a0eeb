"""
Times the 1-D window kernel (K1), the fused RK4 forecast (K2), the
neighbourhood Chebyshev kernel (K4) and the 2-D window kernel (K6) on one
CUDA card at the shapes of their main paths, for the tpu_assim_torch
package found under ``--root`` (default: this checkout), and prints one
JSON line with the card's name and power limit.

    python3 chip_kernel_times.py [--root DIR] [--label NAME] [--check]
                                 [--only PREFIX]

The inputs, the calls and the timers are those of ``chip_smoke.py`` beside
this file (its ``build_workload``, ``window_inputs``, ``nbh_inputs``,
``run_window``, ``run_cheb``, ``median_ms``, ``device_profile`` and
``compare``, ``bench_config``); only the package under test comes from
``--root``. Shapes: the headline workload (ens 40, grid 10^4, 10^3
observations, GC radius 20, rho 1.1, degree 12; bench.py's config 6): K1 at
windows 12 and 8; K2 on the ensemble, 4 steps of dt 0.05 (the cycle's
forecast); K4 on the window neighbourhoods at nb 12, ns 1, degree 12, at
the class smoother's nb 24, ns 6, degree 24 and at nb 36, ns 6, degree 48;
K1 at bench.py's config 5 (ens 100, 2^20 columns, 2^16 evenly spaced
observations, nb 8, degree 16; point observations in place of its 4-point
mean, which changes the values and not the work) and config 10 (4 stacked
observation times, tied coordinates, nb 32, the auto degree); and K1 where
a block's windows spread beyond what its union route stages: the headline
workload on a shuffled grid and with 20 000 observations (nb 12 and 8),
config 5 on a shuffled grid, and ens 100 on 2^18 columns with 2^19
observations (nb 8, degree 16). K6 at bench.py's config 8 (1024 x 1024
columns, ens 40, 10^5 observed cells, GC radius 4 in x and y, degree 16)
through the strip plan of the benchmark's ``grid2d-1024`` cell (16 strips,
the plan's window), at config 7 (128 x 128, 1024 cells, the exact window,
degree 12), on a dense network where every slot of every window weighs
(512 rows of 128 columns, 2^18 observations, ``dense_network``; GC radius
8, nb 52, degree 16, not strict): the side of K6's per-column width where
there is nothing to leave out, and whose slices are too wide to stage; and
config 7 on a 2 x 4 tile mesh of virtual shards of the card
(``chip_smoke.py``'s phase 26: 8 launches of 16 tiles, too few to
stage). Per call, three times: ``ms``, the
median of 20 samples of 10 back-to-back calls between CUDA events (what a
caller waits, host-bound where the wrapper's host work outlasts the
kernel; the ``ms`` of chip_smoke.py's kernels line); ``device_ms``, the device time of a call by
torch.profiler over 20 calls (every kernel the call launches: K1's
sortedness check included), and for K6's cases ``k6_device_ms``, that of
its launches alone; ``host_ms``, the host's time to issue one call, over
200 calls without a wait. ``--check`` also holds each kernel against its
plain version on the same inputs (``compare``: within 1e-5 of max|plain|,
NaN entries identical; the relative error is printed; the halo case has
none). For K1, ``union_share`` is the share of its last launch's blocks
that staged their windows' union (absent where the package has no union
route); for K6, ``width_shares`` the share of its last launch's columns
solved at each width of its register route (absent where the package
does not count them) and ``staged_share`` the share of its last launch's
blocks that staged their slice of the observation table (absent where the
package has no staging). ``sha256`` is the first 16 hex digits of the hash
of each call's output bytes: two checkouts whose outputs agree to the bit
print the same.

``--only`` runs the cases whose names start with PREFIX (``window2d``: K6's
alone). To compare two checkouts on one card, run it in one command for
each in turns (A, B, B, A).
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

import numpy as np


def load_chip_smoke(root):
    """``chip_smoke.py`` of this checkout as a module, importing the
    tpu_assim_torch package under ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def host_ms(fn, calls=200):
    """The host's time to issue one call of ``fn``, without a wait."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def window_case(cs, args, nb, degree, strict=True):
    """A call of K1 (or, with ``plain=True``, its plain version) on the
    inputs ``args`` of ``cs.window_inputs`` at window ``nb`` and Chebyshev
    degree ``degree``."""
    k = args[0].shape[0]

    def run(plain=False):
        if not plain:
            return cs.k1.letkf_window_analysis_fused(
                *args, (k - 1) / cs.INF, cs.RADIUS, k, nb=nb, degree=degree,
                strict=strict)
        return cs.k1.window_analysis_plain(
            *args[:4], args[4][None], args[5][None], (k - 1) / cs.INF,
            cs.RADIUS, ens_size=k, nb=nb, degree=degree, epsilon=1e-5,
            taper="gc2", strict=strict)[0]
    return run


def shuffled(args, seed=3):
    """``cs.window_inputs``' arguments with the grid's columns in a seeded
    random order (coordinates, perturbations and means alike)."""
    import torch

    g = args[3].shape[0]
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(g)).to(
        args[3].device)
    return args[:3] + [args[3][perm].contiguous(),
                       args[4][:, perm].contiguous(),
                       args[5][perm].contiguous()]


def window2d_case(cs, args, kw):
    """A call of K6 (or, with ``plain=True``, its plain version) on the
    inputs ``args`` and options ``kw`` of ``window2d_banded``."""
    def run(plain=False):
        fn = cs.k1.window2d_plain if plain else cs.k1.window2d_banded
        return fn(*args, **kw)
    return run


def halo2d_case(cs, dev):
    """Bench config 7 on a 2 x 4 tile mesh of virtual shards of the card,
    the window analysis with a halo of one tile, as ``chip_smoke.py``'s
    phase 26 builds it: one K6 launch a shard. It has no plain version
    (``run(plain=True)`` gives None)."""
    torch = cs.torch
    w7 = cs.workload_2d(128, 1024, sort_cells=False)
    n7, m_rows, m_cols = 128, 2, 4
    obs_ij = np.stack([w7[3] // n7, w7[3] % n7], 1).astype(np.int32)
    grid7 = w7[4].reshape(n7, n7, 2)
    sh7 = cs.shard_observations_2d(w7[1], w7[2], obs_ij, w7[5], (n7, n7),
                                   (m_rows, m_cols))
    nb7, blk7 = cs.halo2d_sizes(sh7[3], sh7[4], grid7, m_rows, m_cols, 1,
                                cs.R2)
    mesh7 = cs.Mesh(np.asarray([dev] * m_rows * m_cols, dtype=object)
                    .reshape(m_rows, m_cols), ("row", "col"))
    fn = cs.halo_letkf_analysis_2d(
        mesh7, cs.GaspariCohn((cs.R2, cs.R2), cs.dist2), max_obs=nb7,
        grid_shape=(n7, n7), halo=(1, 1), inf_factor=cs.INF,
        cheb_degree=cs.DEGREE, local_method="window", obs_block=blk7)
    args = [torch.as_tensor(a, device=dev) for a in (
        w7[0].reshape(40, n7, n7),) + sh7[:5] + (grid7,)]

    def run(plain=False):
        return None if plain else fn(*args)
    return (f"window2d halo 2 x 4 tiles of config 7 nb {nb7} degree "
            f"{cs.DEGREE}", run)


def window2d_cases(cs, dev):
    """K6's cases: config 8 through the strips, config 7 banded, the dense
    network and config 7's 2 x 4 halo tiles; ``[(name, run), ...]``."""
    torch = cs.torch
    loc = cs.GaspariCohn((cs.R2, cs.R2), cs.dist2)
    reg = 39 / cs.INF
    w8 = cs.workload_2d(1024, 100_000, sort_cells=True)
    plan = cs._strip_plan_2d(loc, w8[4], w8[5], 16, None, True)
    wt8 = [torch.as_tensor(a, device=dev) for a in w8[:4]]
    perts, innov = cs._normalized_obs_space(wt8[0][:, wt8[3].long()], wt8[1],
                                            wt8[2])
    mean = wt8[0].mean(0)
    args8, kw8 = cs._strip_inputs_2d(plan, perts, innov,
                                     (wt8[0] - mean)[None], mean[None], reg,
                                     16)
    w7 = cs.workload_2d(128, 1024, sort_cells=False)
    nb7 = cs.exact_nb(cs.k1.max_in_support_2d(w7[5], w7[4], cs.R2, cs.R2))
    blk7 = cs.k1.required_obs_block_2d(w7[5][:, 1], w7[4][:, 1], cs.R2)
    wt7 = [torch.as_tensor(a, device=dev) for a in w7]
    perts, innov = cs._normalized_obs_space(wt7[0][:, wt7[3].long()], wt7[1],
                                            wt7[2])
    mean = wt7[0].mean(0)
    args7, width7 = cs.k1.window2d_inputs(
        perts, innov, wt7[5], wt7[4], (wt7[0] - mean)[None], mean[None], reg,
        cs.R2, cs.R2, blk7)
    kw7 = dict(width=width7, ens_size=40, nb=nb7, degree=cs.DEGREE,
               epsilon=1e-5, taper="gc2", strict=True)
    grid, obs = dense_network(np.random.RandomState(cs.SEED + 25))
    g, o = grid.shape[0], obs.shape[0]
    rnd = np.random.RandomState(cs.SEED + 26)
    perts, innov, sp, mean = (torch.as_tensor(
        rnd.normal(size=s).astype("f4"), device=dev)
        for s in ((40, o), (o,), (1, 40, g), (1, g)))
    blk = cs.k1.required_obs_block_2d(obs[:, 1], grid[:, 1], 8.0)
    argsd, widthd = cs.k1.window2d_inputs(
        perts, innov, torch.as_tensor(obs, device=dev),
        torch.as_tensor(grid, device=dev), sp, mean, reg, 8.0, 8.0, blk)
    kwd = dict(width=widthd, ens_size=40, nb=52, degree=16, epsilon=1e-5,
               taper="gc2", strict=False)
    return [
        (f"window2d config 8 strips 16 nb {kw8['nb']} degree 16",
         window2d_case(cs, args8, kw8)),
        (f"window2d config 7 nb {nb7} degree {cs.DEGREE}",
         window2d_case(cs, args7, kw7)),
        ("window2d dense, every slot weighs, 2^16 columns nb 52 degree 16",
         window2d_case(cs, argsd, kwd)),
        halo2d_case(cs, dev),
    ]


def dense_network(rnd, rows=512, nx=128, per_unit=4):
    """A grid of ``rows`` rows of ``nx`` columns, 100 apart in y, so that
    each row's tile sees only its own row's observations: ``per_unit``
    observations a unit of x within 1 of the row in y. A window of 52 of
    them lies well inside a GC radius of 8: every slot weighs."""
    xx, yy = np.meshgrid(np.arange(nx, dtype="f4"),
                         100.0 * np.arange(rows, dtype="f4"))
    grid = np.stack([xx.ravel(), yy.ravel()], 1)
    n = per_unit * nx * rows
    y = 100.0 * np.repeat(np.arange(rows), per_unit * nx)
    obs = np.stack([rnd.uniform(-0.5, nx - 0.5, n),
                    y + rnd.uniform(-1.0, 1.0, n)], 1).astype("f4")
    return grid, obs


def digest(out):
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(out.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def other_cases(cs, dev):
    """K1's, K2's and K4's cases; ``[(name, run), ...]``."""
    torch = cs.torch
    w = cs.build_workload(40, 10000, 1000)
    wt = [torch.as_tensor(x, device=dev) for x in w]
    win_args = cs.window_inputs(w, dev)
    loc = cs.GaspariCohn((cs.RADIUS,), cs.coord1_distance)

    cases = []
    for nb in (12, 8):
        cases.append((f"window1d nb {nb} ns 1 degree {cs.DEGREE}",
                      lambda nb=nb, plain=False: cs.run_window(
                          win_args, nb, plain=plain)))
    for config in (5, 10):
        wb, nb, degree, _ = cs.bench_config(config)
        cases.append((f"window1d config {config} ens {wb[0].shape[0]} grid "
                      f"{wb[0].shape[1]} nb {nb} degree {degree}",
                      window_case(cs, cs.window_inputs(wb, dev), nb,
                                  degree)))
    # windows wider than a block's staged union: a shuffled grid, and twice
    # as many observations as columns (strict off: ~4 r of them in support)
    for nb in (12, 8):
        cases.append((f"window1d shuffled grid nb {nb} degree {cs.DEGREE}",
                      window_case(cs, shuffled(win_args), nb, cs.DEGREE)))
    wide = cs.window_inputs(cs.build_workload(40, 10000, 20000), dev)
    for nb in (12, 8):
        cases.append((f"window1d o 20000 > g nb {nb} degree {cs.DEGREE}",
                      window_case(cs, wide, nb, cs.DEGREE, strict=False)))
    wb, nb, degree, _ = cs.bench_config(5)
    cases.append((f"window1d config 5 shuffled grid nb {nb} degree {degree}",
                  window_case(cs, shuffled(cs.window_inputs(wb, dev)), nb,
                              degree)))
    wide = cs.window_inputs(cs.build_workload(100, 1 << 18, 1 << 19), dev)
    cases.append((f"window1d ens 100 grid 2^18 o 2^19 nb 8 degree {degree}",
                  window_case(cs, wide, 8, degree, strict=False)))
    del wb, wide
    cases.append(("rk4_l96 [40, 10^4] x 4 steps",
                  lambda plain=False: (
                      cs.k2.rk4_steps_plain if plain else
                      cs.k2.fused_rk4_steps)(cs.Lorenz96(), wt[0], 0.05, 4)))
    for nb, ns, degree in ((12, 1, cs.DEGREE), (24, 6, 24), (36, 6, 48)):
        a = cs.nbh_inputs(loc, wt, nb, ns)
        cases.append((f"nbh_cheb nb {nb} ns {ns} degree {degree}",
                      lambda a=a, degree=degree, plain=False: cs.run_cheb(
                          a, degree, plain=plain)))
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", default="")
    opts = ap.parse_args()
    cs = load_chip_smoke(opts.root)
    torch = cs.torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_times.py needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    if opts.only.startswith("window2d"):
        cases = window2d_cases(cs, dev)
    else:
        cases = other_cases(cs, dev) + window2d_cases(cs, dev)
    cases = [(name, run) for name, run in cases
             if name.startswith(opts.only)]

    result = {"label": opts.label, "root": opts.root, "card": cs.card(),
              "ms": {}, "device_ms": {}, "k6_device_ms": {}, "host_ms": {},
              "rel_err": {}, "union_share": {}, "width_shares": {},
              "staged_share": {}, "sha256": {}}
    share = getattr(cs.k1, "window1d_union_share", None)
    widths = getattr(cs.k1, "window2d_width_counts", None)
    staged = getattr(cs.k1, "window2d_staged_share", None)
    for name, run in cases:
        out = run()
        result["sha256"][name] = digest(out)
        if opts.check:
            plain = run(plain=True)
            if plain is not None:
                _, result["rel_err"][name] = cs.compare(out, plain, name)
            del plain
        del out
        if name.startswith("window1d") and share is not None:
            run()
            result["union_share"][name] = share()
        if name.startswith("window2d") and widths is not None:
            run()
            counts = widths()
            total = sum(counts.values())
            result["width_shares"][name] = {w: n / total
                                            for w, n in counts.items() if n}
            if staged is not None:
                result["staged_share"][name] = staged()
        result["ms"][name] = cs.median_ms(run)
        _, result["device_ms"][name], rows = cs.device_profile(run, calls=20)
        if name.startswith("window2d"):
            result["k6_device_ms"][name] = sum(
                ms for kernel, ms, _ in rows if "window2d" in kernel)
        result["host_ms"][name] = host_ms(run)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
