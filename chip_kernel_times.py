"""
Times the 1-D window kernel (K1), the fused RK4 forecast (K2) and the
neighbourhood Chebyshev kernel (K4) on one CUDA card at the shapes of their
main paths, for the tpu_assim_torch package found under ``--root``
(default: this checkout), and prints one JSON line with the card's name and
power limit.

    python3 chip_kernel_times.py [--root DIR] [--label NAME] [--check]

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
observations (nb 8, degree 16). Per call, three times: ``ms``, the median of 20
samples of 10 back-to-back calls between CUDA events (what a caller waits,
host-bound where the wrapper's host work outlasts the kernel; the ``ms`` of
chip_smoke.py's kernels line); ``device_ms``, the device time of a call by
torch.profiler over 20 calls (every kernel the call launches: K1's
sortedness check included); ``host_ms``, the host's time to issue one call,
over 200 calls without a wait. ``--check`` also holds each kernel against
its plain version on the same inputs (``compare``: within 1e-5 of
max|plain|, NaN entries identical; the relative error is printed). For
K1, ``union_share`` is the share of its last launch's blocks that staged
their windows' union (absent where the package has no union route).

To compare two checkouts on one card, run it in one command for each in
turns (A, B, B, A).
"""

import argparse
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="")
    ap.add_argument("--check", action="store_true")
    opts = ap.parse_args()
    cs = load_chip_smoke(opts.root)
    torch = cs.torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_times.py needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
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

    result = {"label": opts.label, "root": opts.root, "card": cs.card(),
              "ms": {}, "device_ms": {}, "host_ms": {}, "rel_err": {},
              "union_share": {}}
    share = getattr(cs.k1, "window1d_union_share", None)
    for name, run in cases:
        if opts.check:
            _, result["rel_err"][name] = cs.compare(run(), run(plain=True),
                                                    name)
        if name.startswith("window1d") and share is not None:
            run()
            result["union_share"][name] = share()
        result["ms"][name] = cs.median_ms(run)
        result["device_ms"][name] = cs.device_profile(run, calls=20)[1]
        result["host_ms"][name] = host_ms(run)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
