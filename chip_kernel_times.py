"""
Times the 1-D window kernel (K1) and the neighbourhood Chebyshev kernel (K4)
on one CUDA card at the shapes of their main paths, for the tpu_assim_torch
package found under ``--root`` (default: this checkout), and prints one JSON
line with the card's name and power limit.

    python3 chip_kernel_times.py [--root DIR] [--label NAME] [--check]

The inputs, the calls and the timers are those of ``chip_smoke.py`` beside
this file (its ``build_workload``, ``window_inputs``, ``nbh_inputs``,
``run_window``, ``run_cheb``, ``median_ms``, ``device_profile`` and
``compare``); only the package under test comes from ``--root``. Shapes:
the headline workload (ens 40, grid 10^4, 10^3 observations, GC radius 20,
rho 1.1, degree 12): K1 at windows 12 and 8; K4 on the window
neighbourhoods at nb 12, ns 1, degree 12, at the class smoother's nb 24,
ns 6, degree 24 and at nb 36, ns 6, degree 48. Per call, three times:
``ms``, the median of 20 samples of 10 back-to-back calls between CUDA
events (what a caller waits, host-bound where the wrapper's host work
outlasts the kernel; the ``ms`` of chip_smoke.py's kernels line);
``device_ms``, the device time of a call by torch.profiler over 20 calls
(K1's sortedness check included); ``host_ms``, the host's time to issue
one call, over 200 calls without a wait. ``--check`` also holds each
kernel against its plain version on the same inputs (``compare``: within
1e-5 of max|plain|, NaN entries identical; the relative error is printed).

To compare two checkouts on one card, run it in one command for each in
turns (A, B, B, A).
"""

import argparse
import importlib.util
import json
import os
import sys
import time


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
    for nb, ns, degree in ((12, 1, cs.DEGREE), (24, 6, 24), (36, 6, 48)):
        a = cs.nbh_inputs(loc, wt, nb, ns)
        cases.append((f"nbh_cheb nb {nb} ns {ns} degree {degree}",
                      lambda a=a, degree=degree, plain=False: cs.run_cheb(
                          a, degree, plain=plain)))

    result = {"label": opts.label, "root": opts.root, "card": cs.card(),
              "ms": {}, "device_ms": {}, "host_ms": {}, "rel_err": {}}
    for name, run in cases:
        if opts.check:
            _, result["rel_err"][name] = cs.compare(run(), run(plain=True),
                                                    name)
        result["ms"][name] = cs.median_ms(run)
        result["device_ms"][name] = cs.device_profile(run, calls=20)[1]
        result["host_ms"][name] = host_ms(run)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
