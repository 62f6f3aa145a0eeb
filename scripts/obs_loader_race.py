"""
Reproduces the slot race of the native observation loader
(native/obs_pipeline.cpp, `worker`): a worker holding file ticket t + depth
can take ring slot t % depth while the worker of ticket t still fills it, so
`obs_loader_next` waits forever for file t, or returns a slot that mixes two
files. tests/test_native_runtime.py::TestObsPipeline::
test_multi_file_prefetch_order runs the same loader (6 files, depth 3).

    python scripts/obs_loader_race.py [--trials 5] [--calls 5000] [--timeout 30]

Each trial runs in its own process under a time limit: up to `--calls`
loader passes over six files of 12 observations each, checking the order
and size of every batch. Prints one line a trial (completed, or hung after
so many passes, and how many passes returned a wrong batch).
"""

import argparse
import os
import subprocess
import sys
import tempfile

TRIAL = r"""
import os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from tpu_assim.runtime.obs_pipeline import ObsLoader, write_obs_file

rng = np.random.RandomState(0)
paths = []
for i in range(6):
    gidx = rng.choice(64, size=12, replace=False).astype(np.int64)
    paths.append(os.path.join(sys.argv[2], f"c{i}.taob"))
    write_obs_file(paths[-1], rng.randn(12), np.ones(12), gidx,
                   gidx.astype(float)[:, None])
wrong = 0
for n in range(int(sys.argv[3])):
    with ObsLoader(paths, 64, 4, cap=12, depth=3) as loader:
        seen = [(idx, int((lvalid > 0).sum()))
                for idx, _v, _r, _l, _c, lvalid in loader]
    wrong += seen != [(i, 12) for i in range(6)]
    print(n + 1, wrong, flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--calls", type=int, default=5000)
    ap.add_argument("--timeout", type=float, default=30.0)
    opts = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for trial in range(1, opts.trials + 1):
        with tempfile.TemporaryDirectory() as tmp:
            try:
                proc = subprocess.run(
                    [sys.executable, "-c", TRIAL, root, tmp, str(opts.calls)],
                    capture_output=True, text=True, timeout=opts.timeout)
                out, state = proc.stdout, "completed"
            except subprocess.TimeoutExpired as exc:
                out = (exc.stdout or b"").decode()
                state = f"hung after {opts.timeout:g} s"
        last = out.split()[-2:] if out.split() else ["0", "0"]
        print(f"trial {trial}: {state}; {last[0]} passes done, {last[1]} "
              f"returned a wrong batch", flush=True)


if __name__ == "__main__":
    main()
