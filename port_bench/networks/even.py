"""``build_workload``'s network (a frozen copy of the JAX package's
``bench.py`` helper): ``n_obs`` locations evenly spaced over ``[0,
grid)``, each observing the nearest column; the same for every seed."""

import numpy as np


def build(config, seed):
    g, o = config["grid"], config["n_obs"]
    locs = np.linspace(0, g, num=o, endpoint=False)
    return {"obs_idx": np.rint(locs).astype(np.int64) % g,
            "grid_x": np.arange(g, dtype=np.float32)[:, None],
            "obs_x": locs.astype(np.float32)[:, None]}
