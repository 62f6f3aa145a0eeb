"""bench.py config 8's network (a frozen copy of the JAX package's
``bench.py:442-450``): a row-major ``nx`` x ``ny`` grid of unit cells at
(x, y), x fastest; ``n_obs`` distinct cells drawn by ``RandomState(42)``
and sorted, each observed at its cell; the same for every seed."""

import numpy as np


def build(config, seed):
    nx, ny, o = config["nx"], config["ny"], config["n_obs"]
    if nx * ny != config["grid"]:
        raise ValueError(f"nx * ny = {nx * ny} is not the grid's "
                         f"{config['grid']} columns")
    yy, xx = np.meshgrid(np.arange(ny, dtype=np.float32),
                         np.arange(nx, dtype=np.float32), indexing="ij")
    grid = np.stack([xx.ravel(), yy.ravel()], 1)
    cells = np.sort(np.random.RandomState(42).choice(nx * ny, size=o,
                                                     replace=False))
    return {"obs_idx": cells.astype(np.int64), "grid_x": grid,
            "obs_x": grid[cells]}
