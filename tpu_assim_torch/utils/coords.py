"""
Coordinate / index interop helpers (the port's copy of
:mod:`tpu_assim.utils.coords`, numpy only).

The hot path does not depend on pandas: the grids are explicit float
coordinate matrices (``EnsembleState.grid_coords``), and these helpers
convert user-facing pandas/datetime indexes into that representation.
pandas is imported only where it is there to be asked.
"""

import numpy as np

__all__ = [
    "times_to_seconds",
    "index_to_array",
    "multiindex_to_array",
]


def times_to_seconds(times) -> np.ndarray:
    """Datetime-like index/array -> float unix seconds
    (reference: utilities/pandas.py:28-45 ``dtindex_to_total_seconds``)."""
    arr = np.asarray(times)
    if np.issubdtype(arr.dtype, np.datetime64):
        return (
            arr.astype("datetime64[ns]").astype(np.int64) / 1e9
        ).astype(np.float64)
    return arr.astype(np.float64)


def index_to_array(index) -> np.ndarray:
    """Grid index -> float [n, n_levels] coordinate matrix for distance
    functions (reference: utilities/pandas.py:70-102). Accepts a pandas
    Index/MultiIndex, a 1-D array, or an [n, d] array; datetime levels are
    converted to unix seconds."""
    try:
        import pandas as pd

        if isinstance(index, pd.MultiIndex):
            return multiindex_to_array(index)
        if isinstance(index, pd.Index):
            return times_to_seconds(index.values)[:, None] if (
                np.issubdtype(np.asarray(index.values).dtype, np.datetime64)
            ) else np.asarray(index.values, dtype=np.float64)[:, None]
    except ImportError:
        pass
    arr = np.asarray(index)
    if arr.ndim == 1:
        return times_to_seconds(arr)[:, None]
    return arr.astype(np.float64)


def multiindex_to_array(index) -> np.ndarray:
    """pandas MultiIndex -> float [n, n_levels] matrix (the reference goes
    via ``multiindex_to_frame``, utilities/pandas.py:48-67)."""
    cols = []
    for lvl in range(index.nlevels):
        vals = index.get_level_values(lvl).values
        cols.append(times_to_seconds(vals))
    return np.stack(cols, axis=1)
