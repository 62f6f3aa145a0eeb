"""
Shared TerrSysMP dataset <-> state conversion (PyTorch port of
:mod:`tpu_assim.models.terrsysmp.common`), over the numpy-backed
:class:`~tpu_assim_torch.utils.dataset.Dataset`:
vertical-grid merging, stacking of (horizontal x vertical) grid dims into the
flat ``grid`` dim of an :class:`~tpu_assim.state.EnsembleState`, and the
write-back of an analysis into the original model dataset. The stacked grid
carries an explicit ``[grid, n_coord]`` coordinate matrix (the MultiIndex
replacement) that localization distance functions consume directly.
"""

import logging
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from tpu_assim_torch.state import EnsembleState
from tpu_assim_torch.utils.dataset import Dataset, Variable

logger = logging.getLogger(__name__)

__all__ = [
    "create_vgrid",
    "add_no_vgrid",
    "replace_grid",
    "ds_to_state",
    "state_to_ds",
    "generic_postprocess",
]


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def create_vgrid(ds: Dataset, vcoords: Iterable[str]) -> Dataset:
    """Merge all available vertical coordinates into one ``vgrid`` coordinate
    (reference: terrsysmp/common.py:40-50)."""
    ds = ds.copy()
    avail = [c for c in vcoords if c in ds.dims]
    ds.coords["vgrid"] = np.concatenate(
        [np.asarray(ds.coords[c], dtype=np.float64) for c in avail]
    )
    return ds


def add_no_vgrid(ds: Dataset, vcoords: Iterable[str], val: float = 0.0
                 ) -> Dataset:
    """Give variables without any vertical dim a length-1 ``no_vgrid`` dim at
    position -3 (reference: terrsysmp/common.py:53-68)."""
    ds = ds.copy()
    vcoords = tuple(vcoords)
    added = False
    for name, var in list(ds.data_vars.items()):
        if set(var.dims).isdisjoint(vcoords):
            ds[name] = var.expand_dims("no_vgrid", axis=max(var.values.ndim - 2, 0))
            added = True
    if added:
        ds.coords["no_vgrid"] = np.array([val], dtype=np.float64)
    return ds


def replace_grid(ds: Dataset, remap: Dict[str, str]) -> Dataset:
    """Rename grid dims, dropping their old coordinate labels
    (reference: terrsysmp/common.py:71-83)."""
    present = {k: v for k, v in remap.items()
               if k in ds.coords or k in ds.dims}
    return ds.rename_dims(present)


def _canonical_var(var: Variable, grid_dims: Sequence[str],
                   n_time: int, n_ens: int) -> np.ndarray:
    """Bring one variable to dense [time, ensemble, *grid_dims] layout,
    broadcasting missing time/ensemble dims (xarray's to_array alignment,
    terrsysmp/common.py:86-98)."""
    v = var
    if "time" not in v.dims:
        v = v.expand_dims("time", axis=0)
    if "ensemble" not in v.dims:
        v = v.expand_dims("ensemble", axis=1)
    order = ["time", "ensemble"] + [d for d in grid_dims if d in v.dims]
    v = v.transpose(tuple(order))
    vals = v.values
    # broadcast length-1 time/ens; missing grid dims are not supported
    for d in grid_dims:
        if d not in v.dims:
            raise ValueError(
                "variable missing grid dim {0}; reindex it first".format(d)
            )
    target = (n_time, n_ens) + vals.shape[2:]
    return np.broadcast_to(vals, target)


def ds_to_state(ds: Dataset, grid_dims: Sequence[str],
                device=None) -> EnsembleState:
    """Stack a prepared dataset into a valid :class:`EnsembleState`
    (reference builds an xarray state array: terrsysmp/common.py:86-98),
    on ``device`` (default the card; ``device="cpu"`` without one).

    Every variable must carry all ``grid_dims`` (after vertical reindexing);
    the grid dims are flattened C-order into the state's ``grid`` axis and
    their coordinates become the ``[grid, len(grid_dims)]`` coordinate matrix.
    """
    grid_dims = tuple(grid_dims)
    dims = ds.dims
    n_time = dims.get("time", 1)
    n_ens = dims.get("ensemble", 1)
    names = list(ds.data_vars)
    blocks = [
        _canonical_var(ds[n], grid_dims, n_time, n_ens) for n in names
    ]
    grid_shape = blocks[0].shape[2:]
    for n, b in zip(names, blocks):
        if b.shape[2:] != grid_shape:
            raise ValueError(
                "variable {0} grid shape {1} != {2}".format(
                    n, b.shape[2:], grid_shape
                )
            )
    data = np.stack(
        [b.reshape(n_time, n_ens, -1) for b in blocks], axis=0
    )  # [var, time, ens, grid]
    # coordinate matrix: meshgrid of the grid dims, C-order flattened
    axes = [
        np.asarray(
            ds.coords.get(d, np.arange(n)), dtype=np.float64
        )
        for d, n in zip(grid_dims, grid_shape)
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    grid_coords = np.stack([m.reshape(-1) for m in mesh], axis=1)
    times = np.asarray(
        ds.coords.get("time", np.arange(n_time)), dtype=np.float64
    )
    state = EnsembleState(
        data, times=times, grid_coords=grid_coords, var_names=tuple(names),
        device=device,
    )
    # stash the unstack recipe for state_to_ds
    state.grid_dims = grid_dims
    state.grid_shape = grid_shape
    return state


def state_to_ds(state: EnsembleState, grid_dims: Sequence[str],
                grid_shape: Sequence[int],
                coords: Dict[str, np.ndarray]) -> Dataset:
    """Unstack a state back into a dataset
    (reference: terrsysmp/common.py:101-112)."""
    grid_dims = tuple(grid_dims)
    grid_shape = tuple(grid_shape)
    data = _host(state.data)
    n_var, n_time, n_ens, _ = data.shape
    out = {}
    for i, name in enumerate(state.var_names):
        vals = data[i].reshape((n_time, n_ens) + grid_shape)
        out[str(name)] = Variable(("time", "ensemble") + grid_dims, vals)
    ds_coords = {k: np.asarray(v) for k, v in coords.items()}
    ds_coords["time"] = _host(state.times)
    return Dataset(out, ds_coords)


def generic_postprocess(
    analysis: EnsembleState,
    origin_ds: Dataset,
    vcoords: Iterable[str],
    grid_dims: Sequence[str],
    grid_shape: Sequence[int],
    vgrid: np.ndarray,
) -> Dataset:
    """Write analysed variables back into a copy of the original model
    dataset (reference: terrsysmp/common.py:123-184).

    Per variable: unstack the analysis grid, drop vgrid levels that are NaN
    everywhere (the reindex padding), and pour the remaining values into the
    original variable's layout.
    """
    analysis_ds = state_to_ds(
        analysis, grid_dims, grid_shape,
        {d: origin_ds.coords.get(d, np.arange(s))
         for d, s in zip(grid_dims, grid_shape)},
    )
    analysis_ds.coords["vgrid"] = np.asarray(vgrid)
    out = origin_ds.copy(deep=True)
    vcoords = tuple(vcoords)
    for name in analysis_ds.data_vars:
        if name not in out.data_vars:
            logger.warning("Var: %s is not found", name)
            continue
        ana = analysis_ds[name]
        # canonical order [time, ensemble, vgrid, *horizontal]
        horiz = [d for d in ana.dims
                 if d not in ("time", "ensemble", "vgrid")]
        ana = ana.transpose(("time", "ensemble", "vgrid") + tuple(horiz))
        vals = ana.values
        # drop vgrid levels that are all-NaN (reference dropna('vgrid',
        # how='all'), common.py:163)
        keep = ~np.isnan(vals).reshape(
            vals.shape[0], vals.shape[1], vals.shape[2], -1
        ).all(axis=(0, 1, 3))
        vals = vals[:, :, keep]
        target = out[name]
        # canonical order of the target: [time?, ensemble?] + vertical + rest
        t_order = [d for d in ("time", "ensemble") if d in target.dims]
        t_order += [d for d in target.dims
                    if d in vcoords or d == "vgrid"]
        t_order += [d for d in target.dims if d not in t_order]
        t_canon = target.transpose(tuple(t_order))
        squeezed = vals
        if "time" not in target.dims:
            squeezed = squeezed[0]
        elif t_canon.shape[0] != squeezed.shape[0]:
            raise ValueError("time length mismatch for {0}".format(name))
        if "ensemble" not in target.dims:
            squeezed = squeezed[0] if "time" not in target.dims else (
                squeezed[:, 0]
            )
        try:
            reshaped = squeezed.reshape(t_canon.shape)
        except ValueError:
            logger.warning(
                "Var: %s is not broadcastable (%s != %s)", name,
                squeezed.shape, t_canon.shape,
            )
            continue
        new_var = Variable(t_canon.dims, reshaped).transpose(target.dims)
        out[name] = new_var
    return out
