"""
COSMO NWP-model adapter (PyTorch port of
:mod:`tpu_assim.models.terrsysmp.cosmo`): select the
variables to assimilate, place every vertical coordinate onto one merged
``vgrid`` (nearest / top / bottom alignment per coordinate kind), stack the
(rlat, rlon, vgrid) grid, and write the analysis back into a COSMO dataset.
"""

import logging
from typing import Iterable

import numpy as np

from tpu_assim_torch.state import EnsembleState
from tpu_assim_torch.utils.dataset import Dataset
from tpu_assim_torch.models.terrsysmp import common

logger = logging.getLogger(__name__)

__all__ = ["preprocess_cosmo", "postprocess_cosmo", "COSMO_VCOORDS"]

# vertical coordinate kinds known to COSMO output
# (reference: terrsysmp/cosmo.py:44-45)
COSMO_VCOORDS = (
    "height_2m", "height_10m", "height_toa", "soil1", "level1", "level",
    "no_vgrid",
)


def preprocess_cosmo(
    cosmo_ds: Dataset, assim_vars: Iterable[str], device=None
) -> EnsembleState:
    """COSMO dataset -> assimilation state
    (reference: terrsysmp/cosmo.py:48-95), on ``device`` (default the
    card; ``device="cpu"`` without one).

    The dataset must contain a ``vcoord`` variable holding the model's
    vertical level heights (as COSMO output does); `soil1` depths are negated
    so the merged vgrid is monotone in height.
    """
    avail = [v for v in assim_vars if v in cosmo_ds.data_vars]
    missing = sorted(set(assim_vars) - set(avail))
    if missing:
        logger.warning("Following variables are not found! %s",
                       ", ".join(missing))
    assim_ds = cosmo_ds.select(avail)
    vgrid_ds = _prepare_vgrid(assim_ds, cosmo_ds["vcoord"].values)
    added_ds = common.add_no_vgrid(vgrid_ds, COSMO_VCOORDS, 0.0)
    interp_ds = _interp_vgrid(added_ds)
    prepared_ds = _replace_coords(interp_ds)
    state = common.ds_to_state(prepared_ds, ("rlat", "rlon", "vgrid"),
                               device=device)
    state.vgrid = np.asarray(interp_ds.coords["vgrid"])
    return state


def postprocess_cosmo(analysis: EnsembleState, cosmo_ds: Dataset) -> Dataset:
    """Analysis state -> COSMO dataset with assimilated variables replaced
    (reference: terrsysmp/cosmo.py:98-133).

    The unstack recipe (grid dims/shape, merged vgrid) is recomputed from the
    origin dataset, so any analysis produced from :func:`preprocess_cosmo`
    output round-trips without side-channel state."""
    ds = _prepare_vgrid(
        cosmo_ds.select(
            [str(v) for v in analysis.var_names if str(v) in cosmo_ds]
        ),
        cosmo_ds["vcoord"].values,
    )
    vgrid = np.asarray(ds.coords["vgrid"])
    dims = cosmo_ds.dims
    grid_shape = (dims["rlat"], dims["rlon"], len(vgrid))
    out = common.generic_postprocess(
        analysis, cosmo_ds, COSMO_VCOORDS,
        grid_dims=("rlat", "rlon", "vgrid"),
        grid_shape=grid_shape,
        vgrid=vgrid,
    )
    logger.info("Finished post-processing of COSMO")
    return out


def _prepare_vgrid(ds: Dataset, vcoord: np.ndarray) -> Dataset:
    """Attach the merged vertical grid (reference: terrsysmp/cosmo.py:136-151):
    vgrid = mean vcoord profile (+ negated soil depths); full levels
    ``level1`` take the profile, half levels ``level`` its midpoints."""
    ds = ds.copy()
    vcoord = np.asarray(vcoord, dtype=np.float64)
    if vcoord.ndim > 1:
        # average out non-vertical dims (reference takes .mean over them)
        vcoord = vcoord.reshape(-1, vcoord.shape[-1]).mean(axis=0)
    if "soil1" in ds.coords:
        ds.coords["soil1"] = -np.asarray(ds.coords["soil1"],
                                         dtype=np.float64)
        ds.coords["vgrid"] = np.concatenate([vcoord, ds.coords["soil1"]])
    else:
        ds.coords["vgrid"] = vcoord
    if "level1" in ds.dims:
        ds.coords["level1"] = vcoord
    if "level" in ds.dims:
        ds.coords["level"] = ((vcoord + np.roll(vcoord, 1)) / 2.0)[1:]
    return ds


def _inds_nearest(coord_val: np.ndarray, vgrid_val: np.ndarray) -> np.ndarray:
    dist = np.abs(coord_val[:, None] - vgrid_val[None, :])
    return np.argmin(dist, axis=1)


def _inds_top(coord_val: np.ndarray, vgrid_val: np.ndarray) -> np.ndarray:
    return np.arange(len(vgrid_val))[: len(coord_val)]


def _inds_bottom(coord_val: np.ndarray, vgrid_val: np.ndarray) -> np.ndarray:
    return np.arange(len(vgrid_val))[-len(coord_val):]


_VGRID_NEIGHBOR_FUNCS = {
    "no_vgrid": _inds_nearest,
    "height_2m": _inds_nearest,
    "height_10m": _inds_nearest,
    "height_toa": _inds_nearest,
    "soil1": _inds_bottom,
    "level1": _inds_top,
    "level": _inds_top,
}


def _interp_vgrid(ds: Dataset) -> Dataset:
    """Snap each vertical coordinate onto vgrid values, then reindex onto the
    full vgrid (NaN padding) — reference: terrsysmp/cosmo.py:154-168."""
    vgrid = np.asarray(ds.coords["vgrid"])
    for c in COSMO_VCOORDS:
        if c not in ds.dims:
            continue
        coord_vals = np.asarray(ds.coords.get(
            c, np.arange(ds.dims[c], dtype=np.float64)
        ), dtype=np.float64)
        inds = _VGRID_NEIGHBOR_FUNCS[c](coord_vals, vgrid)
        ds.coords[c] = vgrid[inds]
        ds = ds.reindex(c, vgrid)
    return ds


def _replace_coords(ds: Dataset) -> Dataset:
    """Unify all vertical dims to ``vgrid`` and staggered horizontal dims to
    the mass grid (reference: terrsysmp/cosmo.py:186-191)."""
    ds = common.replace_grid(ds, {c: "vgrid" for c in COSMO_VCOORDS})
    ds.coords.setdefault("vgrid", ds.coords["vgrid"])
    ds = common.replace_grid(ds, {"srlat": "rlat", "srlon": "rlon"})
    return ds
