"""
CLM land-model adapter (PyTorch port of
:mod:`tpu_assim.models.terrsysmp.clm`): merge the soil /
snow / lake vertical levels into one ``vgrid``, reindex every vertical dim
onto it, stack to a state, and write the analysis back.
"""

import logging
from typing import Iterable

import numpy as np

from tpu_assim_torch.state import EnsembleState
from tpu_assim_torch.utils.dataset import Dataset
from tpu_assim_torch.models.terrsysmp import common

logger = logging.getLogger(__name__)

__all__ = ["preprocess_clm", "postprocess_clm", "CLM_VCOORDS"]

# (reference: terrsysmp/clm.py:41)
CLM_VCOORDS = ("levsoi", "levtot", "levsno", "levlak", "no_vgrid")


def preprocess_clm(ds_clm: Dataset, assim_vars: Iterable[str],
                   device=None) -> EnsembleState:
    """CLM dataset -> assimilation state (reference: terrsysmp/clm.py:44-70),
    on ``device`` (default the card; ``device="cpu"`` without one)."""
    sliced = ds_clm.select(assim_vars)
    gridded = common.create_vgrid(sliced, CLM_VCOORDS)
    vgrid = np.asarray(gridded.coords["vgrid"])
    # surface variables land on the lowest merged level
    # (reference passes vgrid.min() as the no_vgrid value, clm.py:57-59)
    added = common.add_no_vgrid(gridded, CLM_VCOORDS, float(vgrid.min()))
    interp = _interp_vgrid(added)
    prepared = common.replace_grid(
        interp, {c: "vgrid" for c in CLM_VCOORDS}
    )
    grid_dims = _grid_dims(prepared)
    state = common.ds_to_state(prepared, grid_dims, device=device)
    state.vgrid = np.asarray(interp.coords["vgrid"])
    return state


def postprocess_clm(analysis: EnsembleState, ds_clm: Dataset) -> Dataset:
    """Analysis state -> CLM dataset (reference: terrsysmp/clm.py:73-108)."""
    sliced = ds_clm.select(
        [str(v) for v in analysis.var_names if str(v) in ds_clm]
    )
    gridded = common.create_vgrid(sliced, CLM_VCOORDS)
    vgrid = np.asarray(gridded.coords["vgrid"])
    dims = ds_clm.dims
    if "column" in dims and "lat" not in dims:
        grid_dims = ("column", "vgrid")
        grid_shape = (dims["column"], len(vgrid))
    else:
        grid_dims = ("lat", "lon", "vgrid")
        grid_shape = (dims["lat"], dims["lon"], len(vgrid))
    out = common.generic_postprocess(
        analysis, ds_clm, CLM_VCOORDS,
        grid_dims=grid_dims, grid_shape=grid_shape, vgrid=vgrid,
    )
    logger.info("Finished post-processing of CLM")
    return out


def _grid_dims(ds: Dataset):
    """CLM output is either column-wise or lat/lon gridded
    (reference: terrsysmp/clm.py:64-68)."""
    dims = ds.dims
    if "column" in dims and "lat" not in dims:
        return ("column", "vgrid")
    return ("lat", "lon", "vgrid")


def _interp_vgrid(ds: Dataset) -> Dataset:
    """Reindex every vertical dim onto the merged vgrid by exact coordinate
    match (reference: terrsysmp/clm.py:111-122 — CLM levels are already
    subsets of vgrid, no snapping needed)."""
    vgrid = np.asarray(ds.coords["vgrid"])
    for c in CLM_VCOORDS:
        if c in ds.dims:
            ds = ds.reindex(c, vgrid)
    return ds
