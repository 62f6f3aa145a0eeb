"""TerrSysMP (COSMO + CLM) real-model adapters (PyTorch port of
:mod:`tpu_assim.models.terrsysmp`): host-side pre/post-processing between
model output datasets and :class:`~tpu_assim_torch.state.EnsembleState`."""

from tpu_assim_torch.models.terrsysmp.common import (
    create_vgrid,
    add_no_vgrid,
    replace_grid,
    ds_to_state,
    state_to_ds,
    generic_postprocess,
)
from tpu_assim_torch.models.terrsysmp.cosmo import preprocess_cosmo, postprocess_cosmo
from tpu_assim_torch.models.terrsysmp.clm import preprocess_clm, postprocess_clm

__all__ = [
    "create_vgrid",
    "add_no_vgrid",
    "replace_grid",
    "ds_to_state",
    "state_to_ds",
    "generic_postprocess",
    "preprocess_cosmo",
    "postprocess_cosmo",
    "preprocess_clm",
    "postprocess_clm",
]
