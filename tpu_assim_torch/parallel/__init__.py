"""Sharded analyses over device meshes (PyTorch port of
:mod:`tpu_assim.parallel`): the grid mesh, the grid-sharded LETKF, the
grid-sharded localized IEnKS step and, in
:mod:`tpu_assim_torch.parallel.halo`, the obs-sharded halo LETKF with its
exchange kernel K8 (:mod:`tpu_assim_torch.parallel.cuda_halo`); meshes
that span processes in :mod:`tpu_assim_torch.parallel.multihost`."""

from tpu_assim_torch.parallel.mesh import (
    make_grid_mesh,
    make_forecast_analysis_mesh,
    shard_state,
    replicate,
    GRID_AXIS,
    ENS_AXIS,
)
from tpu_assim_torch.parallel.letkf import (
    sharded_letkf_weights,
    sharded_letkf_analysis,
)
from tpu_assim_torch.parallel.lienks import sharded_lienks_step

__all__ = [
    "make_grid_mesh",
    "make_forecast_analysis_mesh",
    "shard_state",
    "replicate",
    "GRID_AXIS",
    "ENS_AXIS",
    "sharded_letkf_weights",
    "sharded_letkf_analysis",
    "sharded_lienks_step",
]
