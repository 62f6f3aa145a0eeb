"""
Grid-sharded LETKF analysis (PyTorch port of
:mod:`tpu_assim.parallel.letkf`).

The LETKF analysis is embarrassingly parallel over grid columns: each
shard of the mesh's grid axis solves and applies the weights of its own
columns, with the observations replicated to it. The shards run one after
another from Python; on CUDA devices their kernels queue asynchronously.
"""

from functools import partial
from typing import Optional

import torch

from tpu_assim_torch.interface.mixin_local import map_grid_chunked
from tpu_assim_torch.ops.etkf import letkf_weights_dense
from tpu_assim_torch.parallel.mesh import GRID_AXIS, Mesh, _axis_devices

__all__ = ["sharded_letkf_weights", "sharded_letkf_analysis"]


def _local_solve(localization, chunksize, perts, innov, grid_info, obs_info,
                 inf_factor):
    """Per-shard localized solve (the math of
    ``interface/letkf.py:_letkf_solve``)."""

    def chunk_fn(grid_chunk):
        if localization is None:
            w_loc = torch.ones(grid_chunk.shape[0], obs_info.shape[0],
                               dtype=perts.dtype, device=perts.device)
        else:
            w_loc = localization.taper_weights(grid_chunk, obs_info).to(
                perts.dtype)
        return letkf_weights_dense(perts, innov, w_loc, inf_factor)

    return map_grid_chunked(chunk_fn, grid_info, chunksize)


def _grid_shards(mesh: Mesh, axis_name: str, n_grid: int):
    """``(device, column slice)`` of each shard of ``axis_name``."""
    devices = _axis_devices(mesh, axis_name)
    if n_grid % len(devices):
        raise ValueError(f"a grid of {n_grid} columns does not split evenly "
                         f"over {len(devices)} shards")
    size = n_grid // len(devices)
    return [(device, slice(i * size, (i + 1) * size))
            for i, device in enumerate(devices)]


def sharded_letkf_weights(
    mesh: Mesh,
    localization,
    ens_obs_perts: torch.Tensor,
    innovations: torch.Tensor,
    grid_info: torch.Tensor,
    obs_info: torch.Tensor,
    inf_factor,
    chunksize: Optional[int] = None,
    axis_name: str = GRID_AXIS,
) -> torch.Tensor:
    """Per-gridpoint ensemble weights [grid, k, k], the grid split over
    ``axis_name`` of ``mesh``; returned on the device of
    ``ens_obs_perts``. The grid size must divide evenly over the axis."""
    solve = partial(_local_solve, localization, chunksize)
    out = [solve(ens_obs_perts.to(device), innovations.to(device),
                 grid_info[cols].to(device), obs_info.to(device), inf_factor)
           for device, cols in _grid_shards(mesh, axis_name,
                                            grid_info.shape[0])]
    return torch.cat([w.to(ens_obs_perts.device) for w in out])


def sharded_letkf_analysis(
    mesh: Mesh,
    localization,
    state_data: torch.Tensor,
    ens_obs_perts: torch.Tensor,
    innovations: torch.Tensor,
    grid_info: torch.Tensor,
    obs_info: torch.Tensor,
    inf_factor,
    chunksize: Optional[int] = None,
    axis_name: str = GRID_AXIS,
) -> torch.Tensor:
    """Weights and their application per grid shard.

    Parameters
    ----------
    state_data : [var, time, ens, grid] background ensemble.
    ens_obs_perts : [ens, obs] normalized obs-space perturbations.
    innovations : [obs] normalized innovations.
    grid_info / obs_info : coordinate rows for the taper.

    Returns the analysis ensemble [var, time, ens, grid] on the device of
    ``state_data``.
    """
    solve = partial(_local_solve, localization, chunksize)
    outs = []
    for device, cols in _grid_shards(mesh, axis_name, state_data.shape[-1]):
        weights = solve(ens_obs_perts.to(device), innovations.to(device),
                        grid_info[cols].to(device), obs_info.to(device),
                        inf_factor)
        data = state_data[..., cols].to(device)
        mean = torch.mean(data, dim=2, keepdim=True)
        outs.append(mean + torch.einsum("vtkg,gkm->vtmg", data - mean,
                                        weights))
    return torch.cat([o.to(state_data.device) for o in outs], dim=-1)
