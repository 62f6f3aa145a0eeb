"""
Grid-sharded LETKF analysis (PyTorch port of
:mod:`tpu_assim.parallel.letkf`).

The LETKF analysis is embarrassingly parallel over grid columns: each
shard of the mesh's grid axis solves and applies the weights of its own
columns, with the observations replicated to it. The shards run one after
another from Python; on CUDA devices their kernels queue asynchronously.

On a mesh that spans processes (:mod:`tpu_assim_torch.parallel.multihost`)
each process solves the columns of its own positions; the observations are
replicated, so nothing is exchanged. Given whole tensors the functions
return the whole result on every process; given a
:class:`~tpu_assim_torch.parallel.multihost.GlobalTensor` state (or grid
info, for the weights) they return this process's blocks as one.
"""

from functools import partial
from typing import Optional

import torch

from tpu_assim_torch.interface.mixin_local import map_grid_chunked
from tpu_assim_torch.ops.etkf import letkf_weights_dense
from tpu_assim_torch.parallel.mesh import (
    GRID_AXIS,
    Mesh,
    _axis_devices,
    _axis_owners,
)
from tpu_assim_torch.parallel.multihost import (
    GlobalTensor,
    all_blocks,
    process_index,
)

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


def _axes(axis_name):
    """``axis_name`` (a mesh axis, or a tuple of them) as a tuple."""
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def _grid_shards(mesh: Mesh, axis_name, n_grid: int):
    """``(device, column slice)`` of each shard of ``axis_name`` (a mesh
    axis or a tuple of them, flattened row-major; None for a shard of
    another process), and the owner ranks (None on a mesh of one
    process)."""
    axes = _axes(axis_name)
    devices = _axis_devices(mesh, *axes)
    owners = _axis_owners(mesh, *axes)
    if n_grid % len(devices):
        raise ValueError(f"a grid of {n_grid} columns does not split evenly "
                         f"over {len(devices)} shards")
    size = n_grid // len(devices)
    rank = process_index()
    return [(device, slice(i * size, (i + 1) * size))
            if owners is None or owners[i] == rank else None
            for i, device in enumerate(devices)], owners


def _take(x, dim: int, axis_name, index: int, cols, device):
    """Shard ``index``'s columns of ``x``: a GlobalTensor's own block (split
    along ``dim`` over ``axis_name``) or a slice of a whole tensor."""
    if isinstance(x, GlobalTensor):
        if not x.matches((dim,), (_axes(axis_name),)):
            raise ValueError(f"an input split {x.dims} over {x.axes}; the "
                             f"grid dim {dim} splits over {axis_name!r}")
        return x.blocks[(index,)]
    full = [slice(None)] * x.ndim
    full[dim] = cols
    return x[tuple(full)].to(device)


def _result(outs, like, owners, device, dim: int):
    """The shards' results as their input came: a GlobalTensor of this
    process's blocks (like ``like``), or the whole tensor on ``device``."""
    if isinstance(like, GlobalTensor):
        held = next(o for o in outs if o is not None)
        shape = list(held.shape)
        shape[dim] *= len(outs)
        return GlobalTensor(like.mesh, shape, (dim,), like.axes,
                            {(i,): o for i, o in enumerate(outs)
                             if o is not None})
    return torch.cat(all_blocks(outs, owners, device), dim=dim)


def sharded_letkf_weights(
    mesh: Mesh,
    localization,
    ens_obs_perts: torch.Tensor,
    innovations: torch.Tensor,
    grid_info,
    obs_info: torch.Tensor,
    inf_factor,
    chunksize: Optional[int] = None,
    axis_name=GRID_AXIS,
):
    """Per-gridpoint ensemble weights [grid, k, k], the grid split over
    ``axis_name`` of ``mesh`` (a mesh axis, or a tuple of them over which
    the grid splits row-major, as JAX's ``P(("ens", "grid"))``); returned
    on the device of ``ens_obs_perts`` (a GlobalTensor over the grid when
    ``grid_info`` is one). The grid size must divide evenly over the
    axes."""
    solve = partial(_local_solve, localization, chunksize)
    shards, owners = _grid_shards(mesh, axis_name, grid_info.shape[0])
    out = [None if shard is None else solve(
        ens_obs_perts.to(shard[0]), innovations.to(shard[0]),
        _take(grid_info, 0, axis_name, i, shard[1], shard[0]),
        obs_info.to(shard[0]), inf_factor)
        for i, shard in enumerate(shards)]
    return _result(out, grid_info, owners, ens_obs_perts.device, 0)


def sharded_letkf_analysis(
    mesh: Mesh,
    localization,
    state_data,
    ens_obs_perts: torch.Tensor,
    innovations: torch.Tensor,
    grid_info,
    obs_info: torch.Tensor,
    inf_factor,
    chunksize: Optional[int] = None,
    axis_name=GRID_AXIS,
):
    """Weights and their application per grid shard, the grid split over
    ``axis_name`` (a mesh axis or a tuple of them, as
    :func:`sharded_letkf_weights`).

    Parameters
    ----------
    state_data : [var, time, ens, grid] background ensemble (a tensor, or
        a GlobalTensor split along its last dim).
    ens_obs_perts : [ens, obs] normalized obs-space perturbations.
    innovations : [obs] normalized innovations.
    grid_info / obs_info : coordinate rows for the taper (``grid_info``
        whole, or a GlobalTensor split along its first dim).

    Returns the analysis ensemble [var, time, ens, grid] on the device of
    ``state_data``, or this process's blocks as a GlobalTensor.
    """
    solve = partial(_local_solve, localization, chunksize)
    shards, owners = _grid_shards(mesh, axis_name, state_data.shape[-1])
    outs = []
    for i, shard in enumerate(shards):
        if shard is None:
            outs.append(None)
            continue
        device, cols = shard
        weights = solve(ens_obs_perts.to(device), innovations.to(device),
                        _take(grid_info, 0, axis_name, i, cols, device),
                        obs_info.to(device), inf_factor)
        data = _take(state_data, 3, axis_name, i, cols, device)
        mean = torch.mean(data, dim=2, keepdim=True)
        outs.append(mean + torch.einsum("vtkg,gkm->vtmg", data - mean,
                                        weights))
    device = None if isinstance(state_data, GlobalTensor) else \
        state_data.device
    return _result(outs, state_data, owners, device, 3)
