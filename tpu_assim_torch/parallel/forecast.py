"""
The forecast and the cycle step sharded over members x grid: the
counterpart of the JAX package's dryrun ``full_step``
(``__graft_entry__.py``), in which GSPMD partitions a Lorenz-96 forecast
constrained to ``P(None, None, "ens", "grid")`` and the analysis runs
:func:`tpu_assim.parallel.letkf.sharded_letkf_analysis` with the grid over
both mesh axes.

Here the sharding is by hand, as in the rest of the parallel layer. A
``[k, g]`` ensemble has two layouts on a mesh ``(ens, grid)`` of ``E x S``
positions:

- the forecast layout: position ``(e, s)`` holds members block ``e`` and
  grid block ``s``, ``[k / E, g / S]`` (without an ``ens`` axis, every
  member: ``E = 1``);
- the analysis layout: the grid split over every axis of the mesh,
  flattened row-major, every member, ``[k, g / (E S)]``.

A step runs, in order:

1. the forecast (:func:`~tpu_assim_torch.parallel.lienks.ring_forecast`):
   each position receives its ring halo from the positions of its own ens
   row, ``L = 8 n`` columns left and ``R = 4 n`` right (modulo the grid;
   a halo may span several shards and wrap), runs the forecast on its
   segment ``[k / E, L + g / S + R]`` (the fused RK4 kernel K2 wherever it
   applies) and keeps the interior. An integrator whose reach is not
   known (:func:`~tpu_assim_torch.parallel.lienks.ring_reach`) integrates
   the whole ensemble, assembled on every process;
2. the model equivalents ``forecast[:, obs_idx]`` as one replicated
   ``[k, o]`` tensor (:func:`~tpu_assim_torch.parallel.lienks.
   obs_equivalents`): each position copies its members' entries of the
   observations in its columns into place, then each process's part is
   assembled. Copies, not sums: exact;
3. the re-split of the forecast into the analysis layout
   (:func:`~tpu_assim_torch.parallel.multihost.resplit`), an all-to-all
   of copies: each analysis shard receives the forecast blocks that hold
   its columns;
4. :func:`~tpu_assim_torch.parallel.letkf.sharded_letkf_analysis` over
   every axis of the mesh; each shard's eigh goes to the Jacobi kernel K3
   when the shard holds at least 256 f32 columns on the card
   (:func:`tpu_assim_torch.ops.linalg.eigh_psd`), else to LAPACK.

On a mesh that spans processes (``owners``) each process runs its own
positions, and the ring halo, the model equivalents and the re-split
cross processes (:mod:`tpu_assim_torch.parallel.multihost`). The shards
run one after another from Python; on CUDA devices their kernels queue
asynchronously.
"""

from typing import Optional

from tpu_assim_torch.analysis import (
    _forecast,
    _normalized_obs_space,
    _with_time,
)
from tpu_assim_torch.parallel.letkf import sharded_letkf_analysis
from tpu_assim_torch.parallel.lienks import (
    obs_equivalents,
    ring_forecast,
    ring_reach,
)
from tpu_assim_torch.parallel.mesh import ENS_AXIS, GRID_AXIS, Mesh
from tpu_assim_torch.parallel.multihost import (
    GlobalTensor,
    process_index,
    resplit,
)

__all__ = ["sharded_forecast", "sharded_cycle_step"]


def _forecast_layout(mesh: Mesh, shape):
    """An empty GlobalTensor of ``shape`` ``[k, g]`` in the forecast
    layout: members over the ``ens`` axis (when the mesh has it), columns
    over the ``grid`` axis. Raises ``ValueError`` on an uneven split."""
    ens = (ENS_AXIS,) if ENS_AXIS in mesh.shape else ()
    return GlobalTensor(mesh, shape, (0, 1), (ens, (GRID_AXIS,)), {})


def _split(state_data, layout: GlobalTensor) -> GlobalTensor:
    """A whole tensor's blocks of this process in ``layout``, or a
    GlobalTensor re-split into it."""
    if isinstance(state_data, GlobalTensor):
        return resplit(state_data, layout)
    rank = process_index()
    return GlobalTensor(layout.mesh, layout.shape, layout.dims, layout.axes, {
        key: state_data[layout.slices(key)].to(
            layout.device(key)).contiguous()
        for key in layout.keys() if layout.owner(key) == rank})


def _blocks_forecast(integrator, n_int_steps: int):
    """The forecast of a GlobalTensor in the forecast layout (the same
    layout out), by ring halos for a known reach, else on the whole
    ensemble."""
    reach = ring_reach(integrator, n_int_steps)
    cache = {}                  # ring_forecast's segment plans

    def forecast(fc: GlobalTensor) -> GlobalTensor:
        if reach is None:
            whole = _forecast(integrator, n_int_steps, fc.gather())
            return _split(whole, fc)
        keys = fc.keys()
        out = ring_forecast(integrator, n_int_steps,
                            [fc.blocks.get(key) for key in keys],
                            [fc.owner(key) for key in keys], fc.shape[1],
                            fc.splits[1], cache)
        return GlobalTensor(fc.mesh, fc.shape, fc.dims, fc.axes, {
            key: block for key, block in zip(keys, out) if block is not None})

    return forecast


def _whole_or_blocks(out: GlobalTensor, state_data):
    """The result as the input came: the whole tensor on the input's
    device (a collective), or this process's blocks."""
    if isinstance(state_data, GlobalTensor):
        return out
    return out.gather(state_data.device)


def sharded_forecast(mesh: Mesh, integrator, n_int_steps: int):
    """Build the forecast of a ``[k, g]`` ensemble sharded over members
    (the ``ens`` axis, when the mesh has it) and grid columns (the
    ``grid`` axis): ``n_int_steps`` of ``integrator`` on every position's
    ring segment.

    Returns forecast(state_data) -> forecast ``[k, g]``: the whole tensor on
    the device of ``state_data`` on every process when it is whole, this
    process's blocks in the forecast layout when it is a GlobalTensor (of
    any split, re-split first). Members and columns that do not split
    evenly raise ``ValueError`` before any exchange."""
    step = _blocks_forecast(integrator, n_int_steps)
    integrate = integrator is not None and n_int_steps != 0

    def forecast(state_data):
        fc = _split(state_data, _forecast_layout(mesh, state_data.shape))
        return _whole_or_blocks(step(fc) if integrate else fc, state_data)

    return forecast


def sharded_cycle_step(
    mesh: Mesh,
    integrator,
    n_int_steps: int,
    localization,
    inf_factor=1.0,
    chunksize: Optional[int] = None,
):
    """Build the cycle step of :func:`tpu_assim_torch.analysis.
    make_cycle_step` (the forecast, then the dense localized LETKF
    analysis) with the forecast sharded over members x grid and the
    analysis over every axis of the mesh, flattened row-major, as the JAX
    package's dryrun ``full_step`` runs it.

    Returns
    -------
    step(state_data [k, g], obs_vals [o], obs_var [o], obs_idx [o],
         grid_coords [g, d], obs_coords [o, d]) -> analysis [k, g].

    ``state_data`` is whole, or a GlobalTensor of any split of its two
    dims (re-split into the forecast layout first; the result of a step
    goes into the next); ``grid_coords`` whole, or a GlobalTensor split
    along dim 0 over every axis of the mesh; the observations are
    replicated. Whole inputs give the whole analysis on every process (on
    the device of ``state_data``), a GlobalTensor ``state_data`` this
    process's blocks in the analysis layout (``[k, g]`` split along dim 1
    over every axis of the mesh). Members or columns that do not split
    evenly over the forecast or the analysis raise ``ValueError`` before
    any exchange.
    """
    axes = mesh.axis_names
    forecast = _blocks_forecast(integrator, n_int_steps)
    integrate = integrator is not None and n_int_steps != 0

    def step(state_data, obs_vals, obs_var, obs_idx, grid_coords,
             obs_coords):
        shape = tuple(state_data.shape)
        layout = _forecast_layout(mesh, shape)
        analysis = GlobalTensor(mesh, shape, (1,), (axes,), {})
        fc = _split(state_data, layout)
        if integrate:
            fc = forecast(fc)
        home = fc.blocks[min(fc.blocks)].device
        keys = fc.keys()
        ens_obs = obs_equivalents([fc.blocks.get(key) for key in keys],
                                  fc.splits[1], obs_idx.to(home),
                                  [fc.owner(key) for key in keys], home)
        perts, innov = _normalized_obs_space(ens_obs, obs_vals.to(home),
                                             obs_var.to(home))
        split = resplit(fc, analysis)
        data = GlobalTensor(mesh, (1, 1) + shape, (3,), (axes,), {
            key: block[None, None] for key, block in split.blocks.items()})
        if isinstance(grid_coords, GlobalTensor):
            grid_info = GlobalTensor(
                mesh, (grid_coords.shape[0], grid_coords.shape[1] + 1),
                grid_coords.dims, grid_coords.axes,
                {key: _with_time(block)
                 for key, block in grid_coords.blocks.items()})
        else:
            grid_info = _with_time(grid_coords)
        out = sharded_letkf_analysis(
            mesh, localization, data, perts, innov, grid_info,
            _with_time(obs_coords.to(home)), inf_factor, chunksize, axes)
        out = GlobalTensor(mesh, shape, (1,), (axes,), {
            key: block[0, 0] for key, block in out.blocks.items()})
        return _whole_or_blocks(out, state_data)

    return step
