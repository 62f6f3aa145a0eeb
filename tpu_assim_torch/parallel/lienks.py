"""
Grid-sharded localized IEnKS step: the counterpart of the JAX package's
:func:`tpu_assim.analysis.make_lienks_step` under a grid-sharded state
(``NamedSharding(mesh, P(None, "grid"))``), which GSPMD partitions.

Each shard of the mesh's grid axis runs the local step's per-column
pieces (:func:`tpu_assim_torch.analysis._lienks_taper`, ``_lienks_pseudo``,
``_lienks_inner``, ``_lienks_apply``) on its own columns. Two things
cross shards in an outer iteration:

- the forecast's ring halo: before each forecast, shard ``s`` receives
  the ``L = 8 n`` columns left of its block and the ``R = 4 n`` right of
  it (modulo the grid) from whichever shards hold them
  (:func:`tpu_assim_torch.parallel.multihost.exchange_blocks`), runs the
  forecast (the fused RK4 kernel K2 wherever
  :func:`~tpu_assim_torch.models.cuda_forecast.supports_fused_rk4` holds)
  on the segment ``[k, L + size + R]`` and keeps its interior. Lorenz-96
  reaches 2 columns left and 1 right an evaluation, 4 evaluations an RK4
  step; the ring wrap of the segment pollutes only the halo, which is
  thrown away, so the interior's arithmetic is that of the whole ring;
- the model equivalents of the replicated observations: each shard
  copies the columns of its own observations into place in a replicated
  [k, o] tensor, assembled across processes with
  :func:`~tpu_assim_torch.parallel.multihost.all_blocks` (a copy, not a
  sum: exact).

Every shard then normalizes the same obs-space tensor and runs its inner
steps, whose SVDs go to the Jacobi kernel K3 under the gate of
:func:`tpu_assim_torch.ops.linalg.svd`: the gate sees the shard's batch,
so a shard of fewer than 256 columns takes ``torch.linalg.svd``.

On a mesh that spans processes (:mod:`tpu_assim_torch.parallel.multihost`)
each process runs its own positions and the two exchanges cross processes.
The shards run one after another from Python; on CUDA devices their
kernels queue asynchronously.
"""

import numbers
from typing import Callable, Optional

import numpy as np
import torch

from tpu_assim_torch.analysis import (
    _check_selection,
    _forecast,
    _lienks_apply,
    _lienks_inner,
    _lienks_pseudo,
    _lienks_taper,
    _normalized_obs_space,
)
from tpu_assim_torch.models.integration import RK4Integrator
from tpu_assim_torch.models.lorenz96 import Lorenz96
from tpu_assim_torch.parallel.letkf import _grid_shards, _result, _take
from tpu_assim_torch.parallel.mesh import GRID_AXIS, Mesh
from tpu_assim_torch.parallel.multihost import (
    GlobalTensor,
    all_blocks,
    exchange_blocks,
    process_index,
)

__all__ = ["obs_equivalents", "ring_forecast", "ring_reach", "segment_plan",
           "sharded_lienks_step"]


def ring_reach(integrator, n_steps: int):
    """``(L, R)``: the columns left and right of a block that ``n_steps``
    of ``integrator`` read, for a stock RK4 over a Lorenz-96 whose forcing
    is one number (8 and 4 a step); None for any other integrator, whose
    reach is not known."""
    if (type(integrator) is not RK4Integrator
            or type(integrator.model) is not Lorenz96):
        return None
    forcing = integrator.model.forcing
    if not (isinstance(forcing, numbers.Real)
            or torch.as_tensor(forcing).numel() == 1):
        return None
    return 8 * n_steps, 4 * n_steps


def segment_plan(n_grid: int, n_shards: int, left: int, right: int):
    """Per shard ``s``: its source shards (sorted) and, for each column of
    its segment (the global columns ``s size - left`` to ``(s + 1) size +
    right``, modulo ``n_grid``), the column's place in the source blocks
    laid side by side in that order. A halo may span several shards and
    wrap the ring, also when ``left + right >= n_grid``."""
    size = n_grid // n_shards
    plans = []
    for s in range(n_shards):
        cols = (s * size - left + np.arange(left + size + right)) % n_grid
        held_by = cols // size
        sources = sorted(set(held_by.tolist()))
        plans.append((sources,
                      np.searchsorted(sources, held_by) * size + cols % size))
    return plans


def ring_forecast(integrator, n_int_steps: int, blocks, owners, n_grid: int,
                  n_shards: int, cache: dict):
    """Each block's forecast on its ring segment: ``n_int_steps`` of
    ``integrator`` (of known reach, :func:`ring_reach`) on the columns of
    its block with ``L`` left and ``R`` right of them, of which it keeps
    the interior.

    ``blocks``: a ``[k, n_grid]`` ensemble split into rows of ``n_shards``
    grid blocks (``[k / E, n_grid / n_shards]``, flat and row-major, the
    rows being member blocks; None for a block of another process);
    ``owners``: their ranks, or None. A block's halo comes from the blocks
    of its own row (:func:`segment_plan`,
    :func:`~tpu_assim_torch.parallel.multihost.exchange_blocks`).
    ``cache`` keeps the segment plans and their indices on device. Returns
    the forecast blocks in the same order (None for another process's)."""
    left, right = ring_reach(integrator, n_int_steps)
    size = n_grid // n_shards
    if (n_grid, n_shards) not in cache:
        cache[n_grid, n_shards] = segment_plan(n_grid, n_shards, left, right)
    plan = cache[n_grid, n_shards]
    received = exchange_blocks(
        blocks, [[i - i % n_shards + src for src in plan[i % n_shards][0]]
                 for i in range(len(blocks))], owners)
    out = [None] * len(blocks)
    for i, parts in enumerate(received):
        if parts is None:
            continue
        s, device = i % n_shards, parts[0].device
        if (n_grid, n_shards, s, device) not in cache:
            cache[n_grid, n_shards, s, device] = torch.as_tensor(
                plan[s][1], device=device)
        segment = torch.cat(parts, dim=1)[:, cache[n_grid, n_shards, s,
                                                   device]]
        out[i] = _forecast(integrator, n_int_steps,
                           segment)[:, left:left + size]
    return out


def obs_equivalents(blocks, n_shards: int, obs_idx, owners, home):
    """The replicated ``[k, o]`` model equivalents ``x[:, obs_idx]`` on
    ``home`` of an ensemble split as in :func:`ring_forecast` (``blocks``,
    ``owners``): each block's members at the observations in its columns,
    copied into place, then each process's part
    (:func:`~tpu_assim_torch.parallel.multihost.all_blocks`), taken for
    each ``[k, o]`` entry from the process that holds it. Copies, not
    sums: exact. ``obs_idx`` lies on ``home``."""
    template = next(b for b in blocks if b is not None)
    rows, size = template.shape
    n_rows = len(blocks) // n_shards
    held_by = obs_idx // size                     # grid block of each obs
    local = obs_idx - held_by * size
    part = torch.zeros((n_rows * rows, obs_idx.shape[0]),
                       dtype=template.dtype, device=home)
    for i, block in enumerate(blocks):
        if block is None:
            continue
        e, s = divmod(i, n_shards)
        cand = block[:, local.to(block.device)].to(home)
        mine = slice(e * rows, (e + 1) * rows)
        part[mine] = torch.where(held_by == s, cand, part[mine])
    if owners is None or len(set(owners)) == 1:
        return part
    ranks = sorted(set(owners))
    parts = all_blocks([part if r == process_index() else None
                        for r in ranks], ranks, home)
    owner = torch.as_tensor(np.asarray(owners).reshape(n_rows, n_shards),
                            device=home)
    owner = owner.repeat_interleave(rows, dim=0)[:, held_by]       # [k, o]
    ens_obs = parts[0]
    for r, other in zip(ranks[1:], parts[1:]):
        ens_obs = torch.where(owner == r, other, ens_obs)
    return ens_obs


def sharded_lienks_step(
    mesh: Mesh,
    localization,
    integrator,
    n_int_steps: int,
    n_outer: int = 3,
    kind: str = "transform",
    tau: float = 1.0,
    epsilon: float = 1e-4,
    max_obs: Optional[int] = None,
    selection: str = "window",
    max_obs_strict: bool = True,
    obs_operator: Optional[Callable] = None,
    axis_name=GRID_AXIS,
):
    """Build the localized IEnKS step of
    :func:`tpu_assim_torch.analysis.make_lienks_step` (its parameters, in
    its order) with the grid split over ``axis_name`` of ``mesh`` (a mesh
    axis, or a tuple of them flattened row-major).

    The forecast takes the ring-halo route for a stock
    ``RK4Integrator(Lorenz96(F))`` (:func:`ring_reach`). Any other
    integrator, whose reach is not known, and a custom ``obs_operator``
    take the whole pseudo-ensemble, assembled on every process each outer
    iteration: the slow route, kept so that no parameter of
    ``make_lienks_step`` is dropped.

    The inner steps' SVDs go to K3 for an f32 shard of at least 256
    columns on the card; a smaller shard takes ``torch.linalg.svd``, the
    gate's documented route.

    Returns
    -------
    step(state_data [k, g], obs_vals [o], obs_var [o], obs_idx [o],
         grid_coords [g, d], obs_coords [o, d]) -> analysis [k, g].
    ``state_data`` is whole or a GlobalTensor split along dim 1 over
    ``axis_name``, ``grid_coords`` whole or one split along dim 0; the
    observations are replicated. Whole inputs give the whole analysis on
    every process (on the device of ``state_data``), a GlobalTensor
    ``state_data`` this process's blocks. A grid that does not split
    evenly over the axis raises ``ValueError`` before any exchange.
    """
    if kind not in ("transform", "bundle"):
        raise ValueError(f"kind must be 'transform' or 'bundle', got {kind!r}")
    _check_selection(selection)
    integrate = integrator is not None and n_int_steps != 0
    reach = ring_reach(integrator, n_int_steps) if integrate else None
    cache = {}              # ring_forecast's segment plans

    def step(state_data, obs_vals, obs_var, obs_idx, grid_coords,
             obs_coords):
        k, n_grid = state_data.shape
        shards, owners = _grid_shards(mesh, axis_name, n_grid)
        mine = [s for s, shard in enumerate(shards) if shard is not None]
        home = shards[mine[0]][0]
        size = n_grid // len(shards)
        obs_vals, obs_var, obs_idx = (
            x.to(home) for x in (obs_vals, obs_var, obs_idx))
        mean, perts, eye, weights, taper = ({} for _ in range(5))
        for s in mine:
            device, cols = shards[s]
            # contiguous, as host_local_to_global makes a block: a
            # shard reduces in one order from whole inputs or blocks
            data = _take(state_data, 1, axis_name, s, cols,
                         device).contiguous()
            mean[s] = torch.mean(data, dim=0)
            perts[s] = data - mean[s][None, :]
            taper[s] = _lienks_taper(
                localization, max_obs, selection, max_obs_strict,
                _take(grid_coords, 0, axis_name, s, cols, device),
                obs_coords.to(device), data.dtype, device)
            eye[s] = torch.eye(k, dtype=data.dtype, device=device)
            weights[s] = eye[s].expand(size, k, k)

        def whole(pseudos):
            return torch.cat(all_blocks(pseudos, owners, home), dim=1)

        for _ in range(n_outer):
            pseudos = [None] * len(shards)
            for s in mine:
                pseudos[s] = _lienks_pseudo(mean[s], perts[s], weights[s],
                                            kind, epsilon, eye[s])
            if integrate and reach is not None:
                pseudos = ring_forecast(integrator, n_int_steps, pseudos,
                                        owners, n_grid, len(shards), cache)
            elif integrate:
                ring = _forecast(integrator, n_int_steps, whole(pseudos))
                pseudos = [None if shard is None else
                           ring[:, shard[1]].to(shard[0])
                           for shard in shards]
            if obs_operator is None:
                ens_obs = obs_equivalents(pseudos, len(shards), obs_idx,
                                          owners, home)
            else:
                ens_obs = obs_operator(whole(pseudos))
            perts_o, innov = _normalized_obs_space(ens_obs, obs_vals,
                                                   obs_var)
            for s in mine:
                device = shards[s][0]
                idx, sqrt_w, _ = taper[s]
                weights[s] = _lienks_inner(
                    weights[s], perts_o.to(device), innov.to(device), idx,
                    sqrt_w, kind, tau, epsilon)
        outs = [None] * len(shards)
        for s in mine:
            outs[s] = _lienks_apply(mean[s], perts[s], weights[s],
                                    taper[s][2])
        device = (None if isinstance(state_data, GlobalTensor)
                  else state_data.device)
        return _result(outs, state_data, owners, device, 1)

    return step
