"""
Obs-sharded LETKF with halo exchange (PyTorch port of
:mod:`tpu_assim.parallel.halo`).

Domain localization bounds the observation support of every analysis
column to twice the Gaspari-Cohn radius, so a grid shard needs only the
observations of its own region and of a bounded halo of neighbouring
shards:

1. **Bucketing on the host** (:func:`shard_observations`): each observation
   goes to the shard that owns its grid column, padded to a common count
   per shard; padded slots carry ``valid = 0``.
2. **Local obs space**: each shard takes its ensemble's obs equivalents
   from its own grid block and normalizes them by R^{-1/2}.
3. **Halo exchange**: each shard's packed block ``[k perts | innovation |
   validity | coords]`` goes to its ``halo_width`` neighbours on each side:
   by copies (``comm="ppermute"``, the JAX name) or by kernel K8
   (``comm="rdma"``, :mod:`tpu_assim_torch.parallel.cuda_halo`), one
   launch for every shard of a device.
4. **Local solve**: taper, neighbourhood selection, weight solve and
   application, per shard.

The JAX package runs steps 2-4 as one ``shard_map`` program. Here the
analysis function splits them at the exchange: (A) steps 2 and the pack on
every shard, (B) the exchange of all shards at once, (C) step 4 on every
shard. It takes global tensors and returns the global analysis on the
device of the input state.

Exactness: a halo of width ``h`` is exact iff every observation with a
nonzero taper weight for a local column lies within ``h`` shards, i.e.
``h >= ceil(cutoff / shard_span)`` (:func:`halo_width_for`). Ring
wraparound is harmless on non-periodic domains: wrapped candidates lie far
away and get taper weight 0.
"""

import logging
import math
from typing import Callable, Tuple

import numpy as np
import torch

from tpu_assim_torch.analysis import _normalized_obs_space, _with_time
from tpu_assim_torch.ops.cuda.letkf import (
    cheb_degree_for,
    letkf_nbh_analysis_cheb,
    letkf_window_analysis_fused,
    letkf_window_analysis_fused_2d,
    max_in_support_2d,
    taper_name,
)
from tpu_assim_torch.ops.etkf import letkf_weights_nbh
from tpu_assim_torch.ops.localization import safe_sqrt, taper_support_z
from tpu_assim_torch.parallel.cuda_halo import (
    _halo_offsets,
    ring_halo_plain,
    ring_halo_rdma,
)
from tpu_assim_torch.parallel.mesh import Mesh, _axis_devices

__all__ = [
    "shard_observations",
    "shard_observations_2d",
    "halo_width_for",
    "halo_letkf_analysis",
    "halo_letkf_analysis_2d",
]

logger = logging.getLogger(__name__)

# Coordinate sentinel of wrapped and pad candidates: outside every support.
_BIG = float(np.finfo(np.float32).max)

_EXCHANGES = {"ppermute": ring_halo_plain, "rdma": ring_halo_rdma}


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plain_abs_dist_probe(localization, n_dim: int) -> bool:
    """Does ``localization.dist_func`` act as the plain per-dimension
    ``|obs - grid|`` distance (the one the window kernels implement) on
    representative offsets?

    Decides only whether the ``local_method="window"`` builders warn that
    they ignore a custom distance. The offsets reach well beyond the taper
    support, so periodic wrap distances are caught. In 2-D one probe moves
    both coordinates at once: a radial or summed distance agrees with the
    plain one on every single-axis offset, and only a diagonal one tells
    them apart. A ``dist_func`` that raises on the probe, returns another
    layout, or differs anywhere gives ``False`` (=> warn).
    """
    df = getattr(localization, "dist_func", None)
    if df is None:
        return True
    r = np.atleast_1d(np.asarray(localization.radius, dtype=float))
    r = np.concatenate([r, np.repeat(r[-1], max(0, n_dim - r.size))])
    r = np.maximum(r[:n_dim], 1e-6)
    offs = np.array([0.0, 0.37, -1.13, 2.41, -8.5, 17.5])
    deltas = np.zeros((offs.size * n_dim + (n_dim >= 2), n_dim))
    for d in range(n_dim):
        deltas[d * offs.size:(d + 1) * offs.size, d] = offs
    if n_dim >= 2:
        deltas[-1, :2] = (1.3, -0.6)
    deltas *= r
    base = np.zeros(1 + n_dim)
    base[1:] = 5.0 * r                       # arbitrary interior base point
    probes = np.tile(base, (deltas.shape[0], 1))
    probes[:, 1:] += deltas
    try:
        got = torch.atleast_2d(df(torch.as_tensor(base),
                                  torch.as_tensor(probes)))
        got = got.detach().cpu().numpy()
    except Exception:  # a user callable: any failure means "not plain"
        return False
    if got.ndim != 2 or got.shape[-1] != deltas.shape[0]:
        return False
    # each returned row is one of the probe's nonzero per-dimension
    # |deltas| or zero, and each nonzero |delta| appears in some row
    expect = np.abs(deltas).T                                # [n_dim, n_p]
    tol = 1e-5 * max(float(r.max()), 1.0)
    # [rows, dims, n_p]
    near = np.abs(got[:, None, :] - expect[None]) <= tol * (1.0 + expect[None])
    rows_ok = (near & (expect[None] > tol)).any(1) | (np.abs(got) <= tol)
    covered = near.any(0) | (expect <= tol)
    return bool(rows_ok.all() and covered.all())


def halo_width_for(radius: float, shard_span: float) -> int:
    """Number of neighbour shards (per side) that can hold nonzero-taper
    observations: the Gaspari-Cohn support is ``2 * radius``, a shard spans
    ``shard_span`` in distance units."""
    return max(1, int(math.ceil(2.0 * radius / shard_span)))


def shard_observations(
    obs_vals: np.ndarray,
    obs_var: np.ndarray,
    obs_idx: np.ndarray,
    obs_coords: np.ndarray,
    n_grid: int,
    n_shards: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Bucket observations by owning grid shard and pad to a common count
    per shard (host-side numpy).

    An observation belongs to the shard whose grid block holds its
    observed column (``obs_idx // shard_size``). Padded slots carry
    ``valid = 0`` and point at local column 0.

    Parameters
    ----------
    obs_vals : [o] values.
    obs_var : [o] diagonal variances, or [o, o] correlated covariance,
        which must be block-diagonal over the shard ownership.
    obs_idx : [o] int observed grid columns.
    obs_coords : [o, d] obs coordinates.
    n_grid : total grid size (must divide evenly by ``n_shards``).
    n_shards : number of grid shards.

    Returns
    -------
    (vals [s*p], var, local_idx [s*p], coords [s*p, d], valid [s*p],
     obs_per_shard p): ``var`` is [s*p] for diagonal input or [s*p, p]
    per-shard covariance blocks for correlated input (padded slots carry
    unit diagonal).
    """
    if n_grid % n_shards:
        raise ValueError("n_grid must divide evenly over n_shards")
    obs_vals, obs_coords = _numpy(obs_vals), _numpy(obs_coords)
    shard_size = n_grid // n_shards
    obs_var = _numpy(obs_var)
    correlated = obs_var.ndim == 2
    owner = _numpy(obs_idx) // shard_size
    counts = np.bincount(owner, minlength=n_shards)
    obs_per_shard = int(counts.max())
    d = obs_coords.shape[1]
    vals = np.zeros((n_shards, obs_per_shard), dtype=obs_vals.dtype)
    if correlated:
        var = np.tile(np.eye(obs_per_shard, dtype=obs_var.dtype),
                      (n_shards, 1, 1))
    else:
        var = np.ones((n_shards, obs_per_shard), dtype=obs_var.dtype)
    lidx = np.zeros((n_shards, obs_per_shard), dtype=np.int32)
    coords = np.zeros((n_shards, obs_per_shard, d), dtype=obs_coords.dtype)
    valid = np.zeros((n_shards, obs_per_shard), dtype=obs_vals.dtype)
    fill = np.zeros(n_shards, dtype=np.int64)
    slot = np.zeros(len(obs_vals), dtype=np.int64)
    for o in range(len(obs_vals)):
        s = owner[o]
        j = fill[s]
        vals[s, j] = obs_vals[o]
        if not correlated:
            var[s, j] = obs_var[o]
        lidx[s, j] = obs_idx[o] - s * shard_size
        coords[s, j] = obs_coords[o]
        valid[s, j] = 1.0
        slot[o] = j
        fill[s] += 1
    if correlated:
        nz_i, nz_j = np.nonzero(obs_var)
        if np.any(owner[nz_i] != owner[nz_j]):
            raise ValueError(
                "correlated R must be block-diagonal over the shard "
                "ownership: found nonzero correlation between obs owned by "
                "different shards")
        var[owner[nz_i], slot[nz_i], slot[nz_j]] = obs_var[nz_i, nz_j]
    return (
        vals.reshape(-1),
        var.reshape(-1, obs_per_shard) if correlated else var.reshape(-1),
        lidx.reshape(-1),
        coords.reshape(-1, d),
        valid.reshape(-1),
        obs_per_shard,
    )


def _ring_halo_sorted(blocks, coord_row: int, n_shards: int,
                      halo_width: int):
    """The halo concat of each shard in ascending ring-offset order ``[-h
    .. -1, 0, 1 .. h]``, for the windowed local solve, which needs the
    coordinate row (``coord_row``, the last) sorted across the concat.

    A block whose source ``s + off`` lies outside ``[0, n)`` has wrapped:
    its coordinate row becomes ``-/+ float32.max``, which keeps the concat
    sorted and puts it outside every support. Offsets with ``|off| >= n``
    wrap for every shard and are dropped. Aliased ``+/-off`` hops on small
    rings come in on both sides, each masked by its own wrap test, so on a
    non-periodic domain every real observation is seen once.
    """
    out = []
    for s in range(n_shards):
        device = blocks[s].device
        parts = []
        for off in range(-halo_width, halo_width + 1):
            if off == 0:
                parts.append(blocks[s])
                continue
            if abs(off) >= n_shards:
                continue
            blk = blocks[(s + off) % n_shards].to(device)
            if not 0 <= s + off < n_shards:
                fill = torch.full_like(blk[coord_row:coord_row + 1],
                                       _BIG if off > 0 else -_BIG)
                blk = torch.cat([blk[:coord_row], fill])
            parts.append(blk)
        out.append(torch.cat(parts, dim=-1))
    return out


def _halo_auto_degree(state_data, obs_vals, obs_var, obs_lidx, obs_coords,
                      obs_valid, n_shards, max_obs, inf_factor,
                      consecutive: bool) -> int:
    """Chebyshev degree for the halo entry points, measured on the host
    (numpy, f64): the solve operator of a column is ``X = I + Zh Zh^T /
    reg``, whose spectrum is bounded by ``1 + tr(S)/reg`` with ``tr(S) =
    sum_o w_o ||z_o||^2`` at most the largest sum of ``max_obs`` whitened
    perturbation norms: over consecutive coordinates (``consecutive``, the
    sorted window selection), else over any ``max_obs`` (any taper with
    ``w <= 1``)."""
    state = _numpy(state_data).astype(np.float64)
    k, g = state.shape
    p = _numpy(obs_vals).shape[0] // n_shards
    shard_size = g // n_shards
    lidx = _numpy(obs_lidx)
    gidx = (np.arange(n_shards * p) // p) * shard_size + lidx
    valid = _numpy(obs_valid) > 0
    ens_obs = state[:, gidx]
    mean = ens_obs.mean(axis=0, keepdims=True)
    perts = ens_obs - mean
    var = _numpy(obs_var).astype(np.float64)
    if var.ndim == 2:
        # per-shard correlated blocks: whiten by the local Cholesky factor
        blocks = var.reshape(n_shards, p, p)
        pb = perts.reshape(k, n_shards, p)
        for s in range(n_shards):
            chol = np.linalg.cholesky(blocks[s])
            pb[:, s, :] = np.linalg.solve(chol, pb[:, s, :].T).T
        perts = pb.reshape(k, n_shards * p)
    else:
        perts = perts / np.sqrt(var)[None, :]
    znorm = np.sum(perts**2, axis=0) * valid
    reg = (k - 1) / float(inf_factor)
    width = min(int(max_obs), int(valid.sum())) or 1
    if consecutive:
        ox = _numpy(obs_coords)[:, 0]
        order = np.argsort(ox[valid], kind="stable")
        zs = znorm[valid][order]
        cs = np.concatenate([[0.0], np.cumsum(zs)])
        tr_max = float((cs[width:] - cs[:-width]).max()) if len(zs) else 0.0
    else:
        tr_max = float(np.sort(znorm)[-width:].sum())
    return cheb_degree_for(1.0 + tr_max / reg)


def _halo_max_in_support(obs_coords, obs_valid, n_shards, radius, taper,
                         epsilon, halo_width) -> int:
    """Worst per-column count of candidates inside the taper support on the
    windowed halo path (host-side numpy, exact, pad slots included): pad
    slots sit at their shard's largest valid coordinate and, though
    zero-valued, take window slots when that coordinate falls inside a
    column's support, so the precheck counts them as the kernel's overflow
    guard does. The worst count over columns equals the largest candidate
    cluster inside any open support window, taken at candidate
    positions."""
    coords = _numpy(obs_coords)[:, 0]
    valid = _numpy(obs_valid) > 0
    p = coords.shape[0] // n_shards
    cand = []
    for s in range(n_shards):
        sl = slice(s * p, (s + 1) * p)
        c = coords[sl][valid[sl]]
        cand.append(c)
        n_pad = p - c.shape[0]
        if n_pad and c.shape[0]:
            cand.append(np.full(n_pad, c.max()))
        # an obs-free shard's pads sit at its left grid edge, which lies at
        # or below every later shard's observations: counted at the
        # previous shard's largest coordinate (the same sorted slot)
        elif n_pad and cand:
            prev = cand[-1] if len(cand[-1]) else None
            if prev is not None and len(prev):
                cand.append(np.full(n_pad, prev.max()))
    if not cand:
        return 0
    allc = np.sort(np.concatenate(cand))
    s_cut = taper_support_z(taper, epsilon) * radius
    lo = np.searchsorted(allc, allc - 2 * s_cut, side="right")
    hi = np.arange(1, allc.shape[0] + 1)
    return int((hi - lo).max()) if allc.size else 0


def _window_params(localization, n_dim: int):
    """``(radii, taper, epsilon)`` of a Gaspari-Cohn localization for the
    window paths; warns when its ``dist_func`` is not the plain distance
    the window kernels use."""
    if not hasattr(localization, "radius"):
        raise TypeError(
            "local_method='window' needs a Gaspari-Cohn localization; got "
            f"{type(localization)}")
    radii = np.atleast_1d(np.asarray(localization.radius, dtype=float))
    if not _plain_abs_dist_probe(localization, n_dim):
        logger.warning(
            "local_method='window' ignores the localization's dist_fn: the "
            "window kernels use plain per-dimension |obs - grid| coordinate "
            "distances and mask ring-wrapped candidates (non-periodic "
            "domains only). Use local_method='topk' for periodic or custom "
            "distances.")
    return radii, taper_name(localization), float(localization.epsilon)


def _local_obs_space(state_flat, vals, var, lidx, valid):
    """(A), shared by the 1-D and 2-D paths: a shard's obs equivalents from
    its own grid block, R^{-1/2}-normalized (a correlated block through its
    Cholesky factor; pad slots carry unit diagonal) and zeroed on pad
    slots."""
    perts, innov = _normalized_obs_space(state_flat[:, lidx.long()], vals,
                                         var)
    return perts * valid, innov * valid


def _pack(rows):
    """One block of the packed rows, in their promoted dtype."""
    dtype = rows[0].dtype
    for r in rows[1:]:
        dtype = torch.promote_types(dtype, r.dtype)
    return torch.cat([r.to(dtype) for r in rows], dim=0).contiguous()


def _topk_solve(cand, gflat, state_flat, localization, max_obs, inf_factor,
                method, newton_iters, use_pallas, degree):
    """(C) of the top-k paths: the taper against the local columns over
    the candidates (invalid slots weigh 0), the ``max_obs`` largest weights
    per column (ties to the lower index), then the weight solve and apply,
    or the Chebyshev kernel K4 (``use_pallas``)."""
    k = state_flat.shape[0]
    c_perts, c_innov, c_valid = cand[:k], cand[k], cand[k + 1]
    c_coords = cand[k + 2:].T
    w_loc = localization.taper_weights(_with_time(gflat),
                                       _with_time(c_coords))
    w_loc = w_loc * c_valid[None, :]
    kk = min(max_obs, w_loc.shape[-1])
    top_w, top_idx = torch.sort(w_loc, dim=-1, descending=True, stable=True)
    top_w, top_idx = top_w[:, :kk], top_idx[:, :kk]
    if kk < max_obs:
        top_w = torch.nn.functional.pad(top_w, (0, max_obs - kk))
        top_idx = torch.nn.functional.pad(top_idx, (0, max_obs - kk))
    mean_s = torch.mean(state_flat, dim=0)
    sp = state_flat - mean_s[None, :]
    if use_pallas:
        f32 = torch.float32
        sw = safe_sqrt(top_w).to(c_perts.dtype)                  # [g, nb]
        zh = c_perts[:, top_idx].permute(2, 0, 1) * sw.T[:, None, :]
        yh = c_innov[top_idx].T * sw.T                           # [nb, g]
        out = letkf_nbh_analysis_cheb(
            *(t.to(f32).contiguous() for t in (zh, yh, sp, mean_s)),
            (k - 1) / inf_factor, k, degree=degree)
        return out.to(state_flat.dtype)
    weights = letkf_weights_nbh(c_perts, c_innov, top_idx,
                                top_w.to(c_perts.dtype), inf_factor,
                                method=method, newton_iters=newton_iters)
    return mean_s[None, :] + torch.einsum("kg,gkm->mg", sp, weights)


def _check_local_method(local_method: str) -> None:
    if local_method not in ("topk", "window"):
        raise ValueError(
            f"local_method must be 'topk' or 'window', got {local_method!r}")


def halo_letkf_analysis(
    mesh: Mesh,
    localization,
    max_obs: int,
    halo_width: int = 1,
    inf_factor: float = 1.0,
    method: str = "eigh",
    newton_iters: int = 25,
    axis_name: str = "grid",
    use_pallas: bool = False,
    cheb_degree: int | None = None,
    comm: str = "ppermute",
    local_method: str = "topk",
    max_obs_strict: bool = True,
) -> Callable:
    """Build an obs-sharded LETKF analysis over the ``axis_name`` axis of
    ``mesh`` (the parameters of
    :func:`tpu_assim.parallel.halo.halo_letkf_analysis`, in its order).

    ``comm``: ``"ppermute"`` — the halo exchange by copies
    (:func:`~tpu_assim_torch.parallel.cuda_halo.ring_halo_plain`);
    ``"rdma"`` — kernel K8
    (:func:`~tpu_assim_torch.parallel.cuda_halo.ring_halo_rdma`): one
    launch per device for all of its shards, the same blocks bit for bit.
    The window path exchanges by copies either way, as in JAX.

    ``cheb_degree``: Chebyshev degree of the kernel solves (``use_pallas``,
    ``local_method="window"``); ``None`` measures the spectral bound of each
    call's inputs on the host (:func:`_halo_auto_degree`).
    ``max_obs_strict`` (default True) makes windowed calls raise when a
    column's in-support candidate count (valid obs and pad slots) exceeds
    ``max_obs``.

    ``local_method``: ``"topk"`` (default) — the dense taper over all halo
    candidates and the ``max_obs`` largest weights per column (any
    localization and distance); then the weights by ``method`` (``eigh``,
    ``newton``, ``woodbury``), or, with ``use_pallas``, the Chebyshev solve
    and apply of kernel K4. ``"window"`` — each shard runs the whole 1-D
    window analysis, kernel K1, on its candidates sorted in ring order: for
    1-D non-periodic Gaspari-Cohn localization and coordinate-sorted
    observations. It uses the plain ``|obs_x - grid_x|`` distance and masks
    ring-wrapped candidates out, and warns when the localization's
    distance is not that one. Pad slots sit at their shard's largest valid
    coordinate (its left grid edge when it owns no observation): zeroed,
    they add nothing, but they take window slots.

    The kernel paths compute in f32 and return the state's dtype.

    Returns
    -------
    analysis_fn(state_data [k, g], obs_vals [s*p], obs_var [s*p] (or
                [s*p, p]), obs_local_idx [s*p], obs_coords [s*p, d],
                obs_valid [s*p], grid_coords [g, d]) -> analysis [k, g]

    with the obs arrays of :func:`shard_observations` (tensors or numpy
    arrays), the analysis on the device of ``state_data``. With
    ``halo_width >= halo_width_for(radius, shard_span)`` the result is the
    replicated-obs analysis.
    """
    if axis_name not in mesh.shape:
        raise ValueError(
            f"axis_name {axis_name!r} not in mesh axes {mesh.axis_names}")
    devices = _axis_devices(mesh, axis_name)
    n_shards = int(mesh.shape[axis_name])
    _check_local_method(local_method)
    if comm not in _EXCHANGES:
        raise ValueError(f"comm must be 'ppermute' or 'rdma', got {comm!r}")
    if local_method == "window":
        radii, taper, eps = _window_params(localization, 1)
        if radii.size != 1:
            raise ValueError("local_method='window' supports a single "
                             f"localization radius; got {radii}")
        radius = float(radii[0])
    needs_degree = use_pallas or local_method == "window"

    def solve_window(cand, state_loc, gcoords, degree):
        k = state_loc.shape[0]
        mean_s = torch.mean(state_loc, dim=0)
        sp = state_loc - mean_s[None, :]
        out = letkf_window_analysis_fused(
            *(t.to(torch.float32).contiguous() for t in (
                cand[:k], cand[k], cand[k + 1], gcoords[:, 0], sp, mean_s)),
            (k - 1) / inf_factor, radius, k, nb=max_obs, degree=degree,
            taper=taper, epsilon=eps)
        return out.to(state_loc.dtype)

    def analysis_fn(state_data, obs_vals, obs_var, obs_local_idx, obs_coords,
                    obs_valid, grid_coords):
        obs = [torch.as_tensor(a) for a in (obs_vals, obs_var, obs_local_idx,
                                            obs_coords, obs_valid)]
        grid_coords = torch.as_tensor(grid_coords)
        if local_method == "window" and max_obs_strict:
            # the fixed-size window is exact iff no column sees more
            # in-support candidates (real obs and pad slots) than max_obs
            worst = _halo_max_in_support(obs[3], obs[4], n_shards, radius,
                                         taper, eps, halo_width)
            if worst > max_obs:
                raise ValueError(
                    f"a grid column may see {worst} in-support candidates "
                    f"(valid obs + pad slots) but max_obs={max_obs}: the "
                    f"window selection would truncate. Raise max_obs to >= "
                    f"{worst} (pad slots count — rebalance shard obs counts "
                    "to shrink them) or pass max_obs_strict=False.")
        degree = cheb_degree
        if degree is None and needs_degree:
            degree = _halo_auto_degree(
                state_data, *obs, n_shards, max_obs, inf_factor,
                consecutive=local_method == "window")
        k, g = state_data.shape
        if g % n_shards or obs[0].shape[0] % n_shards:
            raise ValueError(
                f"{g} grid columns and {obs[0].shape[0]} obs slots must "
                f"split evenly over {n_shards} shards")
        gl, p = g // n_shards, obs[0].shape[0] // n_shards
        shards = []
        for s, device in enumerate(devices):
            cols = slice(s * gl, (s + 1) * gl)
            slots = slice(s * p, (s + 1) * p)
            shards.append((state_data[:, cols].to(device),
                           *(a[slots].to(device) for a in obs),
                           grid_coords[cols].to(device)))
        # (A) local obs space and pack
        packed = []
        for state_loc, vals, var, lidx, ocoords, valid, gcoords in shards:
            perts, innov = _local_obs_space(state_loc, vals, var, lidx, valid)
            if local_method == "window":
                # pad slots at the shard's largest valid coordinate (its
                # left grid edge without one): >= its own obs and <= the
                # next shard's, so the ring-order concat stays sorted
                ox = ocoords[:, 0]
                pad_x = torch.maximum(
                    torch.max(torch.where(valid > 0, ox, -_BIG)),
                    torch.min(gcoords[:, 0]).to(ox.dtype))
                packed.append(_pack([perts, innov[None],
                                     torch.where(valid > 0, ox, pad_x)[None]]))
            else:
                packed.append(_pack([perts, innov[None], valid[None],
                                     ocoords.T]))
        # (B) the exchange of every shard at once
        if local_method == "window":
            cands = _ring_halo_sorted(packed, k + 1, n_shards, halo_width)
        else:
            cands = _EXCHANGES[comm](packed, n_shards, halo_width)
        # (C) solve and apply
        outs = []
        for (state_loc, *_, gcoords), cand in zip(shards, cands):
            if local_method == "window":
                outs.append(solve_window(cand, state_loc, gcoords, degree))
            else:
                outs.append(_topk_solve(
                    cand, gcoords, state_loc, localization, max_obs,
                    inf_factor, method, newton_iters, use_pallas, degree))
        return torch.cat([o.to(state_data.device) for o in outs], dim=1)

    return analysis_fn


# ---------------------------------------------------------------------------
# 2-D domain decomposition
# ---------------------------------------------------------------------------

def shard_observations_2d(
    obs_vals: np.ndarray,
    obs_var: np.ndarray,
    obs_ij: np.ndarray,
    obs_coords: np.ndarray,
    grid_shape: Tuple[int, int],
    mesh_shape: Tuple[int, int],
):
    """Bucket observations of a 2-D (rows x cols) grid by owning mesh tile
    (host-side numpy).

    Parameters
    ----------
    obs_vals / obs_var : [o] (obs_var [o, o] correlated, block-diagonal
        over the tiles).
    obs_ij : [o, 2] int observed (row, col) grid positions.
    obs_coords : [o, d] obs coordinates for the taper.
    grid_shape : (n_rows, n_cols) of the physical grid.
    mesh_shape : (mesh_rows, mesh_cols) of the device mesh.

    Returns flat per-tile arrays ``[tiles * p, ...]`` in tile-major,
    row-major tile order, the local flat index inside each tile block, and
    the per-tile pad count ``p``.
    """
    obs_vals, obs_coords = _numpy(obs_vals), _numpy(obs_coords)
    obs_ij = _numpy(obs_ij)
    n_rows, n_cols = grid_shape
    m_rows, m_cols = mesh_shape
    if n_rows % m_rows or n_cols % m_cols:
        raise ValueError("grid_shape must divide evenly over mesh_shape")
    tr, tc = n_rows // m_rows, n_cols // m_cols
    owner = (obs_ij[:, 0] // tr) * m_cols + (obs_ij[:, 1] // tc)
    n_tiles = m_rows * m_cols
    counts = np.bincount(owner, minlength=n_tiles)
    p = max(int(counts.max()), 1)
    d = obs_coords.shape[1]
    obs_var = _numpy(obs_var)
    correlated = obs_var.ndim == 2
    vals = np.zeros((n_tiles, p), dtype=obs_vals.dtype)
    if correlated:
        var = np.tile(np.eye(p, dtype=obs_var.dtype), (n_tiles, 1, 1))
    else:
        var = np.ones((n_tiles, p), dtype=obs_var.dtype)
    lidx = np.zeros((n_tiles, p), dtype=np.int32)
    coords = np.zeros((n_tiles, p, d), dtype=obs_coords.dtype)
    valid = np.zeros((n_tiles, p), dtype=obs_vals.dtype)
    fill = np.zeros(n_tiles, dtype=np.int64)
    slot = np.zeros(len(obs_vals), dtype=np.int64)
    for o in range(len(obs_vals)):
        t = owner[o]
        j = fill[t]
        vals[t, j] = obs_vals[o]
        if not correlated:
            var[t, j] = obs_var[o]
        lidx[t, j] = (obs_ij[o, 0] % tr) * tc + (obs_ij[o, 1] % tc)
        coords[t, j] = obs_coords[o]
        valid[t, j] = 1.0
        slot[o] = j
        fill[t] += 1
    if correlated:
        nz_i, nz_j = np.nonzero(obs_var)
        if np.any(owner[nz_i] != owner[nz_j]):
            raise ValueError(
                "correlated R must be block-diagonal over the tile "
                "ownership: found nonzero correlation between obs owned by "
                "different tiles")
        var[owner[nz_i], slot[nz_i], slot[nz_j]] = obs_var[nz_i, nz_j]
    return (
        vals.reshape(-1),
        var.reshape(-1, p) if correlated else var.reshape(-1),
        lidx.reshape(-1),
        coords.reshape(-1, d), valid.reshape(-1), p,
    )


def _tile(t: int, axis: int, off: int, m_rows: int, m_cols: int) -> int:
    """The tile ``off`` steps from tile ``t`` along ``axis`` (0 rows, 1
    columns) of the (m_rows, m_cols) torus, in tile-major order."""
    i, j = divmod(t, m_cols)
    if axis == 0:
        return ((i + off) % m_rows) * m_cols + j
    return i * m_cols + (j + off) % m_cols


def _ring_halo_2d(blocks, mesh_rows, mesh_cols, halo_r, halo_c):
    """2-D halo: each tile's packed block with those of its (2 halo_r + 1) x
    (2 halo_c + 1) tile neighbourhood: the row-axis exchange first, then
    the column-axis exchange of the row-concatenated blocks (corners by
    relay). blocks [rows, p] per tile -> [rows, (2hr+1)(2hc+1) p]."""
    n = mesh_rows * mesh_cols
    stages = ((0, mesh_rows, halo_r), (1, mesh_cols, halo_c))
    for axis, extent, width in stages:
        offsets = _halo_offsets(extent, width)
        blocks = [torch.cat([blocks[t]] + [
            blocks[_tile(t, axis, -off, mesh_rows, mesh_cols)].to(
                blocks[t].device) for off in offsets], dim=-1)
            for t in range(n)]
    return blocks


def _ring_halo_2d_masked(blocks, coord_start, mesh_rows, mesh_cols, halo_r,
                         halo_c):
    """2-D halo exchange for the windowed local solve: every block whose
    source tile wrapped around the torus on either axis gets its coordinate
    rows (``[coord_start:]``) set to ``+float32.max``, which puts it outside
    every y-band of the 2-D window kernel (it sorts internally, so the
    order does not matter). Offsets with ``|off| >= extent`` are dropped;
    aliased ``+/-off`` hops come in on both sides, each masked by its own
    wrap test."""
    n = mesh_rows * mesh_cols
    for axis, extent, width in ((0, mesh_rows, halo_r),
                                (1, mesh_cols, halo_c)):
        out = []
        for t in range(n):
            pos = divmod(t, mesh_cols)[axis]
            parts = []
            for off in range(-width, width + 1):
                if off == 0:
                    parts.append(blocks[t])
                    continue
                if abs(off) >= extent:
                    continue
                blk = blocks[_tile(t, axis, off, mesh_rows, mesh_cols)].to(
                    blocks[t].device)
                if not 0 <= pos + off < extent:
                    blk = torch.cat([blk[:coord_start], torch.full_like(
                        blk[coord_start:], _BIG)])
                parts.append(blk)
            out.append(torch.cat(parts, dim=-1))
        blocks = out
    return blocks


def halo_letkf_analysis_2d(
    mesh: Mesh,
    localization,
    max_obs: int,
    grid_shape: Tuple[int, int],
    halo: Tuple[int, int] = (1, 1),
    inf_factor: float = 1.0,
    method: str = "eigh",
    newton_iters: int = 25,
    row_axis: str = "row",
    col_axis: str = "col",
    use_pallas: bool = False,
    cheb_degree: int | None = None,
    local_method: str = "topk",
    obs_block: int = 0,
    max_obs_strict: bool = True,
) -> Callable:
    """Obs-sharded LETKF over a 2-D (row, col) domain decomposition (the
    parameters of :func:`tpu_assim.parallel.halo.halo_letkf_analysis_2d`,
    in its order).

    ``cheb_degree=None`` measures the degree on each call's inputs and
    ``max_obs_strict=True`` prechecks the per-column in-support count of
    windowed calls, as :func:`halo_letkf_analysis` does (2-D pad slots carry
    sentinel coordinates outside every band, so only real observations
    count). ``local_method="topk"`` solves by ``method`` or, with
    ``use_pallas``, by kernel K4; ``"window"`` runs the whole 2-D window
    analysis, kernel K6, per tile, and needs ``obs_block > 0``.

    Returns
    -------
    analysis_fn(state_data [k, R, C], obs_vals [t*p], obs_var [t*p],
                obs_local_idx [t*p], obs_coords [t*p, d], obs_valid [t*p],
                grid_coords [R, C, d]) -> analysis [k, R, C]

    with obs arrays from :func:`shard_observations_2d`. State rows split
    over ``row_axis``, columns over ``col_axis``; each tile takes the obs
    blocks of its ``(2*halo[0]+1) x (2*halo[1]+1)`` tile neighbourhood.
    Exact when the taper support fits inside the halo.
    """
    devices = _axis_devices(mesh, row_axis, col_axis)
    m_rows, m_cols = int(mesh.shape[row_axis]), int(mesh.shape[col_axis])
    n_tiles = m_rows * m_cols
    halo_r, halo_c = halo
    _check_local_method(local_method)
    if local_method == "window":
        if obs_block <= 0:
            raise ValueError(
                "local_method='window' needs obs_block > 0 — compute it from "
                "the global workload with required_obs_block_2d (a loose "
                "bound is fine; too-small blocks NaN-poison loudly, never "
                "truncate silently)")
        radii, taper, eps = _window_params(localization, 2)
        rx = float(radii[0])
        ry = float(radii[1] if radii.size > 1 else radii[-1])
    needs_degree = use_pallas or local_method == "window"

    def check_support(obs_coords, obs_valid, grid_coords):
        """Exact in-support precheck per tile: each tile's kernel sees the
        valid obs of its tile neighbourhood (wrapped sources are masked out
        on non-periodic domains, pad slots carry sentinel coordinates),
        over its local flat grid as the kernel tiles it."""
        coords = _numpy(obs_coords)
        valid = _numpy(obs_valid) > 0
        grid = _numpy(grid_coords)
        tr, tc = grid.shape[0] // m_rows, grid.shape[1] // m_cols
        p = coords.shape[0] // n_tiles
        worst = 0
        for i in range(m_rows):
            for j in range(m_cols):
                cand = []
                for si in range(max(i - halo_r, 0),
                                min(i + halo_r + 1, m_rows)):
                    for sj in range(max(j - halo_c, 0),
                                    min(j + halo_c + 1, m_cols)):
                        sl = slice((si * m_cols + sj) * p,
                                   (si * m_cols + sj + 1) * p)
                        cand.append(coords[sl][valid[sl], :2])
                gloc = grid[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc]
                cxy = np.concatenate(cand, axis=0)
                if cxy.shape[0]:
                    worst = max(worst, max_in_support_2d(
                        cxy, gloc.reshape(tr * tc, -1)[:, :2], rx, ry,
                        taper=taper, epsilon=eps))
        return worst

    def solve_window(cand, state_flat, gcoords, degree):
        k = state_flat.shape[0]
        n_dims = cand.shape[0] - k - 1
        extra = tuple(float(radii[j] if j < radii.size else radii[-1])
                      for j in range(2, n_dims))
        mean_s = torch.mean(state_flat, dim=0)
        sp = state_flat - mean_s[None, :]
        f32 = torch.float32
        return letkf_window_analysis_fused_2d(
            *(t.to(f32).contiguous() for t in (cand[:k], cand[k])),
            cand[k + 1:].T, gcoords.reshape(state_flat.shape[1], -1),
            *(t.to(f32).contiguous() for t in (sp, mean_s)),
            (k - 1) / inf_factor, rx, ry, k, obs_block=obs_block, nb=max_obs,
            degree=degree, taper=taper, epsilon=eps,
            extra_radii=extra).to(state_flat.dtype)

    def analysis_fn(state_data, obs_vals, obs_var, obs_local_idx, obs_coords,
                    obs_valid, grid_coords):
        obs = [torch.as_tensor(a) for a in (obs_vals, obs_var, obs_local_idx,
                                            obs_coords, obs_valid)]
        grid_coords = torch.as_tensor(grid_coords)
        if local_method == "window" and max_obs_strict:
            worst = check_support(obs[3], obs[4], grid_coords)
            if worst > max_obs:
                raise ValueError(
                    f"a grid column may see {worst} in-support band obs but "
                    f"max_obs={max_obs}: the 2-D window selection would "
                    f"truncate. Raise max_obs to >= {worst} or pass "
                    "max_obs_strict=False.")
        k, n_r, n_c = state_data.shape
        if n_r % m_rows or n_c % m_cols or obs[0].shape[0] % n_tiles:
            raise ValueError(
                f"a [{n_r}, {n_c}] grid and {obs[0].shape[0]} obs slots "
                f"must split evenly over the ({m_rows}, {m_cols}) tiles")
        tr, tc = n_r // m_rows, n_c // m_cols
        degree = cheb_degree
        if degree is None and needs_degree:
            # tile-major flattening, the order of shard_observations_2d
            sd = _numpy(state_data).reshape(k, m_rows, tr, m_cols, tc)
            sd = sd.transpose(0, 1, 3, 2, 4).reshape(k, n_r * n_c)
            degree = _halo_auto_degree(
                sd, *obs, n_tiles, max_obs, inf_factor, consecutive=False)
        p = obs[0].shape[0] // n_tiles
        shards = []
        for t, device in enumerate(devices):
            i, j = divmod(t, m_cols)
            rows = slice(i * tr, (i + 1) * tr)
            cols = slice(j * tc, (j + 1) * tc)
            slots = slice(t * p, (t + 1) * p)
            shards.append((
                state_data[:, rows, cols].to(device).reshape(k, tr * tc),
                *(a[slots].to(device) for a in obs),
                grid_coords[rows, cols].to(device)))
        # (A) local obs space and pack
        packed = []
        for state_flat, vals, var, lidx, ocoords, valid, _ in shards:
            perts, innov = _local_obs_space(state_flat, vals, var, lidx,
                                            valid)
            if local_method == "window":
                ocoords_w = torch.where(valid[:, None] > 0, ocoords, _BIG)
                packed.append(_pack([perts, innov[None], ocoords_w.T]))
            else:
                packed.append(_pack([perts, innov[None], valid[None],
                                     ocoords.T]))
        # (B) the exchange of every tile at once
        if local_method == "window":
            cands = _ring_halo_2d_masked(packed, k + 1, m_rows, m_cols,
                                         halo_r, halo_c)
        else:
            cands = _ring_halo_2d(packed, m_rows, m_cols, halo_r, halo_c)
        # (C) solve and apply per tile, then reassemble the grid
        tiles = []
        for (state_flat, *_, gcoords), cand in zip(shards, cands):
            if local_method == "window":
                out = solve_window(cand, state_flat, gcoords, degree)
            else:
                out = _topk_solve(cand, gcoords.reshape(tr * tc, -1),
                                  state_flat, localization, max_obs,
                                  inf_factor, method, newton_iters,
                                  use_pallas, degree)
            tiles.append(out.reshape(k, tr, tc).to(state_data.device))
        return torch.cat([torch.cat(tiles[i * m_cols:(i + 1) * m_cols],
                                    dim=2) for i in range(m_rows)], dim=1)

    return analysis_fn
