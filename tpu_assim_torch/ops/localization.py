"""
Domain localization: Gaspari-Cohn taper functions (PyTorch port of
:mod:`tpu_assim.ops.localization`).

The piecewise-quintic correlation polynomials are kept verbatim; the
evaluation is a branch-free ``torch.where`` chain over every (grid column,
observation) pair at once. Weights at or below ``epsilon`` are cut to exactly
zero, so zero-weight observations contribute nothing to the weighted Gram
products of :func:`tpu_assim_torch.ops.etkf.letkf_weights_dense`.

Distance functions are user-supplied torch callables
``dist_func(grid_coord [d], obs_coords [o, d]) -> [n_dim, o] or [o]``.

The fixed-size neighborhood selections pick ``max_obs`` observations per
grid column: by the largest taper weights (:func:`neighborhood_select`), or
as a window around the column's rank among sorted coordinates
(:func:`neighborhood_select_window`); :func:`select_neighborhoods` picks
one of the two by name.
"""

import functools
from typing import Callable, Tuple, Union

import numpy as np
import torch

__all__ = [
    "BaseLocalization",
    "GaspariCohn",
    "GaspariCohnInf",
    "abs_distance",
    "neighborhood_select",
    "neighborhood_select_window",
    "periodic_distance",
    "safe_sqrt",
    "safe_sqrt_keep_nan",
    "select_neighborhoods",
    "taper_support_z",
]


def safe_sqrt(w: torch.Tensor) -> torch.Tensor:
    """``sqrt`` with a zero (not inf/NaN) gradient at ``w == 0``; the primal
    values equal ``torch.sqrt`` for ``w >= 0``."""
    pos = w > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, w, torch.ones_like(w))),
                       torch.zeros_like(w))


def safe_sqrt_keep_nan(w: torch.Tensor) -> torch.Tensor:
    """:func:`safe_sqrt` that leaves NaN weights NaN, so that the strict
    window selections' NaN poison reaches the sqrt-weight-scaled
    neighborhoods (``safe_sqrt`` maps NaN to 0, which would give an
    overflowing column the unchanged prior)."""
    return torch.where(torch.isnan(w), w, safe_sqrt(w))


def abs_distance(grid_coord: torch.Tensor,
                 obs_coords: torch.Tensor) -> torch.Tensor:
    """Per-dimension absolute difference ``[n_dim, o]``."""
    grid_coord = torch.atleast_1d(grid_coord)
    obs_coords = torch.atleast_2d(obs_coords)
    return torch.abs(obs_coords - grid_coord[None, :]).T


def periodic_distance(period: float) -> Callable:
    """Per-dimension distance on a ring of the given period (Lorenz-96
    grids)."""

    def dist(grid_coord: torch.Tensor, obs_coords: torch.Tensor):
        d = abs_distance(grid_coord, obs_coords)
        return torch.minimum(d, period - d)

    return dist


def _batched_dist(dist_func, grid_coords, obs_coords):
    """``dist_func`` over every grid column: ``[g, n_dim, o]``."""
    return torch.vmap(
        lambda gc: torch.atleast_2d(dist_func(gc, obs_coords))
    )(grid_coords)


class BaseLocalization:
    """Base localization API (the port of
    :class:`tpu_assim.ops.localization.BaseLocalization`): a subclass gives
    :meth:`localize_obs` for one grid column, and :meth:`taper_weights`
    maps it over every column."""

    def localize_obs(self, grid_coord: torch.Tensor,
                     obs_coords: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(use_obs, weights)`` for one grid column: a boolean mask of the
        usable observations and their taper weights."""
        raise NotImplementedError

    def localize_cov(self):
        """Covariance localization: declared, never implemented (as in the
        JAX package)."""
        raise NotImplementedError

    def taper_weights(self, grid_coords: torch.Tensor,
                      obs_coords: torch.Tensor) -> torch.Tensor:
        """Weights ``[g, o]`` for every (grid column, observation) pair,
        zero where :meth:`localize_obs` does not use the observation."""

        def one_column(coord):
            use_obs, weights = self.localize_obs(coord, obs_coords)
            return torch.where(use_obs, weights, torch.zeros_like(weights))

        return torch.vmap(one_column)(grid_coords)


class GaspariCohn:
    """Gaspari-Cohn correlation function ``C_0(z, 1/2, c)``; per-dimension
    radii multiply, and the function is zero from ``2 * length_scale``.

    Parameters
    ----------
    length_scale : scalar or sequence of per-dimension radii ``c``.
    dist_func : callable ``(grid_coord, obs_coords) -> [n_dim, o]`` distances.
    epsilon : weights at or below this value are cut to zero.
    """

    def __init__(self, length_scale: Union[float, Tuple[float, ...]],
                 dist_func: Callable, epsilon: float = 1e-5):
        self.radius = np.atleast_1d(np.asarray(length_scale, dtype=np.float64))
        self.dist_func = dist_func
        self.epsilon = epsilon

    def __str__(self) -> str:
        return "GaspariCohn(l={0})".format(str(self.radius))

    @staticmethod
    def _f1(z):
        """Inner segment, z < 1."""
        return -0.25 * z**5 + 0.5 * z**4 + 0.625 * z**3 - 5.0 / 3.0 * z**2 + 1.0

    @staticmethod
    def _f2(z):
        """Outer segment, 1 <= z < 2."""
        return (
            1.0 / 12.0 * z**5
            - 0.5 * z**4
            + 0.625 * z**3
            + 5.0 / 3.0 * z**2
            - 5.0 * z
            + 4.0
            - 2.0 / 3.0 / z
        )

    def taper_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        """GC polynomials on per-dimension distances ``[..., n_dim, m]`` ->
        weights ``[..., m]`` (sub-epsilon cut to 0)."""
        weights = torch.ones(dist.shape[:-2] + dist.shape[-1:],
                             dtype=dist.dtype, device=dist.device)
        for i in range(dist.shape[-2]):
            radius = self.radius[i] if i < len(self.radius) else self.radius[-1]
            z = dist[..., i, :] / float(radius)
            # clamp the off-branch argument into f2's domain: its 1/z term
            # would be inf at z ~ 0
            z_safe = torch.clamp(z, min=0.5)
            w = torch.where(z < 2.0, self._f2(z_safe), torch.zeros_like(z))
            w = torch.where(z < 1.0, self._f1(z), w)
            weights = weights * w
        return torch.where(weights > self.epsilon, weights,
                           torch.zeros_like(weights))

    def taper_weights(self, grid_coords: torch.Tensor,
                      obs_coords: torch.Tensor) -> torch.Tensor:
        """Weights ``[g, o]`` for every (grid column, observation) pair."""
        return self.taper_from_dist(
            _batched_dist(self.dist_func, grid_coords, obs_coords))


class GaspariCohnInf:
    """Gaspari-Cohn correlation function ``C_0(z, inf, c)`` with four
    piecewise segments and a single radius."""

    def __init__(self, length_scale: float, dist_func: Callable,
                 epsilon: float = 1e-5):
        self.radius = float(length_scale)
        self.dist_func = dist_func
        self.epsilon = epsilon

    def __str__(self) -> str:
        return "GaspariCohnInf(l={0})".format(str(self.radius))

    @staticmethod
    def _f1(z):
        """z < 0.5."""
        return (
            -28.0 * z**5 / 33.0
            + 8.0 * z**4 / 11.0
            + 20.0 * z**3 / 11.0
            - 80.0 * z**2 / 33.0
            + 1.0
        )

    @staticmethod
    def _f2(z):
        """0.5 <= z < 1."""
        return (
            20.0 * z**5 / 33.0
            - 16.0 * z**4 / 11.0
            + 100.0 * z**2 / 33.0
            - 45.0 * z / 11.0
            + 51.0 / 22.0
            - 7.0 / (44.0 * z)
        )

    @staticmethod
    def _f3(z):
        """1 <= z < 1.5."""
        return (
            -4.0 * z**5 / 11.0
            + 16.0 * z**4 / 11.0
            - 10.0 * z**3 / 11.0
            - 100.0 * z**2 / 33.0
            + 5.0 * z
            - 61.0 / 22.0
            + 115.0 / (132.0 * z)
        )

    @staticmethod
    def _f4(z):
        """1.5 <= z < 2."""
        return (
            4.0 * z**5 / 33.0
            - 8.0 * z**4 / 11.0
            + 10.0 * z**3 / 11.0
            + 80.0 * z**2 / 33.0
            - 80.0 * z / 11.0
            + 64.0 / 11.0
            - 32.0 / (33.0 * z)
        )

    def taper_from_dist(self, dist: torch.Tensor) -> torch.Tensor:
        """GC(z, inf, c) polynomials on distances ``[..., n_dim, m]``; the
        per-dimension weights multiply (API parity with GaspariCohn)."""
        weights = torch.ones(dist.shape[:-2] + dist.shape[-1:],
                             dtype=dist.dtype, device=dist.device)
        for i in range(dist.shape[-2]):
            z = dist[..., i, :] / self.radius
            z_safe = torch.clamp(z, min=0.25)
            w = torch.where(z < 2.0, self._f4(z_safe), torch.zeros_like(z))
            w = torch.where(z < 1.5, self._f3(z_safe), w)
            w = torch.where(z < 1.0, self._f2(z_safe), w)
            w = torch.where(z < 0.5, self._f1(z), w)
            weights = weights * w
        return torch.where(weights > self.epsilon, weights,
                           torch.zeros_like(weights))

    def taper_weights(self, grid_coords: torch.Tensor,
                      obs_coords: torch.Tensor) -> torch.Tensor:
        """Weights ``[g, o]``; the distance is flattened to one dimension."""
        dist = torch.vmap(
            lambda gc: self.dist_func(gc, obs_coords).reshape(-1)
        )(grid_coords)
        return self.taper_from_dist(dist[:, None, :])


@functools.lru_cache(maxsize=None)
def taper_support_z(taper: str = "gc2", epsilon: float = 1e-5) -> float:
    """Normalized-distance support bound of the Gaspari-Cohn tapers with the
    sub-``epsilon`` cut applied: the largest ``z = dist / radius`` with
    ``w(z) > epsilon`` (host-side bisection in Python floats; both tapers
    decrease monotonically on [0, 2] and are zero beyond).

    The window kernel uses it for its support clamp and overflow guard: an
    observation can contribute to a column only if its normalized distance
    is below this bound. Memoized: the kernel wrapper asks on every call,
    and the 60-step bisection costs more host time than the launch.
    """
    if epsilon <= 0.0:
        return 2.0
    if taper == "gc2":
        def w(z):
            if z < 1.0:
                return float(GaspariCohn._f1(z))
            if z < 2.0:
                return float(GaspariCohn._f2(z))
            return 0.0
    elif taper == "gcinf":
        def w(z):
            if z < 0.5:
                return float(GaspariCohnInf._f1(z))
            if z < 1.0:
                return float(GaspariCohnInf._f2(z))
            if z < 1.5:
                return float(GaspariCohnInf._f3(z))
            if z < 2.0:
                return float(GaspariCohnInf._f4(z))
            return 0.0
    else:
        raise ValueError(f"unknown taper {taper!r}; use 'gc2' or 'gcinf'")
    if w(0.0) <= epsilon:
        return 0.0
    lo, hi = 0.0, 2.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if w(mid) > epsilon:
            lo = mid
        else:
            hi = mid
    # the upper end of the bracket: boundary-shell obs count as in-support
    return hi


def neighborhood_select(localization, grid_coords: torch.Tensor,
                        obs_coords: torch.Tensor, max_obs: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size obs neighborhoods: the ``max_obs`` largest-taper-weight
    observations of each grid column, ties to the lower index (as
    ``jax.lax.top_k``).

    Exact whenever no column has more than ``max_obs`` nonzero-weight
    observations: the rest carry weight 0 and add nothing to the weighted
    Gram products. Otherwise it truncates to the largest weights. With
    fewer than ``max_obs`` observations the neighborhoods are zero-padded
    (index 0, weight 0).

    Returns ``(idx [g, max_obs] int64, weights [g, max_obs])``.
    """
    weights = localization.taper_weights(grid_coords, obs_coords)  # [g, o]
    k = min(max_obs, weights.shape[-1])
    top_w, top_idx = torch.sort(weights, dim=-1, descending=True,
                                stable=True)
    top_w, top_idx = top_w[:, :k], top_idx[:, :k]
    if k < max_obs:
        pad = (0, max_obs - k)
        top_w = torch.nn.functional.pad(top_w, pad)
        top_idx = torch.nn.functional.pad(top_idx, pad)
    return top_idx, top_w


def neighborhood_select_window(localization, grid_coords: torch.Tensor,
                               obs_coords: torch.Tensor, max_obs: int,
                               coord_col: int = 1, strict: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size obs neighborhoods by sorted-coordinate window, the exact
    fast path for 1-D domains.

    The observations must be sorted along column ``coord_col`` of
    ``obs_coords``, and the taper monotone in ``|x - y|`` along it. Each
    column's window of ``max_obs`` observations is centred on the column's
    rank (``searchsorted``) among the observation coordinates. For a
    single-radius Gaspari-Cohn taper it is then clamped onto the column's
    in-support index range ``[low, high)``, and ``strict`` gives NaN weights
    to every column with more than ``max_obs`` in-support observations.
    Unsorted coordinates give NaN weights everywhere. With fewer than
    ``max_obs`` observations the neighborhoods are zero-padded.

    ``localization`` must expose ``taper_from_dist`` and ``dist_func``.

    Returns ``(idx [g, max_obs] int64, weights [g, max_obs])``.
    """
    obs_x = obs_coords[:, coord_col].contiguous()
    grid_x = grid_coords[:, coord_col].contiguous()
    n_obs = obs_x.shape[0]
    nb = min(max_obs, n_obs)
    sorted_ok = (torch.all(obs_x[1:] >= obs_x[:-1]) if n_obs > 1
                 else torch.ones((), dtype=torch.bool, device=obs_x.device))
    center = torch.searchsorted(obs_x, grid_x)
    start = torch.clamp(center - nb // 2, 0, n_obs - nb)
    overflow = torch.zeros_like(grid_x)
    radius = np.atleast_1d(np.asarray(getattr(localization, "radius", np.nan),
                                      dtype=float))
    if (isinstance(localization, (GaspariCohn, GaspariCohnInf))
            and radius.size == 1 and nb < n_obs):
        taper = "gcinf" if isinstance(localization, GaspariCohnInf) else "gc2"
        # rounded once, as f32(z* r) and not f32(z*) f32(r); a 0-d CPU
        # tensor, so that no copy to the device syncs the host
        sup = torch.tensor(
            taper_support_z(taper, localization.epsilon) * radius[0],
            dtype=obs_x.dtype)
        low = torch.searchsorted(obs_x, grid_x - sup, right=True)
        high = torch.searchsorted(obs_x, grid_x + sup)
        # jnp.clip order: the upper bound wins where low < high - nb
        start = torch.minimum(torch.maximum(center - nb // 2, high - nb), low)
        start = torch.clamp(start, 0, n_obs - nb)
        if strict:
            overflow = torch.where(high - low > nb, torch.nan, 0.0).to(
                grid_x.dtype)
    idx = start[:, None] + torch.arange(nb, device=start.device)[None, :]
    dist = torch.vmap(
        lambda gc, oi: torch.atleast_2d(localization.dist_func(gc, oi))
    )(grid_coords, obs_coords[idx])                      # [g, n_dim, nb]
    weights = localization.taper_from_dist(dist)         # [g, nb]
    weights = weights + torch.where(sorted_ok, 0.0, torch.nan).to(
        weights.dtype)
    weights = weights + overflow[:, None].to(weights.dtype)
    if nb < max_obs:
        pad = (0, max_obs - nb)
        weights = torch.nn.functional.pad(weights, pad)
        idx = torch.nn.functional.pad(idx, pad)
    return idx, weights


def select_neighborhoods(localization, grid_coords: torch.Tensor,
                         obs_coords: torch.Tensor, max_obs: int,
                         selection: str = "topk", strict: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The neighborhoods of :func:`neighborhood_select` (``selection=
    "topk"``) or of :func:`neighborhood_select_window` (``"window"``, with
    ``strict``)."""
    if selection == "window":
        return neighborhood_select_window(localization, grid_coords,
                                          obs_coords, max_obs, strict=strict)
    if selection == "topk":
        return neighborhood_select(localization, grid_coords, obs_coords,
                                   max_obs)
    raise ValueError(f"selection must be 'topk' or 'window'; got "
                     f"{selection!r}")
