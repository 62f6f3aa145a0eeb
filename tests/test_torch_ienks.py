"""
The port's neighborhood selections, eigh analysis over neighborhoods
(``max_obs``), IEnKS inner steps and localized IEnKS smoother against the
JAX package on the same numpy inputs:

- ``neighborhood_select`` and ``neighborhood_select_window``: identical
  indices, weights within 1e-12 in f64;
- ``ienks_transform_step``, ``ienks_bundle_step``,
  ``make_letkf_analysis(method="eigh", max_obs=...)`` and
  ``make_lienks_step``: within 1e-10 in f64 (both sides take LAPACK's SVD
  and eigh, and the port integrates with the integrator's own steps where
  the JAX package runs its interpret-mode RK4 kernel);
- the Jacobi route in f32: with the gate opened to CPU tensors the port's
  SVD and eigh run the plain version of kernel K3, against the JAX package
  in f32 (LAPACK) within 1e-5 of max|ref|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim import analysis as JA
from tpu_assim.models import Lorenz96 as JLorenz96
from tpu_assim.models import RK4Integrator as JRK4
from tpu_assim.ops import ienks as jienks
from tpu_assim.ops import localization as jloc
from tpu_assim.ops.pallas.letkf import max_in_support_1d

from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.models import cuda_forecast
from tpu_assim_torch.ops import ienks as tienks
from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops import localization as tloc
from tpu_assim_torch.ops.cuda import svd as k3

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
RADIUS = 4.0


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def rel_close(port, ref, tol=1e-5):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def workload(rng, k=10, g=64, o=16, dtype=np.float64):
    """L96-sized ensemble with point observations at sorted grid points."""
    obs_idx = np.sort(rng.choice(g, size=o, replace=False)).astype(np.int32)
    return (
        (rng.normal(size=(k, g)) + 2.0).astype(dtype),     # state
        rng.normal(size=o).astype(dtype) + 2.0,            # obs_vals
        np.full(o, 0.5, dtype),                            # obs_var
        obs_idx,
        np.arange(g, dtype=dtype)[:, None],                # grid_coords
        obs_idx.astype(dtype)[:, None],                    # obs_coords
    )


def both(w):
    return ([jnp.asarray(a) for a in w],
            list(convert.arrays_to_torch(w, "cpu")))


def jax_localization(taper):
    if taper == "gcinf":
        return jloc.GaspariCohnInf(RADIUS, jax_coord1)
    return jloc.GaspariCohn((RADIUS,), jax_coord1)


def info_rows(rng, g, o, sort=True):
    """Localization info rows (time column, then one coordinate)."""
    grid = np.stack([np.zeros(g), np.arange(g, dtype=float)], axis=1)
    x = rng.uniform(0, g, size=o)
    x = np.sort(x) if sort else x
    return grid, np.stack([np.zeros(o), x], axis=1)


# -- the selections -----------------------------------------------------------

@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
@pytest.mark.parametrize("o,max_obs", [(40, 12), (5, 8)])
def test_neighborhood_select_topk(rng, taper, o, max_obs):
    """Top-k of the taper weights, ties (the zero weights) to the lower
    index as jax.lax.top_k; zero-padded when o < max_obs."""
    grid, obs = info_rows(rng, 50, o)
    jl = jax_localization(taper)
    idx_j, w_j = jloc.neighborhood_select(jl, jnp.asarray(grid),
                                          jnp.asarray(obs), max_obs)
    idx_t, w_t = tloc.neighborhood_select(convert.from_tpu_assim(jl),
                                          torch.from_numpy(grid),
                                          torch.from_numpy(obs), max_obs)
    assert idx_t.shape == (50, max_obs)
    np.testing.assert_array_equal(idx_t, idx_j)
    close(w_t, w_j, 1e-12)
    assert (w_t == 0).any()


@pytest.mark.parametrize("case", ["exact", "gcinf", "strict overflow",
                                  "truncate", "padding", "unsorted"])
def test_neighborhood_select_window(rng, case):
    """The rank-centred window clamped onto the in-support range: identical
    indices and weights within 1e-12; NaN weights on strict overflow
    columns and everywhere for unsorted observations."""
    o = 5 if case == "padding" else 40
    grid, obs = info_rows(rng, 80, o, sort=case != "unsorted")
    taper = "gcinf" if case == "gcinf" else "gc2"
    jl = jax_localization(taper)
    worst = max_in_support_1d(np.sort(obs[:, 1]), grid[:, 1], RADIUS, taper)
    # two slots short of the in-support maximum overflows some columns
    max_obs = worst - 2 if case in ("strict overflow", "truncate") else 12
    strict = case != "truncate"
    idx_j, w_j = jloc.neighborhood_select_window(
        jl, jnp.asarray(grid), jnp.asarray(obs), max_obs, strict=strict)
    idx_t, w_t = tloc.neighborhood_select_window(
        convert.from_tpu_assim(jl), torch.from_numpy(grid),
        torch.from_numpy(obs), max_obs, strict=strict)
    nan_t, nan_j = torch.isnan(w_t).numpy(), np.isnan(np.asarray(w_j))
    np.testing.assert_array_equal(nan_t, nan_j)
    if case == "unsorted":
        assert nan_t.all()
        return
    np.testing.assert_array_equal(idx_t, idx_j)
    close(np.where(nan_t, 0.0, w_t), np.where(nan_j, 0.0, w_j), 1e-12)
    if case == "strict overflow":
        assert 0 < nan_t.all(axis=1).sum() < 80
    else:
        assert not nan_t.any()


# -- the IEnKS inner steps ----------------------------------------------------

def ienks_inputs(rng, batch, k=6, n_obs=9):
    weights = np.eye(k) + 0.2 * rng.normal(size=batch + (k, k))
    perts = rng.normal(size=batch + (k, n_obs))
    obs = rng.normal(size=batch + (1, n_obs))
    return weights, perts, obs


@pytest.mark.parametrize("kind", ["transform", "bundle"])
@pytest.mark.parametrize("batch,tau", [((), 1.0), ((5,), 0.6), ((2, 3), 0.3)])
def test_ienks_steps_match_jax(rng, kind, batch, tau):
    args = ienks_inputs(rng, batch)
    port = getattr(tienks, f"ienks_{kind}_step")
    ref = getattr(jienks, f"ienks_{kind}_step")
    out = port(*(torch.from_numpy(a) for a in args), tau)
    close(out, ref(*(jnp.asarray(a) for a in args), tau))


@pytest.mark.parametrize("kind", ["transform", "bundle"])
def test_ienks_step_without_obs_passes_weights_through(rng, kind):
    weights, _, _ = ienks_inputs(rng, (3,))
    step = getattr(tienks, f"ienks_{kind}_step")
    out = step(torch.from_numpy(weights), torch.zeros(3, 6, 0),
               torch.zeros(3, 1, 0), 0.5)
    assert torch.equal(out, torch.from_numpy(weights))


# -- eigh over neighborhoods --------------------------------------------------

@pytest.mark.parametrize("selection,chunksize,taper", [
    ("window", None, "gc2"), ("topk", None, "gc2"), ("window", 23, "gcinf"),
    ("topk", 23, "gcinf")])
def test_eigh_max_obs_analysis_matches_jax(rng, selection, chunksize, taper):
    w = workload(rng)
    wj, wt = both(w)
    jl = jax_localization(taper)
    opts = dict(method="eigh", max_obs=8, selection=selection)
    ref = JA.make_letkf_analysis(jl, 1.1, chunksize, **opts)(*wj)
    out = TA.make_letkf_analysis(convert.from_tpu_assim(jl), 1.1, chunksize,
                                 **opts)(*wt)
    close(out, ref)


def test_unknown_selection_raises():
    with pytest.raises(ValueError, match="selection"):
        TA.make_letkf_analysis(None, max_obs=4, selection="nearest")
    with pytest.raises(ValueError, match="selection"):
        TA.make_lienks_step(None, None, 0, selection="nearest")


# -- the localized IEnKS ------------------------------------------------------

@pytest.mark.parametrize("kind,integrate,max_obs,selection", [
    ("transform", False, 8, "window"),
    ("transform", True, 8, "window"),
    ("transform", True, 8, "topk"),
    ("transform", True, None, "window"),
    ("bundle", True, 8, "window"),
    ("bundle", False, None, "window"),
])
def test_lienks_matches_jax_f64(rng, kind, integrate, max_obs, selection):
    w = workload(rng)
    wj, wt = both(w)
    jl = jax_localization("gc2")
    integ = JRK4(JLorenz96(), 0.05) if integrate else None
    opts = dict(n_outer=2, kind=kind, tau=0.8, max_obs=max_obs,
                selection=selection)
    ref = JA.make_lienks_step(jl, integ, 3, **opts)(*wj)
    out = TA.make_lienks_step(
        convert.from_tpu_assim(jl),
        None if integ is None else convert.from_tpu_assim(integ), 3,
        **opts)(*wt)
    assert out.shape == (10, 64) and out.dtype == torch.float64
    close(out, ref)


@pytest.mark.parametrize("kind", ["transform", "bundle"])
@pytest.mark.parametrize("short", [2, 0])
def test_lienks_strict_window_overflow_is_nan(rng, monkeypatch, kind, short):
    """The strict window's poison reaches the smoother: with ``max_obs``
    ``short`` slots below the in-support maximum, exactly the overflowing
    columns are NaN (JAX, which scales by ``safe_sqrt``, returns the prior
    there: its columns are not compared), the others equal JAX's within
    1e-10, and no SVD sees a NaN; at the maximum no column is NaN."""
    w = workload(rng, k=8, g=80, o=40)
    radius = 5.0
    worst = max_in_support_1d(w[5][:, 0], w[4][:, 0], radius)
    nb = worst - short
    jl = jloc.GaspariCohn((radius,), jax_coord1)
    integ = JRK4(JLorenz96(), 0.05)
    opts = dict(n_outer=2, kind=kind, tau=0.8, max_obs=nb,
                selection="window")
    wj, wt = both(w)
    ref = np.asarray(JA.make_lienks_step(jl, integ, 3, **opts)(*wj))
    svd = torch.linalg.svd

    def finite_svd(a, *args, **kwargs):
        assert torch.isfinite(a).all(), "an SVD saw a NaN"
        return svd(a, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "svd", finite_svd)
    out = TA.make_lienks_step(convert.from_tpu_assim(jl),
                              convert.from_tpu_assim(integ), 3,
                              **opts)(*wt).numpy()
    _, w_nbh = tloc.neighborhood_select_window(
        convert.from_tpu_assim(jl), TA._with_time(wt[4]),
        TA._with_time(wt[5]), nb)
    overflow = torch.isnan(w_nbh).any(-1).numpy()
    nan_cols = np.isnan(out).any(axis=0)
    np.testing.assert_array_equal(nan_cols, overflow)
    assert np.isnan(out[:, nan_cols]).all()
    assert (0 < nan_cols.sum() < 80) if short else not nan_cols.any()
    close(out[:, ~nan_cols], ref[:, ~nan_cols])


def test_lienks_unlocalized_with_obs_operator_matches_jax_f64(rng):
    w = workload(rng, g=32, o=8)
    wj, wt = both(w)
    idx = w[3]
    opts = dict(n_outer=2, tau=1.0)
    ref = JA.make_lienks_step(None, None, 0,
                              obs_operator=lambda x: 0.5 * x[:, idx] ** 2,
                              **opts)(*wj)
    out = TA.make_lienks_step(None, None, 0,
                              obs_operator=lambda x: 0.5 * x[:, idx] ** 2,
                              **opts)(*wt)
    close(out, ref)


@pytest.fixture
def jacobi_on_cpu(monkeypatch):
    """Open the gate to CPU tensors and count the plain K3 calls."""
    monkeypatch.setattr(tl, "JACOBI_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.delenv("TPU_ASSIM_JACOBI", raising=False)
    monkeypatch.delenv("TPU_ASSIM_EIGH_KERNEL", raising=False)
    calls = []
    plain = k3.svd_jacobi_plain
    monkeypatch.setattr(k3, "svd_jacobi_plain",
                        lambda a, sweeps=20: calls.append(tuple(a.shape))
                        or plain(a, sweeps))
    return calls


def test_lienks_jacobi_route_f32_matches_jax(rng, jacobi_on_cpu):
    """The f32 smoother with its SVDs through the plain K3 (4 calls of
    [256, 10, 10]), against the JAX package's f32 step within 1e-5 of
    max|ref|; the forecast takes the RK4 kernel's plain version. The
    transform kind only: the bundle's precision ``Z Z^T / eps^2`` with
    eps = 1e-4 is too ill-conditioned for f32 (the JAX package's own f32
    bundle step is 5e-4 off its f64 one)."""
    w = workload(rng, g=256, o=64, dtype=np.float32)
    wj, wt = both(w)
    jl = jax_localization("gc2")
    integ = JRK4(JLorenz96(), 0.05)
    opts = dict(n_outer=2, tau=1.0, max_obs=8, selection="window")
    ref = JA.make_lienks_step(jl, integ, 4, **opts)(*wj)
    rk4 = dict(cuda_forecast.LAUNCHES)
    out = TA.make_lienks_step(convert.from_tpu_assim(jl),
                              convert.from_tpu_assim(integ), 4,
                              **opts)(*wt)
    assert jacobi_on_cpu == [(256, 10, 10)] * 4
    assert cuda_forecast.LAUNCHES == rk4
    assert out.dtype == torch.float32
    rel_close(out, ref)


def test_eigh_max_obs_jacobi_route_f32_matches_jax(rng, jacobi_on_cpu):
    """K3's second consumer: the f32 eigh analysis over neighborhoods, its
    [256, 10, 10] Grams through the plain K3, against JAX in f32."""
    w = workload(rng, g=256, o=64, dtype=np.float32)
    wj, wt = both(w)
    jl = jax_localization("gc2")
    opts = dict(method="eigh", max_obs=8, selection="window")
    ref = JA.make_letkf_analysis(jl, 1.1, **opts)(*wj)
    out = TA.make_letkf_analysis(convert.from_tpu_assim(jl), 1.1,
                                 **opts)(*wt)
    assert jacobi_on_cpu == [(256, 10, 10)]
    rel_close(out, ref)
