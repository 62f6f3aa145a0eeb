"""
The port's obs-sharded halo LETKF (tpu_assim_torch.parallel.halo) against
the JAX package on the same numpy inputs: JAX on its 8-device CPU mesh, the
port on 8 virtual CPU shards (``make_grid_mesh(8, devices=["cpu"] * 8)``).

- Host side: ``shard_observations``/``_2d``, ``halo_width_for``, the
  in-support counts and the auto degree equal JAX's.
- The top-k analyses in f64 within 1e-10: eigh against JAX's halo analysis
  and the port's dense ``make_letkf_analysis``; newton and woodbury against
  the dense analysis (JAX's halo analysis fails to trace them: its
  Newton-Schulz loop carry trips shard_map's varying-axes check); on the
  named axis of a 2-axis mesh; with correlated R; in 2-D.
- The kernel routes, in f32 against JAX's kernels in interpret mode,
  within 1e-5 of max|ref| with identical NaN entries (the tolerance of
  tests/test_torch_window1d.py, test_torch_nbh.py and
  test_torch_window2d.py for these kernels): ``local_method="window"``
  (K1), ``use_pallas`` (K4) and the 2-D window (K6); on the CPU each
  wrapper runs its plain version.
- ``comm="rdma"`` equals ``"ppermute"`` exactly; the errors, the precheck
  and the auto degree behave as in JAX; the 2-D probe warns on a radial
  distance (JAX's probe passes it).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import tpu_assim.ops.pallas.letkf as jpk
from tpu_assim.analysis import make_letkf_analysis as jax_analysis
from tpu_assim.ops.localization import GaspariCohn as JGaspariCohn
from tpu_assim.parallel import halo as jh
from tpu_assim.parallel.mesh import make_grid_mesh as jax_grid_mesh

from tpu_assim_torch import convert
from tpu_assim_torch.analysis import make_letkf_analysis
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.parallel import halo as th
from tpu_assim_torch.parallel import make_grid_mesh
from tpu_assim_torch.parallel.mesh import Mesh

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
KERNEL_TOL = 1e-5   # f32 kernels against JAX's, relative to max|ref|
CPU8 = ["cpu"] * 8


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def rel_close(port, ref, tol=KERNEL_TOL):
    """Within ``tol`` of max|ref| on the finite entries; NaN entries
    identical."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    fin = ~np.isnan(ref)
    err = np.abs(port[fin] - ref[fin]).max()
    assert err <= tol * np.abs(ref[fin]).max(), err


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def jax_dist2d(gc, oi):
    return jnp.abs(oi[:, 1:3] - gc[1:3][None, :]).T


def dist2d(gc, oi):
    return torch.abs(oi[:, 1:3] - gc[1:3][None, :]).T


def workload(rng, ens=10, n_grid=128, n_obs=48, dtype=np.float64):
    """tests/test_halo.py's workload: random obs columns, so the shards'
    obs counts differ and pad slots ride through the exchange."""
    state = rng.normal(size=(ens, n_grid))
    obs_idx = np.sort(rng.choice(n_grid, size=n_obs, replace=False))
    obs_vals = rng.normal(size=n_obs)
    obs_var = rng.uniform(0.3, 1.5, size=n_obs)
    grid_coords = np.arange(n_grid, dtype=np.float64)[:, None]
    obs_coords = grid_coords[obs_idx]
    cast = (lambda a: a.astype(dtype))
    return (cast(state), cast(obs_vals), cast(obs_var), obs_idx,
            cast(grid_coords), cast(obs_coords))


def sharded_args(w, n=8):
    """The halo analysis's arguments: state, the sharded obs arrays, grid
    coordinates."""
    state, vals, var, idx, grid, obs = w
    sh = th.shard_observations(vals, var, idx, obs, state.shape[1], n)
    return (state,) + sh[:5] + (grid,)


def run_both(jl, args, jax_mesh=None, port_mesh=None, **kw):
    """JAX's and the port's halo analysis on the same arguments."""
    ref = jh.halo_letkf_analysis(jax_mesh or jax_grid_mesh(8), jl, **kw)(
        *map(jnp.asarray, args))
    out = th.halo_letkf_analysis(
        port_mesh or make_grid_mesh(8, devices=CPU8),
        convert.from_tpu_assim(jl), **kw)(*map(torch.as_tensor, args))
    return out.numpy(), np.asarray(ref)


def dense(jl, w, method="eigh", **kw):
    return make_letkf_analysis(convert.from_tpu_assim(jl), 1.1,
                               method=method, **kw)(
        *map(torch.as_tensor, w)).numpy()


@pytest.fixture
def cheb_interpret(monkeypatch):
    """JAX's K4 in interpret mode (no TPU here), as tests/test_halo.py."""
    orig = jpk.letkf_nbh_analysis_cheb

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jpk, "letkf_nbh_analysis_cheb", interp)


# -- host side ----------------------------------------------------------------

@pytest.mark.parametrize("correlated", [False, True])
def test_shard_observations_equal_jax(rng, correlated):
    _, vals, var, idx, _, obs = workload(rng)
    if correlated:
        var = np.diag(var)
        var[0, 1] = var[1, 0] = 0.1      # obs 0 and 1 share a shard
    for a, b in zip(th.shard_observations(vals, var, idx, obs, 128, 8),
                    jh.shard_observations(vals, var, idx, obs, 128, 8)):
        np.testing.assert_array_equal(a, b)


def test_cross_shard_correlation_rejected(rng):
    cov = np.eye(8)
    cov[0, -1] = cov[-1, 0] = 0.5
    with pytest.raises(ValueError, match="block-diagonal"):
        th.shard_observations(rng.normal(size=8), cov, np.arange(0, 32, 4),
                              np.arange(8.0)[:, None], 32, 4)
    with pytest.raises(ValueError, match="evenly"):
        th.shard_observations(rng.normal(size=8), np.ones(8),
                              np.arange(0, 32, 4), np.arange(8.0)[:, None],
                              30, 4)


def workload_2d(rng, ens=8, n_rows=16, n_cols=24, n_obs=60, dtype=np.float64):
    """tests/test_halo.py's 2-D workload, grid coordinates (row, col)."""
    state = rng.normal(size=(ens, n_rows, n_cols))
    flat = rng.choice(n_rows * n_cols, size=n_obs, replace=False)
    obs_ij = np.stack([flat // n_cols, flat % n_cols], 1).astype(np.int32)
    obs_vals = rng.normal(size=n_obs)
    obs_var = rng.uniform(0.4, 1.2, size=n_obs)
    rr, cc = np.meshgrid(np.arange(n_rows, dtype=float),
                         np.arange(n_cols, dtype=float), indexing="ij")
    grid = np.stack([rr, cc], axis=-1)
    obs = grid[obs_ij[:, 0], obs_ij[:, 1]]
    cast = (lambda a: a.astype(dtype))
    return (cast(state), cast(obs_vals), cast(obs_var), obs_ij, cast(grid),
            cast(obs))


def test_shard_observations_2d_equal_jax(rng):
    _, vals, var, ij, _, obs = workload_2d(rng)
    out = th.shard_observations_2d(vals, var, ij, obs, (16, 24), (2, 4))
    ref = jh.shard_observations_2d(vals, var, ij, obs, (16, 24), (2, 4))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="evenly"):
        th.shard_observations_2d(vals, var, ij, obs, (16, 24), (3, 4))


def test_halo_width_for():
    for radius, span in ((4.0, 16.0), (20.0, 16.0), (7.0, 16.0), (1.0, 1.0)):
        assert th.halo_width_for(radius, span) == jh.halo_width_for(radius,
                                                                     span)


def stacked_workload(rng, n_grid=64, n_base=10, stack=8):
    """tests/test_halo.py's smoother-style workload: every observation
    repeated ``stack`` times at one coordinate with small variance, so the
    spectral bound needs a high degree."""
    state = rng.normal(size=(10, n_grid))
    base = np.sort(rng.choice(n_grid, size=n_base, replace=False))
    obs_idx = np.repeat(base, stack)
    grid = np.arange(n_grid, dtype=np.float64)[:, None]
    return (state, rng.normal(size=n_base * stack),
            np.full(n_base * stack, 0.3), obs_idx, grid, grid[obs_idx])


@pytest.mark.parametrize("consecutive", [True, False])
def test_auto_degree_and_support_equal_jax(rng, consecutive):
    w = stacked_workload(rng)
    args = sharded_args(w, 4)
    state, _, var, lidx, coords, valid = (th._numpy(a) for a in args[:6])
    gl, p = state.shape[1] // 4, lidx.shape[0] // 4
    znorm = np.concatenate([th._halo_znorm(
        state[:, s * gl:(s + 1) * gl], var[s * p:(s + 1) * p],
        lidx[s * p:(s + 1) * p], valid[s * p:(s + 1) * p], 1)
        for s in range(4)])
    out = th._degree_from_znorm(znorm, coords[:, 0], valid, state.shape[0],
                                96, 1.1, consecutive)
    ref = jh._halo_auto_degree(*args[:6], 4, 96, 1.1, consecutive)
    assert out == ref and out > 16
    for radius in (2.0, 6.0):
        assert th._halo_max_in_support(args[4], args[5], 4, radius, "gc2",
                                       1e-5, 2) == \
            jh._halo_max_in_support(args[4], args[5], 4, radius, "gc2", 1e-5,
                                    2)


# -- the top-k analyses in f64 ------------------------------------------------

@pytest.mark.parametrize("radius", [4.0, 7.0])
def test_topk_eigh_matches_jax_and_dense(rng, radius):
    w = workload(rng)
    jl = JGaspariCohn((radius,), jax_coord1)
    h = th.halo_width_for(radius, 128 / 8)
    out, ref = run_both(jl, sharded_args(w), max_obs=32, halo_width=h,
                        inf_factor=1.1)
    assert out.dtype == np.float64
    close(out, ref)
    close(out, dense(jl, w))


@pytest.mark.parametrize("method", ["newton", "woodbury"])
def test_topk_newton_woodbury_match_dense(rng, method):
    w = workload(rng)
    jl = JGaspariCohn((4.0,), jax_coord1)
    out = th.halo_letkf_analysis(
        make_grid_mesh(8, devices=CPU8), convert.from_tpu_assim(jl),
        max_obs=32, halo_width=1, inf_factor=1.1, method=method)(
        *map(torch.as_tensor, sharded_args(w)))
    ref = jax_analysis(jl, 1.1, method=method, max_obs=32)(
        *map(jnp.asarray, w))
    close(out, ref)
    close(out, dense(jl, w, method=method, max_obs=32))


def test_named_axis_of_a_2_axis_mesh(rng):
    """A 2-axis mesh shards over ``axis_name``'s extent (4), not over all 8
    positions."""
    w = workload(rng)
    jl = JGaspariCohn((4.0,), jax_coord1)
    jax_mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                     ("grid", "aux"))
    port_mesh = Mesh(np.asarray(CPU8, dtype=object).reshape(4, 2),
                     ("grid", "aux"))
    out, ref = run_both(jl, sharded_args(w, 4), jax_mesh, port_mesh,
                        max_obs=32, halo_width=th.halo_width_for(4.0, 32.0),
                        inf_factor=1.1)
    close(out, ref)
    close(out, dense(jl, w))


def test_correlated_r_matches_jax_and_dense(rng):
    """Block-diagonal correlated R, whitened per shard by its Cholesky
    factor (tests/test_halo.py:527-570)."""
    n, ens, radius = 8, 10, 6.0
    g, o = 64 * n, 8 * n
    state = rng.normal(size=(ens, g))
    obs_idx = np.concatenate([
        np.sort(rng.choice(63, size=8, replace=False)) + s * 64
        for s in range(n)])
    cov = np.eye(o)
    for s in range(n):
        a = rng.randn(8, 8) * 0.2
        cov[s * 8:(s + 1) * 8, s * 8:(s + 1) * 8] += a @ a.T
    grid = np.arange(g, dtype=np.float64)[:, None]
    w = (state, rng.normal(size=o), cov, obs_idx.astype(np.int32), grid,
         grid[obs_idx])
    args = sharded_args(w)
    assert args[2].ndim == 2
    jl = JGaspariCohn((radius,), jax_coord1)
    out, ref = run_both(jl, args, max_obs=16,
                        halo_width=th.halo_width_for(radius, g / n),
                        inf_factor=1.1)
    close(out, ref)
    close(out, dense(jl, w))


def test_rdma_equals_ppermute_and_wider_halo(rng):
    w = workload(rng)
    jl = JGaspariCohn((4.0,), jax_coord1)
    args = [torch.as_tensor(a) for a in sharded_args(w)]
    mesh = make_grid_mesh(8, devices=CPU8)
    loc = convert.from_tpu_assim(jl)
    base = th.halo_letkf_analysis(mesh, loc, max_obs=12, halo_width=1,
                                  inf_factor=1.1)(*args)
    rdma = th.halo_letkf_analysis(mesh, loc, max_obs=12, halo_width=1,
                                  inf_factor=1.1, comm="rdma")(*args)
    assert torch.equal(rdma, base)
    ref = jh.halo_letkf_analysis(jax_grid_mesh(8), jl, max_obs=12,
                                 halo_width=1, inf_factor=1.1, comm="rdma")(
        *map(jnp.asarray, sharded_args(w)))
    close(rdma, ref)
    wide = th.halo_letkf_analysis(mesh, loc, max_obs=32, halo_width=2,
                                  inf_factor=1.1)(*args)
    close(wide, th.halo_letkf_analysis(mesh, loc, max_obs=32, halo_width=1,
                                       inf_factor=1.1)(*args))


def test_topk_2d_matches_jax_and_dense(rng):
    w = workload_2d(rng)
    state, vals, var, ij, grid, obs = w
    jl = JGaspariCohn((3.0,), jax_dist2d)
    sh = th.shard_observations_2d(vals, var, ij, obs, (16, 24), (2, 4))
    args = (state,) + sh[:5] + (grid,)
    jax_mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                     ("row", "col"))
    port_mesh = Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4),
                     ("row", "col"))
    kw = dict(max_obs=32, grid_shape=(16, 24), halo=(1, 1), inf_factor=1.1)
    ref = jh.halo_letkf_analysis_2d(jax_mesh, jl, **kw)(
        *map(jnp.asarray, args))
    loc = GaspariCohn((3.0,), dist2d)
    out = th.halo_letkf_analysis_2d(port_mesh, loc, **kw)(
        *map(torch.as_tensor, args))
    assert out.shape == (8, 16, 24)
    close(out, ref)
    flat = (ij[:, 0] * 24 + ij[:, 1]).astype(np.int32)
    ref_dense = make_letkf_analysis(loc, 1.1)(
        *map(torch.as_tensor, (state.reshape(8, -1), vals, var, flat,
                               grid.reshape(-1, 2), obs)))
    close(out.reshape(8, -1), ref_dense)
    newton = th.halo_letkf_analysis_2d(port_mesh, loc, method="newton",
                                       **kw)(*map(torch.as_tensor, args))
    close(newton.reshape(8, -1), make_letkf_analysis(loc, 1.1,
                                                     method="newton")(
        *map(torch.as_tensor, (state.reshape(8, -1), vals, var, flat,
                               grid.reshape(-1, 2), obs))))


# -- the kernel routes, f32 ---------------------------------------------------

def test_window_route_k1_matches_jax(rng):
    w = workload(rng, dtype=np.float32)
    jl = JGaspariCohn((4.0,), jax_coord1)
    out, ref = run_both(jl, sharded_args(w), max_obs=32, halo_width=1,
                        inf_factor=1.1, local_method="window")
    assert out.dtype == np.float32
    rel_close(out, ref)


def test_pallas_route_k4_matches_jax(rng, cheb_interpret):
    w = workload(rng, dtype=np.float32)
    jl = JGaspariCohn((4.0,), jax_coord1)
    out, ref = run_both(jl, sharded_args(w), max_obs=32, halo_width=1,
                        inf_factor=1.1, use_pallas=True, comm="rdma")
    rel_close(out, ref)


@pytest.mark.parametrize("route", ["window", "pallas"])
def test_2d_kernel_routes_match_jax(rng, cheb_interpret, route):
    """K6 (``local_method="window"``, the obs block bound of all 9
    neighbourhood blocks) and K4 (``use_pallas``) per tile."""
    state, vals, var, ij, grid, obs = workload_2d(rng, dtype=np.float32)
    sh = th.shard_observations_2d(vals, var, ij, obs, (16, 24), (2, 4))
    args = (state,) + sh[:5] + (grid,)
    kw = dict(max_obs=40, grid_shape=(16, 24), halo=(1, 1), inf_factor=1.1)
    if route == "window":
        kw.update(local_method="window", obs_block=-(-9 * sh[5] // 8) * 8)
    else:
        kw.update(use_pallas=True)
    ref = jh.halo_letkf_analysis_2d(
        JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("row", "col")),
        JGaspariCohn((3.0,), jax_dist2d), **kw)(*map(jnp.asarray, args))
    out = th.halo_letkf_analysis_2d(
        Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4), ("row", "col")),
        GaspariCohn((3.0,), dist2d), **kw)(*map(torch.as_tensor, args))
    assert out.dtype == torch.float32
    rel_close(out, ref)


# -- the precheck, the auto degree and the errors -----------------------------

def test_auto_degree_beats_pinned_16(rng):
    """On the stacked workload the auto degree matches the f64 dense
    analysis where a pinned degree of 16 truncates (tests/test_halo.py's
    case, the port's side)."""
    w = stacked_workload(rng)
    jl = JGaspariCohn((6.0,), jax_coord1)
    expected = dense(jl, w)
    args = [torch.as_tensor(a) for a in sharded_args(w, 4)]
    mesh = make_grid_mesh(4, devices=CPU8[:4])
    loc = convert.from_tpu_assim(jl)
    h = th.halo_width_for(6.0, 64 / 4)
    scale = np.abs(expected).max()
    auto = th.halo_letkf_analysis(mesh, loc, max_obs=96, halo_width=h,
                                  inf_factor=1.1, local_method="window")(*args)
    pinned = th.halo_letkf_analysis(mesh, loc, max_obs=96, halo_width=h,
                                    inf_factor=1.1, local_method="window",
                                    cheb_degree=16)(*args)
    err_auto = np.abs(auto.numpy() - expected).max() / scale
    err_pinned = np.abs(pinned.numpy() - expected).max() / scale
    assert err_auto < 1e-4 and err_pinned > max(100 * err_auto, 1e-3)


def test_precheck_raises_on_slot_exhaustion(rng):
    w = stacked_workload(rng)
    args = [torch.as_tensor(a) for a in sharded_args(w, 4)]
    loc = convert.from_tpu_assim(JGaspariCohn((6.0,), jax_coord1))
    analyse = th.halo_letkf_analysis(make_grid_mesh(4, devices=CPU8[:4]),
                                     loc, max_obs=8, halo_width=2,
                                     inf_factor=1.1, local_method="window")
    with pytest.raises(ValueError, match="in-support"):
        analyse(*args)


def test_precheck_2d_raises(rng):
    state, vals, var, ij, grid, obs = workload_2d(rng, dtype=np.float32)
    sh = th.shard_observations_2d(vals, var, ij, obs, (16, 24), (2, 4))
    analyse = th.halo_letkf_analysis_2d(
        Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4), ("row", "col")),
        GaspariCohn((3.0,), dist2d), max_obs=2, grid_shape=(16, 24),
        local_method="window", obs_block=64)
    with pytest.raises(ValueError, match="in-support band"):
        analyse(*map(torch.as_tensor, (state,) + sh[:5] + (grid,)))


def test_build_errors():
    loc = convert.from_tpu_assim(JGaspariCohn((4.0,), jax_coord1))
    mesh = make_grid_mesh(8, devices=CPU8)
    with pytest.raises(ValueError, match="single localization"):
        th.halo_letkf_analysis(mesh, GaspariCohn((4.0, 5.0), dist2d),
                               max_obs=8, local_method="window")
    with pytest.raises(ValueError, match="axis_name"):
        th.halo_letkf_analysis(mesh, loc, max_obs=8, axis_name="nope")
    with pytest.raises(ValueError, match="local_method"):
        th.halo_letkf_analysis(mesh, loc, max_obs=8, local_method="nearest")
    with pytest.raises(ValueError, match="comm"):
        th.halo_letkf_analysis(mesh, loc, max_obs=8, comm="nccl")
    with pytest.raises(TypeError, match="Gaspari-Cohn"):
        th.halo_letkf_analysis(mesh, object(), max_obs=8,
                               local_method="window")
    mesh2 = Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4),
                 ("row", "col"))
    with pytest.raises(ValueError, match="obs_block"):
        th.halo_letkf_analysis_2d(mesh2, loc, max_obs=8,
                                  grid_shape=(16, 24), local_method="window")
    with pytest.raises(ValueError, match="axis"):
        th.halo_letkf_analysis_2d(mesh, loc, max_obs=8, grid_shape=(16, 24))


# -- the distance probe -------------------------------------------------------

def radial(gc, oi):
    return torch.sqrt(torch.sum((oi[:, 1:3] - gc[1:3][None, :]) ** 2,
                                dim=1))[None, :]


@pytest.mark.parametrize("case,plain", [
    ("1-D", True), ("2-D", True), ("periodic", False), ("scaled", False),
    ("radial 2-D", False), ("raises", False)])
def test_dist_probe(case, plain):
    locs = {
        "1-D": (GaspariCohn((4.0,), convert.coord1_distance), 1),
        "2-D": (GaspariCohn((4.0, 3.0), dist2d), 2),
        "periodic": (GaspariCohn((4.0,), lambda gc, oi: torch.minimum(
            torch.abs(oi[:, 1] - gc[1]), 40.0 - torch.abs(
                oi[:, 1] - gc[1]))[None, :]), 1),
        "scaled": (GaspariCohn((4.0,), lambda gc, oi: 2.0 * torch.abs(
            oi[:, 1] - gc[1])[None, :]), 1),
        "radial 2-D": (GaspariCohn((4.0, 3.0), radial), 2),
        "raises": (GaspariCohn((4.0,), lambda gc, oi: oi[:, 7]), 1),
    }
    loc, n_dim = locs[case]
    assert th._plain_abs_dist_probe(loc, n_dim) is plain


def test_jax_probe_misses_the_radial_distance():
    """The defect the port does not copy: JAX's probe moves one axis at a
    time, so a radial 2-D distance passes it."""
    def jax_radial(gc, oi):
        return jnp.sqrt(jnp.sum((oi[:, 1:3] - gc[1:3][None, :]) ** 2,
                                axis=1))[None, :]

    assert jh._plain_abs_dist_probe(JGaspariCohn((4.0, 3.0), jax_radial), 2)


@pytest.mark.parametrize("dist,warns", [(dist2d, False), (radial, True)])
def test_window_build_warns_only_for_non_plain(caplog, dist, warns):
    mesh2 = Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4),
                 ("row", "col"))
    with caplog.at_level(logging.WARNING,
                         logger="tpu_assim_torch.parallel.halo"):
        th.halo_letkf_analysis_2d(mesh2, GaspariCohn((4.0, 3.0), dist),
                                  max_obs=8, grid_shape=(16, 24),
                                  local_method="window", obs_block=16)
    assert any("dist_fn" in r.message for r in caplog.records) is warns
