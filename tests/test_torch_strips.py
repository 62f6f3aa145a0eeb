"""
Parity of the port's x-strip 2-D LETKF (tpu_assim_torch.analysis:
``make_strip_letkf_2d``, ``_strip_plan_2d``, ``_strip_apply_2d``) and of
``LETKF(method="fused2d")`` against the JAX package on the same numpy
inputs:

- the strip plan's arrays: equal;
- the strip analysis against the JAX one (f32, 1e-5 of max|ref|) and the
  JAX f64 eigh oracle (5e-4); the strict overflow raises;
- ``LETKF(method="fused2d").assimilate``: auto strips engaged on a wide
  grid and not on a narrow one, pinned strips with a multi-slice state,
  the smoother, three coordinates, against the JAX class (1e-5) and exact
  eigh (5e-4);
- the class's host-side cache: a repeated call reuses the plan (no
  ``np.unique`` over the grid), a changed localization rebuilds it;
- the 2-D modules import with JAX blocked.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_assim as JT
from tpu_assim import analysis as JA
from tpu_assim.ops import localization as jloc

import tpu_assim_torch as TT
from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.ops.cuda import letkf as T

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def rel_close(port, ref, tol=1e-5):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def jax_dist2(gc, oi):
    return jnp.stack([jnp.abs(oi[:, 1] - gc[1]),
                      jnp.abs(oi[:, 2] - gc[2])], 0)


def port_dist2(gc, oi):
    return torch.stack([torch.abs(oi[:, 1] - gc[1]),
                        torch.abs(oi[:, 2] - gc[2])], 0)


def locs(radii):
    jl = jloc.GaspariCohn(radii, jax_dist2)
    return jl, convert.from_tpu_assim(jl, port_dist2)


def grid_2d(nr, nc):
    yy, xx = np.meshgrid(np.arange(nr, dtype="f8"), np.arange(nc, dtype="f8"),
                         indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], 1)


def strip_workload(rng, nr=32, nc=32, o=64, k=8):
    grid_xy = grid_2d(nr, nc)
    cells = np.sort(rng.choice(nr * nc, size=o, replace=False)).astype("i4")
    return (rng.randn(k, nr * nc), rng.randn(o), np.ones(o), cells, grid_xy,
            grid_xy[cells])


# -- the plan and the functional strips ----------------------------------------

@pytest.mark.parametrize("n_strips,max_obs", [(4, None), (3, 40), (4, 24)])
def test_strip_plan_equals_jax(rng, n_strips, max_obs):
    w = strip_workload(rng, nr=24, nc=40, o=90)
    jl, tl = locs((3.0, 2.5))
    ref = JA._strip_plan_2d(jl, w[4], w[5], n_strips, max_obs, False, 128)
    out = TA._strip_plan_2d(tl, w[4], w[5], n_strips, max_obs, False, 128)
    assert set(ref) <= set(out)
    for name, value in ref.items():
        if isinstance(value, np.ndarray):
            assert out[name].dtype == value.dtype, name
            np.testing.assert_array_equal(out[name], value, err_msg=name)
        else:
            assert out[name] == value, name


def test_strips_match_jax_and_eigh(rng):
    w = strip_workload(rng)
    state, obs_vals, obs_var, cells, grid_xy, obs_xy = w
    jl, tl = locs((3.0, 3.0))
    nb = max(8, T.max_in_support_2d(obs_xy, grid_xy, 3.0, 3.0)) + 8
    opts = dict(n_strips=4, inf_factor=1.1, max_obs=nb, cheb_degree=24)
    f32 = [a.astype("f4") for a in (state, obs_vals, obs_var)]
    ref = JA.make_strip_letkf_2d(jl, (cells, grid_xy, obs_xy), **opts)(
        *map(jnp.asarray, f32))
    before = dict(T.LAUNCHES)
    out = TA.make_strip_letkf_2d(tl, (cells, grid_xy, obs_xy), **opts)(
        *map(torch.from_numpy, f32))
    assert T.LAUNCHES == before            # CPU tensors: the plain version
    assert out.dtype == torch.float32 and out.shape == state.shape
    rel_close(out, ref)
    exact = JA.make_letkf_analysis(jl, 1.1, method="eigh")(
        *map(jnp.asarray, w))
    rel_close(out, exact, tol=5e-4)
    # auto window and a correlated R
    a = rng.randn(obs_vals.size, obs_vals.size) * 0.05
    cov = (a @ a.T + np.eye(obs_vals.size)).astype("f4")
    opts["max_obs"] = None
    ref = JA.make_strip_letkf_2d(jl, (cells, grid_xy, obs_xy), **opts)(
        jnp.asarray(f32[0]), jnp.asarray(f32[1]), jnp.asarray(cov))
    out = TA.make_strip_letkf_2d(tl, (cells, grid_xy, obs_xy), **opts)(
        torch.from_numpy(f32[0]), torch.from_numpy(f32[1]),
        torch.from_numpy(cov))
    rel_close(out, ref)


def test_strip_overflow_raises(rng):
    w = strip_workload(rng)
    for make, loc in ((JA.make_strip_letkf_2d, locs((3.0, 3.0))[0]),
                      (TA.make_strip_letkf_2d, locs((3.0, 3.0))[1])):
        with pytest.raises(ValueError, match="in-support"):
            make(loc, (w[3], w[4], w[5]), n_strips=4, inf_factor=1.1,
                 max_obs=2)


# -- the class API -------------------------------------------------------------

def class_pair(rng, nr, nc, n_obs, n_ens=8, n_var=1, n_time=1, nz=0):
    """A JAX and a port EnsembleState [n_var, n_time, n_ens, g] on a
    row-major grid (with nz levels: 3 coordinates) and their Observation of
    variable 0 at every time, from one index array."""
    grid = grid_2d(nr, nc)
    if nz:
        grid = np.concatenate([np.concatenate(
            [grid, np.full((len(grid), 1), z)], 1) for z in range(nz)])
    g = grid.shape[0]
    data = rng.randn(n_var, n_time, n_ens, g)
    kw = dict(times=np.arange(n_time, dtype="f8"), grid_coords=grid,
              var_names=("x", "y")[:n_var])
    js = JT.EnsembleState(jnp.asarray(data), **kw)
    ts = TT.EnsembleState(torch.from_numpy(data), **kw)
    idx = np.sort(rng.choice(g, size=n_obs, replace=False))
    truth = data[0].mean(axis=1)[:, idx]
    vals = truth + rng.normal(scale=0.5, size=truth.shape)
    okw = dict(obs_coords=grid[idx], times=np.arange(n_time, dtype="f8"))
    idx_t = torch.from_numpy(idx)
    jo = JT.Observation(jnp.asarray(vals), jnp.full((n_obs,), 0.5),
                        operator=lambda o, ps: ps.data[0][:, :, idx], **okw)
    to = TT.Observation(torch.from_numpy(vals),
                        torch.full((n_obs,), 0.5, dtype=torch.float64),
                        operator=lambda o, ps: ps.data[0][:, :, idx_t], **okw)
    return js, ts, jo, to


CLASS_CASES = {
    # auto: 520 distinct x -> 2 strips
    "auto strips": dict(shape=(8, 520, 160), max_obs=48, plan=True),
    "narrow, one kernel": dict(shape=(16, 16, 48), max_obs=48, plan=False),
    "pinned 1 strip": dict(shape=(8, 520, 160), max_obs=48, plan=False,
                           n_strips=1),
    "pinned 3 strips, multi-slice": dict(shape=(6, 96, 80), max_obs=64,
                                         plan=True, n_strips=3, n_var=2,
                                         n_time=2),
    "smoother": dict(shape=(12, 12, 36), max_obs=72, plan=False, n_var=2,
                     n_time=2, smoother=True, radii=(3.5,)),
}


@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_letkf_fused2d_matches_jax(rng, case):
    opts = dict(CLASS_CASES[case])
    nr, nc, n_obs = opts.pop("shape")
    plan = opts.pop("plan")
    jl, tl = locs(opts.pop("radii", (3.0, 3.0)))
    js, ts, jo, to = class_pair(rng, nr, nc, n_obs,
                                n_var=opts.pop("n_var", 1),
                                n_time=opts.pop("n_time", 1))
    kw = dict(inf_factor=1.1, chunksize=None, method="fused2d", **opts)
    ref = JT.LETKF(localization=jl, **kw).assimilate(js, jo)
    alg = TT.LETKF(localization=tl, **kw)
    out = alg.assimilate(ts, to)
    assert (alg._geometry_cache[1]["plan"] is not None) == plan
    assert out.dtype == torch.float64 and out.shape == tuple(ref.shape)
    rel_close(out.data, ref.data)
    kw["method"] = "eigh"
    exact = TT.LETKF(localization=tl, **kw).assimilate(ts, to)
    rel_close(out.data, exact.data, tol=5e-4)


def test_letkf_fused2d_three_coords(rng):
    def jax_dist3(gc, oi):
        return jnp.stack([jnp.abs(oi[:, j] - gc[j]) for j in (1, 2, 3)], 0)

    def port_dist3(gc, oi):
        return torch.stack([torch.abs(oi[:, j] - gc[j]) for j in (1, 2, 3)],
                           0)

    jl = jloc.GaspariCohn((2.5, 2.5, 1.5), jax_dist3)
    tl = convert.from_tpu_assim(jl, port_dist3)
    js, ts, jo, to = class_pair(rng, 8, 8, 48, nz=4)
    kw = dict(inf_factor=1.1, chunksize=None, max_obs=48, method="fused2d")
    ref = JT.LETKF(localization=jl, **kw).assimilate(js, jo)
    alg = TT.LETKF(localization=tl, **kw)
    out = alg.assimilate(ts, to)
    assert alg._geometry_cache[1]["n_dims"] == 3
    rel_close(out.data, ref.data)


def test_geometry_cache_key(rng, monkeypatch):
    js, ts, jo, to = class_pair(rng, 8, 520, 160)
    _, tl = locs((3.0, 3.0))
    alg = TT.LETKF(localization=tl, inf_factor=1.1, max_obs=48,
                   method="fused2d", chunksize=None, cheb_degree=16)
    first = alg.assimilate(ts, to)
    key, geometry = alg._geometry_cache
    calls = []
    unique = np.unique
    monkeypatch.setattr(np, "unique",
                        lambda *a, **k: calls.append(1) or unique(*a, **k))
    again = alg.assimilate(ts, to)
    assert alg._geometry_cache[1] is geometry and not calls
    np.testing.assert_array_equal(again.data.numpy(), first.data.numpy())
    # a changed localization (radius, then taper) builds a new plan
    alg.localization = convert.from_tpu_assim(
        jloc.GaspariCohn((2.5, 2.5), jax_dist2), port_dist2)
    alg.assimilate(ts, to)
    assert alg._geometry_cache[0] != key and calls
    assert alg._geometry_cache[1]["plan"]["rx"] == 2.5
    key = alg._geometry_cache[0]
    alg.localization = TT.interface.letkf.GaspariCohnInf(2.5, port_dist2)
    alg.assimilate(ts, to)
    assert alg._geometry_cache[0] != key
    assert alg._geometry_cache[1]["plan"]["taper"] == "gcinf"
    # equal coordinates in new tensors reuse it; moved ones rebuild it
    geometry = alg._geometry_cache[1]
    alg.assimilate(ts.replace(grid_coords=ts.grid_coords.clone()), to)
    assert alg._geometry_cache[1] is geometry
    alg.assimilate(ts.replace(grid_coords=ts.grid_coords.flip(0)), to)
    assert alg._geometry_cache[1] is not geometry


def test_fused2d_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["tpu_assim"] = None
        from tpu_assim_torch import analysis, LETKF
        from tpu_assim_torch.ops.cuda import letkf
        from tpu_assim_torch import _build
        assert callable(analysis.make_strip_letkf_2d)
        assert callable(letkf.letkf_window_analysis_fused_2d)
        assert "letkf_window2d" in _build.KERNELS
        assert "window2d" in letkf.LAUNCHES
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
