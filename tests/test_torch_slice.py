"""
The port's analysis and cycle (tpu_assim_torch.analysis) against the JAX
package on the same numpy inputs, both sides built from one spec through
tpu_assim_torch.convert:

- the exact ``eigh`` analysis, ETKF and the R^{-1/2} normalization in f64
  at 1e-10;
- the ``fused1d`` analysis and 3 cycles of the fused1d cycle in f32 within
  1e-5 max|ref|;
- the port's fused1d against its own f64 eigh analysis within the
  committed 1e-5 relative budget (tests/test_accuracy_budget.py);
- the host-side checks raise where the JAX package raises;
- the package imports with JAX blocked.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim import analysis as JA
from tpu_assim.models import Lorenz96 as JLorenz96
from tpu_assim.models import RK4Integrator as JRK4
from tpu_assim.ops import localization as jloc
from tpu_assim.ops.pallas.letkf import max_in_support_1d

from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.models import cuda_forecast
from tpu_assim_torch.ops.cuda import letkf as tletkf

REPO = Path(__file__).resolve().parents[1]
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


def workload(rng, k=10, g=256, o=64, dtype=np.float64):
    """L96-sized ensemble with point observations at sorted grid points."""
    obs_idx = np.sort(rng.choice(g, size=o, replace=False)).astype(np.int32)
    arrays = (
        (rng.normal(size=(k, g)) + 2.0).astype(dtype),     # state
        rng.normal(size=o).astype(dtype) + 2.0,            # obs_vals
        np.full(o, 0.5, dtype),                            # obs_var
        obs_idx,
        np.arange(g, dtype=dtype)[:, None],                # grid_coords
        obs_idx.astype(dtype)[:, None],                    # obs_coords
    )
    return arrays


def window_nb(w):
    return max(8, max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS))


def both(w):
    return ([jnp.asarray(a) for a in w],
            list(convert.arrays_to_torch(w, "cpu")))


@pytest.fixture
def jax_loc():
    return jloc.GaspariCohn((RADIUS,), jax_coord1)


# -- exact path, f64 ---------------------------------------------------------

@pytest.mark.parametrize("correlated", [False, True])
def test_normalized_obs_space(rng, correlated):
    ens_obs = rng.normal(size=(8, 20))
    obs = rng.normal(size=20)
    if correlated:
        a = rng.normal(size=(20, 20))
        var = a @ a.T + 20 * np.eye(20)
    else:
        var = rng.uniform(0.5, 2.0, size=20)
    out = TA._normalized_obs_space(*(torch.from_numpy(x)
                                     for x in (ens_obs, obs, var)))
    ref = JA._normalized_obs_space(*(jnp.asarray(x)
                                     for x in (ens_obs, obs, var)))
    for a, b in zip(out, ref):
        close(a, b)


@pytest.mark.parametrize("loc_kind,chunksize", [
    ("gc2", None), ("gc2", 37), ("gcinf", None), ("none", 100)])
def test_eigh_analysis_matches(rng, loc_kind, chunksize):
    w = workload(rng)
    jax_side = {"gc2": jloc.GaspariCohn((RADIUS,), jax_coord1),
                "gcinf": jloc.GaspariCohnInf(RADIUS, jax_coord1),
                "none": None}[loc_kind]
    port_loc = None if jax_side is None else convert.from_tpu_assim(jax_side)
    wj, wt = both(w)
    ref = JA.make_letkf_analysis(jax_side, 1.1, chunksize)(*wj)
    out = TA.make_letkf_analysis(port_loc, 1.1, chunksize)(*wt)
    close(out, ref)


def test_eigh_analysis_correlated_r_and_obs_operator(rng, jax_loc):
    w = list(workload(rng))
    a = rng.normal(size=(64, 64)) * 0.1
    w[2] = a @ a.T + 0.5 * np.eye(64)
    wj, wt = both(w)
    idx = w[3]
    ref = JA.make_letkf_analysis(
        jax_loc, 1.1, obs_operator=lambda x: 0.5 * x[:, idx] ** 2)(*wj)
    out = TA.make_letkf_analysis(
        convert.from_tpu_assim(jax_loc), 1.1,
        obs_operator=lambda x: 0.5 * x[:, idx] ** 2)(*wt)
    close(out, ref)


def test_etkf_analysis_matches(rng):
    wj, wt = both(workload(rng, g=40, o=20))
    close(TA.make_etkf_analysis(1.2)(*wt), JA.make_etkf_analysis(1.2)(*wj))


# -- fused1d -------------------------------------------------------------------

@pytest.mark.parametrize("bound", [False, True])
def test_fused1d_analysis_matches_jax(rng, jax_loc, bound):
    w = workload(rng, dtype=np.float32)
    nb = window_nb(w)
    opts = dict(method="fused1d", max_obs=nb, cheb_degree=16)
    wj, wt = both(w)
    port_loc = convert.from_tpu_assim(jax_loc)
    if bound:
        geometry = (w[3], w[4], w[5])
        ref = JA.make_letkf_analysis(jax_loc, 1.1, geometry=geometry,
                                     **opts)(*wj[:3])
        out = TA.make_letkf_analysis(port_loc, 1.1, geometry=geometry,
                                     **opts)(*wt[:3])
    else:
        ref = JA.make_letkf_analysis(jax_loc, 1.1, **opts)(*wj)
        out = TA.make_letkf_analysis(port_loc, 1.1, **opts)(*wt)
    assert out.dtype == torch.float32
    rel_close(out, ref)


def test_fused1d_within_budget_of_f64_eigh(rng, jax_loc):
    """The port's f32 fused1d analysis against the port's f64 eigh oracle,
    within the committed 1e-5 relative budget."""
    w64 = workload(rng)
    w32 = [a.astype(np.float32) if a.dtype.kind == "f" else a for a in w64]
    loc = convert.from_tpu_assim(jax_loc)
    fused = TA.make_letkf_analysis(
        loc, 1.1, method="fused1d", max_obs=window_nb(w64),
        cheb_degree=16)(*convert.arrays_to_torch(w32, "cpu"))
    oracle = TA.make_letkf_analysis(loc, 1.1)(
        *convert.arrays_to_torch(w64, "cpu"))
    rel_close(fused, oracle)


@pytest.mark.parametrize("fault", ["unsorted", "max_obs too small"])
@pytest.mark.parametrize("bound", [False, True])
def test_host_checks_raise_like_jax(rng, jax_loc, fault, bound):
    w = list(workload(rng, dtype=np.float32))
    nb = window_nb(w)
    if fault == "unsorted":
        w[5] = w[5][::-1].copy()
        w[3] = w[3][::-1].copy()
    else:
        nb = max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS) - 1
    opts = dict(method="fused1d", max_obs=nb, cheb_degree=12)
    wj, wt = both(w)
    port_loc = convert.from_tpu_assim(jax_loc)
    for side, loc, args in (("jax", jax_loc, wj), ("port", port_loc, wt)):
        make = JA.make_letkf_analysis if side == "jax" else \
            TA.make_letkf_analysis
        with pytest.raises(ValueError):
            if bound:
                make(loc, 1.1, geometry=(w[3], w[4], w[5]), **opts)
            else:
                make(loc, 1.1, **opts)(*args)


def test_truncation_allowed_when_not_strict(rng, jax_loc):
    w = workload(rng, dtype=np.float32)
    nb = max_in_support_1d(w[5][:, 0], w[4][:, 0], RADIUS) - 1
    out = TA.make_letkf_analysis(
        convert.from_tpu_assim(jax_loc), 1.1, method="fused1d", max_obs=nb,
        cheb_degree=12, max_obs_strict=False)(
        *convert.arrays_to_torch(w, "cpu"))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("method", ["newton", "woodbury", "cheb", "pallas",
                                    "fused2d", "eigh"])
def test_unported_methods_name_their_roadmap_item(jax_loc, method):
    """Every solver not ported yet, and eigh over neighborhoods
    (max_obs), names its ROADMAP.md item."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TA.make_letkf_analysis(convert.from_tpu_assim(jax_loc), 1.1,
                               method=method, max_obs=8)


# -- the cycle -----------------------------------------------------------------

def test_fused1d_cycle_matches_jax_over_three_cycles(rng, jax_loc):
    w = workload(rng, dtype=np.float32)
    nb = window_nb(w)
    obs_seq = (rng.normal(size=(3, w[1].shape[0])) + 2.0).astype(np.float32)
    jax_integ = JRK4(JLorenz96(), 0.05)
    opts = dict(inf_factor=1.1, method="fused1d", max_obs=nb, cheb_degree=16,
                geometry=(w[3], w[4], w[5]))
    j_step = JA.make_cycle_step(jax_integ, 4, jax_loc, **opts)
    t_step = TA.make_cycle_step(convert.from_tpu_assim(jax_integ), 4,
                                convert.from_tpu_assim(jax_loc), **opts)
    xj, xt = jnp.asarray(w[0]), torch.from_numpy(w[0])
    var_j, var_t = jnp.asarray(w[2]), torch.from_numpy(w[2])
    launches = dict(cuda_forecast.LAUNCHES), dict(tletkf.LAUNCHES)
    for c in range(3):
        xj = j_step(xj, jnp.asarray(obs_seq[c]), var_j)
        xt = t_step(xt, torch.from_numpy(obs_seq[c]), var_t)
        rel_close(xt, xj)
    assert xt.dtype == torch.float32 and torch.isfinite(xt).all()
    assert (dict(cuda_forecast.LAUNCHES), dict(tletkf.LAUNCHES)) == launches


def test_eigh_cycle_matches_jax_f64(rng, jax_loc):
    """f64 state: the port integrates with the integrator's own steps (the
    kernel gate is f32 only), the JAX package with its interpret-mode
    kernel; the same RK4 to round-off."""
    w = workload(rng, g=64, o=16)
    jax_integ = JRK4(JLorenz96(), 0.05)
    assert not cuda_forecast.supports_fused_rk4(
        convert.from_tpu_assim(jax_integ), w[0].shape, 8)
    wj, wt = both(w)
    j_step = JA.make_cycle_step(jax_integ, 3, jax_loc, inf_factor=1.1)
    t_step = TA.make_cycle_step(convert.from_tpu_assim(jax_integ), 3,
                                convert.from_tpu_assim(jax_loc),
                                inf_factor=1.1)
    xj, xt = wj[0], wt[0]
    for _ in range(2):
        xj = j_step(xj, *wj[1:])
        xt = t_step(xt, *wt[1:])
    close(xt, xj)


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["tpu_assim"] = None
        import tpu_assim_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpu_assim_torch.__path__, "tpu_assim_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert "triton" not in sys.modules
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 14
