"""
The port's TerrSysMP adapters (tpu_assim_torch.models.terrsysmp) and COSMO
T2m station operator (tpu_assim_torch.obs_ops.terrsysmp) against the JAX
package's, on the same numpy datasets (tests/test_terrsysmp.py's shapes):

- ``preprocess_cosmo``/``postprocess_cosmo`` and ``preprocess_clm``/
  ``postprocess_clm`` (lat/lon and column layouts) equal JAX's bit for
  bit: the stacked data, grid coordinates, times, vgrid and the unstack
  recipe, and the datasets written back;
- the port's state keeps ``grid_dims``, ``grid_shape`` and ``vgrid``
  through ``replace`` and the class analyses;
- ``CosmoT2mOperator``: its stations, height corrections and equivalents
  within 1e-12 of JAX's, the gather tensors made once per device;
- the COSMO end-to-end class LETKF as tests/test_terrsysmp.py runs it:
  eigh within 1e-10 of JAX's, cheb (topk, kernel K4's plain version)
  within the f32 kernel tolerance of JAX's cheb, NaN exactly at the
  vgrid padding.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_assim as JT
from tpu_assim.models import terrsysmp as jts
from tpu_assim.obs_ops import terrsysmp as jops
from tpu_assim.ops.localization import GaspariCohn as JGaspariCohn
from tpu_assim.utils import dataset as jds

import tpu_assim_torch as TT
from tpu_assim_torch.models import terrsysmp as tts
from tpu_assim_torch.obs_ops import terrsysmp as tops
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.utils import dataset as tds

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
OP_TOL = 1e-12
KERNEL_TOL = 1e-5
ASSIM_VARS = ["T", "W", "T_2M", "W_SO"]
CLM_VARS = ["H2OSOI", "TSOI", "H2OSNO"]


def both(data_vars, coords):
    """The JAX package's and the port's Dataset of the same arrays."""
    return tuple(mod.Dataset({n: mod.Variable(d, v.copy())
                              for n, (d, v) in data_vars.items()},
                             {k: v.copy() for k, v in coords.items()})
                 for mod in (jds, tds))


def cosmo(rng, n_time=2, n_ens=3, n_rlat=4, n_rlon=5):
    """tests/test_terrsysmp.py:make_cosmo_ds."""
    vcoord = np.array([10000.0, 7500.0, 5000.0, 2500.0, 0.0])
    h = (n_rlat, n_rlon)
    data_vars = {
        "T": (("time", "ensemble", "level", "rlat", "rlon"),
              rng.normal(280, 10, size=(n_time, n_ens, 4) + h)),
        "W": (("time", "ensemble", "level1", "rlat", "rlon"),
              rng.normal(0, 1, size=(n_time, n_ens, 5) + h)),
        "T_2M": (("time", "ensemble", "height_2m", "rlat", "rlon"),
                 rng.normal(285, 5, size=(n_time, n_ens, 1) + h)),
        "W_SO": (("time", "ensemble", "soil1", "rlat", "rlon"),
                 rng.uniform(0, 1, size=(n_time, n_ens, 3) + h)),
        "vcoord": (("level1",), vcoord),
    }
    coords = {
        "time": np.array([0.0, 3600.0])[:n_time],
        "level1": np.arange(5, dtype=np.float64),
        "level": np.arange(4, dtype=np.float64),
        "soil1": np.array([0.005, 0.02, 0.06]),
        "height_2m": np.array([2.0]),
        "rlat": np.linspace(-1.0, 1.0, n_rlat),
        "rlon": np.linspace(-2.0, 2.0, n_rlon),
    }
    return both(data_vars, coords)


def clm(rng, column=False):
    """tests/test_terrsysmp.py:make_clm_ds, or its column layout."""
    h = ("column",) if column else ("lat", "lon")
    shape = (12,) if column else (3, 4)
    data_vars = {
        "H2OSOI": (("time", "ensemble", "levsoi") + h,
                   rng.uniform(size=(2, 2, 3) + shape)),
        "TSOI": (("time", "ensemble", "levtot") + h,
                 rng.normal(275, 5, size=(2, 2, 4) + shape)),
        "H2OSNO": (("time", "ensemble") + h, rng.uniform(size=(2, 2) + shape)),
    }
    coords = {"time": np.array([0.0, 1800.0]),
              "levsoi": np.array([0.01, 0.04, 0.1]),
              "levtot": np.array([1.0, 2.0, 3.0, 4.0])}
    if not column:
        coords.update(lat=np.linspace(50.0, 51.0, 3),
                      lon=np.linspace(7.0, 8.0, 4))
    return both(data_vars, coords)


def same_state(port, ref):
    np.testing.assert_array_equal(port.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(port.grid_coords.numpy(),
                                  np.asarray(ref.grid_coords))
    np.testing.assert_array_equal(port.times.numpy(), np.asarray(ref.times))
    np.testing.assert_array_equal(port.vgrid, ref.vgrid)
    assert port.var_names == tuple(ref.var_names)
    assert port.grid_dims == ref.grid_dims
    assert tuple(port.grid_shape) == tuple(ref.grid_shape)


def same_ds(port, ref):
    assert sorted(port.data_vars) == sorted(ref.data_vars)
    for name in ref.data_vars:
        assert port[name].dims == ref[name].dims
        np.testing.assert_array_equal(port[name].values, ref[name].values)
    assert sorted(port.coords) == sorted(ref.coords)
    for name in ref.coords:
        np.testing.assert_array_equal(port.coords[name], ref.coords[name])


def test_cosmo_pre_and_postprocess_equal_jax(rng):
    jds_, tds_ = cosmo(rng)
    ref = jts.preprocess_cosmo(jds_, ASSIM_VARS + ["MISSING"])
    out = tts.preprocess_cosmo(tds_, ASSIM_VARS + ["MISSING"], device="cpu")
    same_state(out, ref)
    assert out.data.shape == (4, 2, 3, 4 * 5 * 8) and out.valid
    same_ds(tts.postprocess_cosmo(out, tds_),
            jts.postprocess_cosmo(ref, jds_))
    same_ds(tts.postprocess_cosmo(out.replace(data=out.data + 1.5), tds_),
            jts.postprocess_cosmo(ref.replace(data=ref.data + 1.5), jds_))


@pytest.mark.parametrize("column", [False, True])
def test_clm_pre_and_postprocess_equal_jax(rng, column):
    jds_, tds_ = clm(rng, column)
    ref = jts.preprocess_clm(jds_, CLM_VARS)
    out = tts.preprocess_clm(tds_, CLM_VARS, device="cpu")
    same_state(out, ref)
    same_ds(tts.postprocess_clm(out, tds_), jts.postprocess_clm(ref, jds_))
    same_ds(tts.postprocess_clm(out.replace(data=out.data * 2.0), tds_),
            jts.postprocess_clm(ref.replace(data=ref.data * 2.0), jds_))


def test_round_trips_are_the_identity(rng):
    _, c = cosmo(rng)
    out = tts.postprocess_cosmo(tts.preprocess_cosmo(c, ASSIM_VARS,
                                                     device="cpu"), c)
    for var in ASSIM_VARS:
        np.testing.assert_array_equal(out[var].values, c[var].values)
    _, l = clm(rng)
    out = tts.postprocess_clm(tts.preprocess_clm(l, CLM_VARS, device="cpu"),
                              l)
    for var in CLM_VARS:
        np.testing.assert_array_equal(out[var].values, l[var].values)


def test_state_keeps_the_adapter_attributes(rng):
    _, c = cosmo(rng)
    state = tts.preprocess_cosmo(c, ASSIM_VARS, device="cpu")
    for derived in (state.replace(data=state.data * 2), state + 1.0,
                    state.sel_time_index(0)):
        assert derived.grid_dims == ("rlat", "rlon", "vgrid")
        assert tuple(derived.grid_shape) == (4, 5, 8)
        np.testing.assert_array_equal(derived.vgrid, state.vgrid)


def operators(rng):
    """tests/test_terrsysmp.py's operator setup, for both packages."""
    lat, lon = np.meshgrid(np.array([50.0, 50.5, 51.0]),
                           np.array([7.0, 7.5, 8.0]), indexing="ij")
    hsurf = rng.uniform(100, 300, size=(3, 3))
    vgrid = np.array([500.0, 300.0, 100.0, 50.0, 10.0, 0.0])
    st_alt = hsurf[[0, 2], [1, 2]] + np.array([25.0, -40.0])
    args = (np.array([50.0, 51.0]), np.array([7.5, 8.0]), st_alt, lat, lon,
            hsurf, vgrid, ("T", "T_2M"))
    kw = dict(lev_inds=(0, 2), t2m_level=0.0)
    return (jops.CosmoT2mOperator(*args, **kw),
            tops.CosmoT2mOperator(*args, **kw))


def test_t2m_operator_matches_jax(rng):
    jop, top = operators(rng)
    np.testing.assert_array_equal(top.locs, jop.locs)
    np.testing.assert_allclose(top.height_diff, jop.height_diff, rtol=OP_TOL,
                               atol=OP_TOL)
    x = rng.normal(280, 5, size=(2, 2, 4, 3 * 3 * 6))
    out = top.torch_operator()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jop.jax_operator()(jnp.asarray(x))), rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_allclose(
        top.get_lapse_rate(torch.from_numpy(x)).numpy(),
        np.asarray(jop.get_lapse_rate(jnp.asarray(x))), rtol=OP_TOL,
        atol=OP_TOL)
    np.testing.assert_array_equal(tops._get_cartesian(
        np.array([0.0, 90.0]), np.zeros(2), np.array([0.0, 100.0])),
        jops._get_cartesian(np.array([0.0, 90.0]), np.zeros(2),
                            np.array([0.0, 100.0])))


def test_t2m_gathers_are_made_once_per_device(rng):
    _, top = operators(rng)
    x = torch.from_numpy(rng.normal(280, 5, size=(2, 1, 4, 54)))
    fn = top.torch_operator()
    fn(x)
    first = top._tensors(x.device, x.dtype)
    fn(x)
    top.obs_op(TT.EnsembleState(x, device="cpu"))
    assert top._tensors(x.device, x.dtype) is first
    assert len(top._on_device) == 1
    fn(x.float())
    assert len(top._on_device) == 2


def end_to_end(rng, method, **kw):
    """tests/test_terrsysmp.py::test_cosmo_t2m_letkf_roundtrip on both
    packages: (JAX's analysis, the port's, the port's background)."""
    jds_, tds_ = cosmo(rng, n_time=1, n_ens=8)
    js = jts.preprocess_cosmo(jds_, ASSIM_VARS)
    ts = tts.preprocess_cosmo(tds_, ASSIM_VARS, device="cpu")
    vgrid = np.asarray(js.vgrid)
    lat2d, lon2d = np.meshgrid(np.linspace(50, 51, 4), np.linspace(7, 8, 5),
                               indexing="ij")
    hsurf = rng.uniform(100, 200, size=(4, 5))
    args = (np.array([50.0, 51.0]), np.array([7.25, 7.75]),
            np.array([140.0, 180.0]), lat2d, lon2d, hsurf, vgrid,
            js.var_names)
    jop = jops.CosmoT2mOperator(*args, lev_inds=(0, 2), t2m_level=0.0)
    top = tops.CosmoT2mOperator(*args, lev_inds=(0, 2), t2m_level=0.0)
    obs_vals = rng.normal(285, 2, size=(1, 2))
    obs_coords = np.asarray(js.grid_coords)[jop.locs * len(vgrid)][:, :2]
    jo = JT.Observation(jnp.asarray(obs_vals), jnp.full((2,), 1.0),
                        obs_coords=jnp.asarray(obs_coords), times=js.times,
                        operator=lambda o, s: jop(o, s))
    to = TT.Observation(obs_vals, np.ones(2), obs_coords=obs_coords,
                        times=ts.times, operator=lambda o, s: top(o, s),
                        device="cpu")
    opts = dict(inf_factor=1.05, chunksize=None, method=method, **kw)
    ref = JT.LETKF(localization=JGaspariCohn(
        (1.5, 2.5), lambda gc, oi: jnp.abs(oi[:, 1:3] - gc[1:3][None]).T),
        **opts).assimilate(js, jo)
    out = TT.LETKF(localization=GaspariCohn(
        (1.5, 2.5), lambda gc, oi: torch.abs(oi[:, 1:3] - gc[1:3][None]).T),
        **opts).assimilate(ts, to)
    return np.asarray(ref.data), out, ts, tds_


@pytest.mark.parametrize("method,kw", [
    ("eigh", {}),
    ("cheb", dict(max_obs=2, selection="topk", cheb_degree=16)),
])
def test_cosmo_t2m_letkf_matches_jax(rng, method, kw):
    ref, out, background, ds = end_to_end(rng, method, **kw)
    assert out.valid and out.vgrid is background.vgrid
    back = np.isfinite(background.data.numpy())
    ana = out.data.numpy()
    assert np.isfinite(ana[back]).all() and np.isnan(ana[~back]).all()
    if method == "eigh":
        np.testing.assert_allclose(ana, ref, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_array_equal(np.isnan(ana), np.isnan(ref))
        fin = ~np.isnan(ref)
        err = np.abs(ana[fin] - ref[fin]).max()
        assert err <= KERNEL_TOL * np.abs(ref[fin]).max(), err
    written = tts.postprocess_cosmo(out, ds)
    for var in ASSIM_VARS:
        assert np.isfinite(written[var].values).all()
    assert not np.allclose(written["T_2M"].values, ds["T_2M"].values)
