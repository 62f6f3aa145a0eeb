"""
Parity of the port's class API (tpu_assim_torch.state, observation,
obs_ops, interface) against the JAX package on the same numpy arrays:

- EnsembleState and Observation, with ``mul_rcinv`` for diagonal,
  time-dependent, correlated and time-dependent correlated R, in f64 at
  1e-10;
- the Lorenz-96 observation operators;
- ``ETKF.assimilate`` and ``LETKF.assimilate`` through eigh, newton,
  woodbury, cheb and fused1d, in filtering and smoother mode, against the
  JAX classes: eigh, newton and woodbury in f64 at 1e-10, cheb and fused1d
  (f32 kernels, here their plain versions) within 1e-5 of max|ref|.

The JAX and the port operators are built from the same numpy index arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_assim as JT
from tpu_assim.obs_ops import lorenz96 as jops
from tpu_assim.ops import localization as jloc

import tpu_assim_torch as TT
from tpu_assim_torch import convert
from tpu_assim_torch.interface import letkf as tletkf
from tpu_assim_torch.obs_ops import lorenz96 as tops
from tpu_assim_torch.transform import MultiplicativeInflation

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def rel_close(port, ref, tol=1e-5):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def states(rng, n_var=2, n_time=3, n_ens=10, n_grid=60):
    data = rng.normal(size=(n_var, n_time, n_ens, n_grid))
    kw = dict(times=np.arange(n_time, dtype=np.float64),
              grid_coords=np.arange(n_grid, dtype=np.float64)[:, None],
              var_names=("x", "y")[:n_var])
    return (JT.EnsembleState(jnp.asarray(data), **kw),
            TT.EnsembleState(torch.from_numpy(data), **kw))


def observations(rng, state_np, n_obs=24, noise=0.5):
    """Point obs of var 'x' at sorted grid columns, every state time; the
    JAX and the port observation from one index array."""
    n_grid = state_np.shape[-1]
    obs_idx = np.sort(rng.choice(n_grid, size=n_obs, replace=False))
    truth = state_np[0].mean(axis=1)[:, obs_idx]
    vals = truth + rng.normal(scale=np.sqrt(noise), size=truth.shape)
    kw = dict(obs_coords=obs_idx.astype(np.float64)[:, None],
              times=np.arange(state_np.shape[1], dtype=np.float64))
    idx_t = torch.from_numpy(obs_idx)
    jax_obs = JT.Observation(
        jnp.asarray(vals), jnp.full((n_obs,), noise),
        operator=lambda obs, ps: ps.data[0][:, :, obs_idx], **kw)
    port_obs = TT.Observation(
        torch.from_numpy(vals), torch.full((n_obs,), noise,
                                           dtype=torch.float64),
        operator=lambda obs, ps: ps.data[0][:, :, idx_t], **kw)
    return jax_obs, port_obs


@pytest.fixture
def pair(rng):
    js, ts = states(rng)
    jo, to = observations(rng, np.asarray(js.data))
    return js, ts, jo, to


# -- the data model -----------------------------------------------------------

def test_ensemble_state(rng):
    js, ts = states(rng)
    assert ts.valid and ts.shape == js.shape and repr(ts) == repr(js)
    close(ts.grid_info(), js.grid_info())
    for a, b in zip(ts.split_mean_perts(), js.split_mean_perts()):
        close(a, b)
    for at in (None, 0.4, 1.6, 7.0):
        assert ts.time_index(at) == js.time_index(at)
    sub_t, sub_j = ts.sel_time_index(1), js.sel_time_index(1)
    assert sub_t.n_times == 1 and sub_t.var_names == ("x", "y")
    close(sub_t.data, sub_j.data)
    close((2.0 * ts - ts / 4.0 + 1.0).data, (2.0 * js - js / 4.0 + 1.0).data)
    assert not ts.replace(times=ts.times[:2]).valid
    with pytest.raises(TT.state.StateError):
        TT.EnsembleState(torch.zeros(3, 4, 5))


@pytest.mark.parametrize("kind", ["diag", "diag_time", "corr", "corr_time"])
def test_observation_mul_rcinv(rng, kind):
    n_time, n_obs = 3, 7

    def spd():
        a = rng.normal(size=(n_obs, n_obs))
        return a @ a.T + n_obs * np.eye(n_obs)

    cov = {"diag": rng.uniform(0.5, 2.0, n_obs),
           "diag_time": rng.uniform(0.5, 2.0, (n_time, n_obs)),
           "corr": spd(),
           "corr_time": np.stack([spd() for _ in range(n_time)])}[kind]
    vals = rng.normal(size=(n_time, n_obs))
    jo = JT.Observation(jnp.asarray(vals), jnp.asarray(cov))
    to = TT.Observation(torch.from_numpy(vals), torch.from_numpy(cov))
    assert to.correlated == jo.correlated and to.valid
    assert to.time_dependent_cov == jo.time_dependent_cov
    perts = rng.normal(size=(5, n_time, n_obs))   # [ens, time, obs]
    close(to.mul_rcinv(torch.from_numpy(vals)),
          jo.mul_rcinv(jnp.asarray(vals)))
    close(to.mul_rcinv(torch.from_numpy(perts)),
          jo.mul_rcinv(jnp.asarray(perts)))


def test_observation_times_and_coords(rng):
    vals = rng.normal(size=(3, 4))
    cov = rng.uniform(0.5, 2.0, (3, 4))
    kw = dict(obs_coords=rng.uniform(0, 9, (4, 2)), times=[0.5, 1.5, 2.5])
    jo = JT.Observation(jnp.asarray(vals), jnp.asarray(cov), **kw)
    to = TT.Observation(torch.from_numpy(vals), torch.from_numpy(cov), **kw)
    close(to.stacked_coords(), jo.stacked_coords())
    sel_t, sel_j = to.sel_time(1.5), jo.sel_time(1.5)
    close(sel_t.observations, sel_j.observations)
    close(sel_t.covariance, sel_j.covariance)
    with pytest.raises(KeyError):
        to.sel_time(1.0)
    assert not to.replace(times=to.times[:2]).valid
    # a port Observation from the JAX one's arrays
    conv = convert.from_tpu_assim(jo, device="cpu")
    assert conv.operator is None and conv.valid
    close(conv.stacked_coords(), jo.stacked_coords())


@pytest.mark.parametrize("cls", ["IdentityOperator", "BernoulliOperator"])
def test_lorenz96_operators(rng, cls):
    js, ts = states(rng, n_grid=40)
    jop = getattr(jops, cls)(obs_points=[1, 5, 9, 30], len_grid=40)
    top = getattr(tops, cls)(obs_points=[1, 5, 9, 30], len_grid=40)
    close(top.obs_op(ts), jop.obs_op(js))
    x = rng.normal(size=(6, 40))
    close(top.torch_operator()(torch.from_numpy(x)),
          jop.jax_operator()(jnp.asarray(x)))
    jo = JT.Observation(jnp.zeros((1, 4)), jnp.ones(4), times=[2.0])
    to = TT.Observation(torch.zeros(1, 4), torch.ones(4), times=[2.0])
    close(top(to, ts), jop(jo, js))
    drawn = tops.IdentityOperator(7, 40, np.random.RandomState(3))
    assert np.array_equal(drawn._sel_obs_points, jops.IdentityOperator(
        7, 40, np.random.RandomState(3))._sel_obs_points)


# -- the algorithms -----------------------------------------------------------

@pytest.mark.parametrize("smoother", [False, True])
def test_etkf_assimilate(pair, smoother):
    js, ts, jo, to = pair
    ref = JT.ETKF(1.1, smoother=smoother).assimilate(js, jo)
    out = TT.ETKF(1.1, smoother=smoother).assimilate(ts, to)
    assert out.valid and out.n_times == ref.n_times
    close(out.data, ref.data)


def letkf_pair(method, smoother, max_obs, **kw):
    jax_loc = jloc.GaspariCohn((6.0,), jax_coord1)
    opts = dict(inf_factor=1.1, method=method, smoother=smoother,
                max_obs=max_obs, chunksize=None, **kw)
    return (JT.LETKF(localization=jax_loc, **opts),
            TT.LETKF(localization=convert.from_tpu_assim(jax_loc), **opts))


@pytest.mark.parametrize("smoother", [False, True])
@pytest.mark.parametrize("method,max_obs", [
    ("eigh", None), ("eigh", 16), ("newton", None), ("woodbury", 16)])
def test_letkf_weight_methods(pair, method, max_obs, smoother):
    js, ts, jo, to = pair
    if smoother and max_obs is not None:
        max_obs = 48  # three obs times stacked
    jax_alg, port_alg = letkf_pair(method, smoother, max_obs)
    ref = jax_alg.assimilate(js, jo)
    out = port_alg.assimilate(ts, to)
    assert out.valid and out.dtype == torch.float64
    close(out.data, ref.data)


@pytest.mark.parametrize("smoother", [False, True])
@pytest.mark.parametrize("method", ["cheb", "fused1d"])
def test_letkf_fused_methods(pair, method, smoother):
    """ns = 2 slices in filtering mode, 6 in smoother mode; the smoother's
    stacked obs are unsorted, which fused1d sorts; the degree is measured
    (auto) on both sides."""
    js, ts, jo, to = pair
    max_obs = 48 if smoother else 16
    jax_alg, port_alg = letkf_pair(method, smoother, max_obs)
    ref = jax_alg.assimilate(js, jo)
    out = port_alg.assimilate(ts, to)
    assert out.dtype == torch.float64 and out.n_times == ref.n_times
    rel_close(out.data, ref.data)
    exact = TT.LETKF(port_alg.localization, 1.1, smoother=smoother,
                     max_obs=max_obs, chunksize=None).assimilate(ts, to)
    rel_close(out.data, exact.data)


def test_letkf_cheb_window_chunked(pair):
    """cheb with window selection, 4 chunks (one kernel call each) against
    the JAX class with its padded chunks."""
    js, ts, jo, to = pair
    jax_alg, port_alg = letkf_pair("cheb", False, 16, selection="window",
                                   cheb_degree=16)
    jax_alg.chunksize = port_alg.chunksize = 17
    rel_close(port_alg.assimilate(ts, to).data,
              jax_alg.assimilate(js, jo).data)


def test_auto_cheb_degree_equals_jax(pair):
    js, ts, jo, to = pair
    for selection in ("topk", "window"):
        jax_alg, port_alg = letkf_pair("cheb", True, 48, selection=selection)
        ens_obs_j, obs_j = jax_alg._apply_obs_operator(js, [jo])
        ens_obs_t, obs_t = port_alg._apply_obs_operator(ts, [to])
        _, perts_j, info_j = jax_alg._get_obs_space_variables(ens_obs_j,
                                                              obs_j)
        _, perts_t, info_t = port_alg._get_obs_space_variables(ens_obs_t,
                                                               obs_t)
        close(perts_t, perts_j)
        assert port_alg._auto_cheb_degree(
            perts_t, info_t, ts.grid_info()) == jax_alg._auto_cheb_degree(
            perts_j, info_j, js.grid_info())


def test_estimate_weights_on_fused_instance_is_exact(pair):
    js, ts, jo, to = pair
    _, fused = letkf_pair("cheb", False, 16)
    _, exact = letkf_pair("eigh", False, 16)
    sliced = ts.sel_time_index(ts.time_index(None))
    ens_obs, filtered = fused._apply_obs_operator(sliced,
                                                  [to.sel_time(2.0)])
    w_f = fused.estimate_weights(sliced, filtered, ens_obs)
    assert w_f.shape == (60, 10, 10)
    close(w_f, exact.estimate_weights(sliced, filtered, ens_obs))


def test_class_api_config_errors():
    loc = convert.from_tpu_assim(jloc.GaspariCohn((6.0,), jax_coord1))
    with pytest.raises(ValueError):
        TT.LETKF(method="cheb")
    with pytest.raises(ValueError):
        TT.LETKF(loc, method="fused1d", max_obs=16, weight_save_path="w.h5")
    with pytest.raises(ValueError):
        TT.LETKF(loc, method="fused2d")
    with pytest.raises(TypeError):
        TT.LETKF(object(), method="fused2d", max_obs=16)
    # the weight checkpoint is ported: a weight-based method takes a path
    assert TT.LETKF(loc, weight_save_path="w.h5").weight_save_path == "w.h5"
    # the transforms are ported: any iterable of them is taken
    inflation = MultiplicativeInflation(1.2)
    assert TT.ETKF(pre_transform=[inflation]).pre_transform == [inflation]
    with pytest.raises(ValueError):
        TT.LETKF(loc, method="pallas")


def test_no_observation_returns_background(rng):
    _, ts = states(rng)
    with pytest.warns(UserWarning):
        assert TT.LETKF().assimilate(ts, []) is ts


def test_fused1d_strict_overflow_raises(pair):
    js, ts, jo, to = pair
    _, port_alg = letkf_pair("fused1d", True, 8)
    with pytest.raises(ValueError, match="in-support"):
        port_alg.assimilate(ts, to)
    assert tletkf.LETKF is TT.LETKF


def test_state_from_tpu_assim(rng):
    js, _ = states(rng)
    ts = convert.from_tpu_assim(js, device="cpu")
    assert ts.var_names == js.var_names and ts.valid
    close(ts.data, js.data)
    close(ts.grid_info(), js.grid_info())
