"""
Parity of the port's smoother classes (tpu_assim_torch.interface.ienks,
lienks, variational) against the JAX package on the same numpy arrays:

- ``IEnKSTransform`` and ``IEnKSBundle`` at 1 and 3 outer iterations and
  tau 1.0 and 0.7, and ``LocalizedIEnKSTransform`` and
  ``LocalizedIEnKSBundle`` dense and over neighborhoods (top-k, window),
  whole and in chunks of 13 columns, with the identity forward model and
  with 4 RK4 steps of Lorenz-96, in f64 at 1e-10;
- the strict window's overflow: NaN in the poisoned columns (the JAX
  package gives them finite values), JAX's values elsewhere, and no SVD
  sees a NaN;
- the bounds of tau and epsilon, the abstract inner loop, ``str`` and
  ``repr``;
- the localized class against the port's ``make_lienks_step`` at 1e-10;
- the class in f32 through the plain K3 (the Jacobi gate opened to CPU
  tensors) against JAX in f64 within 1e-5 of max|ref|;
- gradients with respect to the state: the port's ``make_lienks_step``
  and the localized class against ``jax.grad`` of the JAX package's in f64
  at 1e-8, with finite-difference spot checks, also where the inner
  precisions hold exactly tied singular values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpu_assim as JT
from tpu_assim import analysis as JA
from tpu_assim.models import Lorenz96 as JLorenz96
from tpu_assim.models import RK4Integrator as JRK4
from tpu_assim.ops import localization as jloc
from tpu_assim.ops.pallas.letkf import max_in_support_1d
from tpu_assim.testing import dummy_distance, dummy_model, dummy_obs_operator

import tpu_assim_torch as TT
from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.interface import VarAssimilation
from tpu_assim_torch.models import cuda_forecast

from test_torch_ienks import jacobi_on_cpu  # noqa: F401 (a fixture)

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
RADIUS = 6.0
CLASSES = ("IEnKSTransform", "IEnKSBundle", "LocalizedIEnKSTransform",
           "LocalizedIEnKSBundle")


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def rel_close(port, ref, tol=1e-5):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    err = np.abs(port - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def port_identity(obs, state):
    """The port's twin of ``tpu_assim.testing.dummy_obs_operator``: variable
    'x' (else the first) at every grid point, at the observation times."""
    v = state.var_names.index("x") if "x" in state.var_names else 0
    state_times = state.times.numpy()
    t_idx = [int(np.nonzero(state_times == t)[0][0])
             for t in obs.times.numpy()]
    return state.data[v][t_idx]


def port_identity_model(state, iter_num=0):
    return state, state


def pair(rng, n_var=2, n_time=3, n_ens=10, n_grid=40):
    """JAX and port states of one numpy ensemble, and their observations of
    the state mean of 'x' plus noise at the last time (the recipe of
    tests/test_interface.py)."""
    data = rng.normal(size=(n_var, n_time, n_ens, n_grid))
    js = JT.EnsembleState(
        jnp.asarray(data), times=jnp.arange(n_time, dtype=jnp.float64),
        grid_coords=jnp.arange(n_grid, dtype=jnp.float64)[:, None],
        var_names=("x", "y")[:n_var])
    truth = data[0].mean(axis=1)
    vals = truth + rng.normal(scale=np.sqrt(0.5), size=truth.shape)
    jo = JT.Observation(jnp.asarray(vals), covariance=jnp.full((n_grid,), 0.5),
                        obs_coords=js.grid_coords, times=js.times,
                        operator=dummy_obs_operator())
    jo = jo.sel_time(float(js.times[-1]))
    return (js, convert.from_tpu_assim(js, device="cpu"), jo,
            convert.from_tpu_assim(jo, operator=port_identity, device="cpu"))


def localization_pair(radius=RADIUS):
    jl = jloc.GaspariCohn((radius,), dummy_distance)
    return jl, convert.from_tpu_assim(jl, device="cpu")


def build(name, localized, jax_kw=None, port_kw=None, **kw):
    """The JAX and the port instance of class ``name``: localized classes
    take ``localized = (jax_loc, port_loc)``."""
    jax_kw, port_kw = dict(jax_kw or {}), dict(port_kw or {})
    if name.startswith("Localized"):
        jax_kw["localization"], port_kw["localization"] = localized
    return (getattr(JT, name)(**kw, **jax_kw),
            getattr(TT, name)(**kw, **port_kw))


# -- the classes against the JAX classes ---------------------------------------

@pytest.mark.parametrize("tau", [1.0, 0.7])
@pytest.mark.parametrize("max_iter", [1, 3])
@pytest.mark.parametrize("name", ["IEnKSTransform", "IEnKSBundle"])
def test_ienks_matches_jax(rng, name, max_iter, tau):
    js, ts, jo, to = pair(rng)
    jax_alg, port_alg = build(
        name, None, jax_kw=dict(forward_model=dummy_model),
        port_kw=dict(forward_model=port_identity_model),
        tau=tau, max_iter=max_iter)
    ref = jax_alg.assimilate(js, jo)
    out = port_alg.assimilate(ts, to)
    assert out.valid and out.n_times == 1 and out.dtype == torch.float64
    close(out.data, ref.data)


@pytest.mark.parametrize("chunksize,max_obs,selection", [
    (None, None, "topk"), (None, 26, "topk"), (None, 26, "window"),
    (13, None, "topk"), (13, 26, "topk"), (13, 26, "window")])
@pytest.mark.parametrize("name", ["LocalizedIEnKSTransform",
                                  "LocalizedIEnKSBundle"])
def test_localized_matches_jax(rng, name, chunksize, max_obs, selection):
    js, ts, jo, to = pair(rng)
    jax_alg, port_alg = build(
        name, localization_pair(), jax_kw=dict(forward_model=dummy_model),
        port_kw=dict(forward_model=port_identity_model), tau=0.8,
        max_iter=2, chunksize=chunksize, max_obs=max_obs,
        selection=selection)
    close(port_alg.assimilate(ts, to).data, jax_alg.assimilate(js, jo).data)


def l96_models(n_steps=4, dt=0.05):
    """``n_steps`` RK4 steps of Lorenz-96 as a forward model of each package
    over a [1, t, k, g] state; the port's through ``analysis._forecast``,
    the path of the fused RK4 kernel."""
    j_integ = JRK4(JLorenz96(), dt)
    t_integ = convert.from_tpu_assim(j_integ, device="cpu")

    def jax_model(state, iter_num=0):
        x = state.data
        for _ in range(n_steps):
            x = j_integ.integrate(x)
        state = state.replace(data=x)
        return state, state

    def port_model(state, iter_num=0):
        state = state.replace(
            data=TA._forecast(t_integ, n_steps, state.data))
        return state, state

    return jax_model, port_model


def l96_pair(rng, k=10, g=40, dtype=np.float64):
    """A [1, 1, k, g] Lorenz-96 ensemble about 8 and point observations of
    every second column (tests/test_interface.py:483-523)."""
    data = (rng.normal(size=(1, 1, k, g)) + 8.0).astype(dtype)
    obs_idx = np.arange(0, g, 2)
    vals = (8.0 + rng.normal(size=(1, obs_idx.size))).astype(dtype)
    kw = dict(times=np.zeros(1), grid_coords=np.arange(g, dtype=float)[:, None])
    ts = TT.EnsembleState(torch.from_numpy(data), **kw)
    js = JT.EnsembleState(jnp.asarray(data), **kw)
    okw = dict(obs_coords=obs_idx.astype(float)[:, None], times=np.zeros(1))
    idx_t = torch.from_numpy(obs_idx)
    jo = JT.Observation(jnp.asarray(vals), jnp.full((obs_idx.size,), 0.3),
                        operator=lambda obs, ps: ps.data[0][:, :, obs_idx],
                        **okw)
    to = TT.Observation(torch.from_numpy(vals),
                        torch.full((obs_idx.size,), 0.3, dtype=torch.float64),
                        operator=lambda obs, ps: ps.data[0][:, :, idx_t],
                        **okw)
    return js, ts, jo, to


@pytest.mark.parametrize("name,smoother", [
    ("IEnKSTransform", False), ("LocalizedIEnKSTransform", False),
    ("LocalizedIEnKSTransform", True), ("LocalizedIEnKSBundle", False)])
def test_l96_forward_model_matches_jax(rng, name, smoother):
    js, ts, jo, to = l96_pair(rng)
    jax_model, port_model = l96_models()
    local = (dict(chunksize=None, max_obs=12, selection="window")
             if name.startswith("Localized") else {})
    jax_alg, port_alg = build(
        name, localization_pair(4.0), jax_kw=dict(forward_model=jax_model),
        port_kw=dict(forward_model=port_model), tau=0.8, max_iter=2,
        smoother=smoother, **local)
    close(port_alg.assimilate(ts, to).data, jax_alg.assimilate(js, jo).data)


@pytest.mark.parametrize("name", ["LocalizedIEnKSTransform",
                                  "LocalizedIEnKSBundle"])
def test_strict_window_overflow_is_nan(rng, monkeypatch, name):
    """Two slots fewer than the in-support maximum: exactly the overflowing
    columns are NaN, the others equal JAX's at 1e-10 although Lorenz-96
    couples them to the poisoned ones over 2 outer iterations, and no SVD
    sees a NaN."""
    k, g, o, radius = 8, 80, 40, 5.0
    obs_idx = np.sort(rng.choice(g, size=o, replace=False))
    coords = obs_idx.astype(float)
    nb = max_in_support_1d(coords, np.arange(g, dtype=float), radius) - 2
    data = rng.normal(size=(1, 1, k, g)) + 8.0
    vals = 8.0 + rng.normal(size=(1, o))
    kw = dict(times=np.zeros(1), grid_coords=np.arange(g, dtype=float)[:, None])
    okw = dict(obs_coords=coords[:, None], times=np.zeros(1))
    idx_t = torch.from_numpy(obs_idx)
    js = JT.EnsembleState(jnp.asarray(data), **kw)
    ts = TT.EnsembleState(torch.from_numpy(data), **kw)
    jo = JT.Observation(jnp.asarray(vals), jnp.full((o,), 0.5),
                        operator=lambda obs, ps: ps.data[0][:, :, obs_idx],
                        **okw)
    to = TT.Observation(torch.from_numpy(vals),
                        torch.full((o,), 0.5, dtype=torch.float64),
                        operator=lambda obs, ps: ps.data[0][:, :, idx_t],
                        **okw)
    jax_model, port_model = l96_models(3)
    jax_alg, port_alg = build(
        name, localization_pair(radius), jax_kw=dict(forward_model=jax_model),
        port_kw=dict(forward_model=port_model), tau=0.8, max_iter=2,
        chunksize=None, max_obs=nb, selection="window")
    ref = np.asarray(jax_alg.assimilate(js, jo).data)[0, 0]
    svd = torch.linalg.svd

    def finite_svd(a, *args, **kwargs):
        assert torch.isfinite(a).all(), "an SVD saw a NaN"
        return svd(a, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "svd", finite_svd)
    out = port_alg.assimilate(ts, to).data[0, 0].numpy()
    _, w_nbh = TT.ops.localization.neighborhood_select_window(
        port_alg.localization, ts.grid_info(), to.stacked_coords(), nb)
    overflow = torch.isnan(w_nbh).any(-1).numpy()
    nan_cols = np.isnan(out).any(axis=0)
    np.testing.assert_array_equal(nan_cols, overflow)
    assert np.isnan(out[:, nan_cols]).all() and 0 < nan_cols.sum() < g
    assert np.isfinite(ref).all()
    close(out[:, ~nan_cols], ref[:, ~nan_cols])


def test_bounds_and_abstract_inner_loop(rng):
    for name, kw in (("IEnKSTransform", dict(tau=1.5)),
                     ("IEnKSTransform", dict(tau=-0.1)),
                     ("IEnKSBundle", dict(epsilon=-1e-3)),
                     ("LocalizedIEnKSBundle", dict(tau=2.0))):
        with pytest.raises(ValueError) as jax_err:
            getattr(JT, name)(forward_model=dummy_model, **kw)
        with pytest.raises(ValueError) as port_err:
            getattr(TT, name)(forward_model=port_identity_model, **kw)
        assert str(port_err.value) == str(jax_err.value)
    alg = TT.IEnKSBundle(port_identity_model, epsilon=0.0)
    assert alg.epsilon == 0.0 and alg.tau == 1.0
    with pytest.raises(ValueError, match="selection"):
        TT.LocalizedIEnKSTransform(port_identity_model, selection="nearest")
    _, ts, _, to = pair(rng)
    with pytest.raises(NotImplementedError):
        VarAssimilation(port_identity_model, max_iter=1).assimilate(ts, to)


@pytest.mark.parametrize("name", CLASSES)
def test_str_and_repr_match_jax(name):
    jl, tl = localization_pair()
    kw = dict(tau=0.7)
    jax_alg, port_alg = build(name, (jl, tl), jax_kw=dict(
        forward_model=dummy_model), port_kw=dict(
        forward_model=port_identity_model), **kw)
    assert str(port_alg) == str(jax_alg)
    # an object's default repr holds its address: compare without one
    jax_alg, port_alg = build(name, (None, None), jax_kw=dict(
        forward_model=dummy_model), port_kw=dict(
        forward_model=port_identity_model), **kw)
    assert repr(port_alg) == repr(jax_alg)


# -- the class against the functional step --------------------------------------

@pytest.mark.parametrize("kind", ["transform", "bundle"])
def test_class_matches_make_lienks_step(rng, kind):
    """tests/test_interface.py::TestMakeLIEnKSStep::test_matches_class_api,
    on the port."""
    n_ens, n_grid = 10, 40
    _, ts, _, to = pair(rng, n_var=1, n_time=1, n_ens=n_ens, n_grid=n_grid)
    _, loc = localization_pair()
    cls = (TT.LocalizedIEnKSTransform if kind == "transform"
           else TT.LocalizedIEnKSBundle)
    ref = cls(forward_model=port_identity_model, localization=loc, tau=0.8,
              max_iter=3, chunksize=None, max_obs=26,
              selection="window").assimilate(ts, to)
    step = TA.make_lienks_step(loc, None, 0, n_outer=3, kind=kind, tau=0.8,
                               max_obs=26, selection="window")
    out = step(ts.data[0, 0], to.observations[0], to.covariance,
               torch.arange(n_grid), ts.grid_coords, to.obs_coords)
    close(out, ref.data[0, 0])


def test_jacobi_route_f32_matches_jax(rng, jacobi_on_cpu):
    """The f32 class smoother with 4 RK4 steps of Lorenz-96, 512 columns in
    chunks of 256: its SVDs through the plain K3 (2 iterations x 2 chunks
    x 2 SVDs of [256, 10, 10]), against the JAX class in f64 within 1e-5
    of max|ref|. The forecast takes the RK4 kernel's plain version."""
    js, ts, jo, to = l96_pair(rng, g=512, dtype=np.float32)
    ts = ts.replace(data=ts.data.float())
    to = TT.Observation(to.observations.float(), to.covariance.float(),
                        obs_coords=to.obs_coords, times=to.times,
                        operator=to.operator)
    jax_model, port_model = l96_models()
    jax_alg, port_alg = build(
        "LocalizedIEnKSTransform", localization_pair(4.0),
        jax_kw=dict(forward_model=jax_model),
        port_kw=dict(forward_model=port_model), max_iter=2, chunksize=256,
        max_obs=12, selection="window")
    ref = jax_alg.assimilate(js, jo).data
    rk4 = dict(cuda_forecast.LAUNCHES)
    out = port_alg.assimilate(ts, to).data
    assert jacobi_on_cpu == [(256, 10, 10)] * 8
    assert cuda_forecast.LAUNCHES == rk4
    assert out.dtype == torch.float32
    rel_close(out, ref)


# -- gradients ------------------------------------------------------------------

def lienks_grad_case(rng, g=16, k=5, max_obs=12, radius=4.0):
    """tests/test_differentiable.py::test_lienks_step_grad_through_state's
    workload: a [k, g] state about 2, obs of every second column, GC r=4,
    2 RK4 steps of dt 0.02."""
    state = rng.normal(size=(k, g)) + 2.0
    obs_idx = np.arange(0, g, 2, dtype=np.int32)
    rest = (rng.normal(size=g // 2), np.full(g // 2, 0.5), obs_idx,
            np.arange(g, dtype=float)[:, None],
            obs_idx.astype(float)[:, None])
    jl = jloc.GaspariCohn((radius,), dummy_distance)
    opts = dict(n_outer=2, tau=0.7, max_obs=max_obs, selection="window")
    j_integ = JRK4(JLorenz96(), dt=0.02)
    jstep = JA.make_lienks_step(jl, j_integ, 2, **opts)
    tstep = TA.make_lienks_step(convert.from_tpu_assim(jl, device="cpu"),
                                convert.from_tpu_assim(j_integ, device="cpu"),
                                2, **opts)
    return state, rest, jstep, tstep


def fd_check(loss, state, grad, entries, eps=1e-6, rtol=5e-4):
    for i, j in entries:
        e = np.zeros_like(state)
        e[i, j] = 1.0
        fd = (loss(state + eps * e) - loss(state - eps * e)) / (2 * eps)
        np.testing.assert_allclose(grad[i, j], fd, rtol=rtol, atol=1e-6)


def test_lienks_step_grad_through_state(rng):
    """The port of tests/test_differentiable.py's
    test_lienks_step_grad_through_state: the gradient of sum(out^2) with
    respect to the state against jax.grad of the JAX step at 1e-8, and a
    finite-difference spot check."""
    state, rest, jstep, tstep = lienks_grad_case(rng)
    jrest = [jnp.asarray(a) for a in rest]
    trest = [torch.as_tensor(a) for a in rest]
    ref = jax.grad(lambda x: jnp.sum(jstep(x, *jrest) ** 2))(
        jnp.asarray(state))
    x = torch.tensor(state, requires_grad=True)
    torch.sum(tstep(x, *trest) ** 2).backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-8,
                               atol=1e-8)

    def loss(s):
        with torch.no_grad():
            return float(torch.sum(tstep(torch.as_tensor(s), *trest) ** 2))

    fd_check(loss, state, x.grad.numpy(), [(1, 3), (4, 10)])


def test_localized_class_grad_matches_jax(rng):
    """The gradient of sum(analysis^2) through the class smoother (window
    selection, L96 forward model) with respect to the state's data, against
    jax.grad through the JAX class at 1e-8."""
    js, ts, jo, to = l96_pair(rng, k=5, g=16)
    jax_model, port_model = l96_models(2, 0.02)
    jax_alg, port_alg = build(
        "LocalizedIEnKSTransform", localization_pair(4.0),
        jax_kw=dict(forward_model=jax_model),
        port_kw=dict(forward_model=port_model), tau=0.7, max_iter=2,
        chunksize=None, max_obs=12, selection="window")
    ref = jax.grad(lambda d: jnp.sum(
        jax_alg.assimilate(js.replace(data=d), jo).data ** 2))(js.data)
    x = ts.data.clone().requires_grad_(True)
    torch.sum(port_alg.assimilate(ts.replace(data=x), to).data ** 2).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref), rtol=1e-8,
                               atol=1e-8)


def test_grad_finite_with_tied_precision(rng):
    """k = 20 members and at most 4 observations a column (GC r=2): each
    inner precision is a rank-4 update of 19 I, so 16 singular values tie
    at 19 up to rounding (at bench config 9, 32 of 40). The step's gradient
    is finite and passes the finite-difference spot check: the tied block
    of the SVD pullback does not reach the state."""
    state, rest, _, tstep = lienks_grad_case(rng, g=24, k=20, max_obs=4,
                                             radius=2.0)
    trest = [torch.as_tensor(a) for a in rest]
    x = torch.tensor(state, requires_grad=True)
    torch.sum(tstep(x, *trest) ** 2).backward()
    assert torch.isfinite(x.grad).all()

    def loss(s):
        with torch.no_grad():
            return float(torch.sum(tstep(torch.as_tensor(s), *trest) ** 2))

    fd_check(loss, state, x.grad.numpy(), [(1, 3), (7, 11), (19, 20)])
