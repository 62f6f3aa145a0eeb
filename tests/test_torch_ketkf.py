"""
The port's kernelized ETKF family against the JAX package on the same
numpy inputs, in f64 at 1e-10:

- ``ops.ketkf``: ``center_gram``, ``ketkf_weights`` (eigh and newton, with
  and without observations) and ``ketkf_cheb_analysis`` at the same degree;
- ``KETKF.assimilate`` (Gauss and linear kernels; linear equals ETKF) and
  ``LKETKF.assimilate`` with eigh, newton and cheb (fixed and auto degree),
  over the dense taper and over ``max_obs`` neighborhoods (topk, window),
  chunked and not, in filter and smoother mode;
- the Tanh kernel's (indefinite) Grams through the two-sided Jacobi route
  equal ``torch.linalg.eigh``'s;
- a strict window overflow column is NaN in the port (eigh and cheb), the
  other columns equal JAX's;
- ``MultiplicativeInflation`` and ``Normalizer`` around LETKF and LKETKF.

States, observations, localizations and kernels are built on both sides
from the same numpy arrays (the port's through ``convert``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpu_assim as JT
from tpu_assim import transform as jtr
from tpu_assim.interface import lketkf as jlk
from tpu_assim.ops import ketkf as jops
from tpu_assim.ops import kernels as jk
from tpu_assim.ops import localization as jloc

import tpu_assim_torch as TT
from tpu_assim_torch import convert
from tpu_assim_torch.interface import lketkf as tlk
from tpu_assim_torch.ops import ketkf as tops
from tpu_assim_torch.ops import kernels as tk
from tpu_assim_torch.ops import linalg as tl

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
N_GRID = 60


def close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def states(rng, n_var=2, n_time=3, n_ens=10):
    data = rng.normal(size=(n_var, n_time, n_ens, N_GRID))
    kw = dict(times=np.arange(n_time, dtype=np.float64),
              grid_coords=np.arange(N_GRID, dtype=np.float64)[:, None],
              var_names=("x", "y")[:n_var])
    js = JT.EnsembleState(jnp.asarray(data), **kw)
    return js, convert.from_tpu_assim(js, device="cpu")


def observations(rng, state_np, n_obs=24, noise=0.5):
    """Point obs of var 'x' at sorted grid columns, every state time; the
    JAX and the port observation from one index array."""
    obs_idx = np.sort(rng.choice(N_GRID, size=n_obs, replace=False))
    truth = state_np[0].mean(axis=1)[:, obs_idx]
    vals = truth + rng.normal(scale=np.sqrt(noise), size=truth.shape)
    jo = JT.Observation(jnp.asarray(vals), jnp.full((n_obs,), noise),
                        obs_coords=obs_idx.astype(np.float64)[:, None],
                        times=np.arange(state_np.shape[1], dtype=np.float64),
                        operator=lambda obs, ps: ps.data[0][:, :, obs_idx])
    idx_t = torch.from_numpy(obs_idx)
    to = convert.from_tpu_assim(
        jo, operator=lambda obs, ps: ps.data[0][:, :, idx_t], device="cpu")
    return jo, to


@pytest.fixture
def pair(rng):
    js, ts = states(rng)
    jo, to = observations(rng, np.asarray(js.data))
    return js, ts, jo, to


def obs_space(rng, g=7, k=10, nb=9):
    perts = rng.normal(size=(g, k, nb))
    innov = rng.normal(size=(g, 1, nb))
    return perts, innov


# -- ops.ketkf ----------------------------------------------------------------

def test_center_gram(rng):
    k_perts = rng.normal(size=(4, 6, 6))
    k_obs = rng.normal(size=(4, 6, 1))
    for port, ref in zip(
            tops.center_gram(torch.from_numpy(k_perts),
                             torch.from_numpy(k_obs)),
            jops.center_gram(jnp.asarray(k_perts), jnp.asarray(k_obs))):
        close(port, ref)


@pytest.mark.parametrize("method", ["eigh", "newton"])
@pytest.mark.parametrize("kernel", ["GaussKernel", "LinearKernel",
                                    "RationalKernel"])
def test_ketkf_weights(rng, method, kernel):
    perts, innov = obs_space(rng)
    jkern, tkern = getattr(jk, kernel)(), getattr(tk, kernel)()
    ref = jops.ketkf_weights(jnp.asarray(perts), jnp.asarray(innov), jkern,
                             1.1, method=method)
    out = tops.ketkf_weights(torch.from_numpy(perts), torch.from_numpy(innov),
                             tkern, 1.1, method=method)
    assert out.shape == (7, 10, 10)
    close(out, ref)
    # innovations [..., l] are taken too
    close(tops.ketkf_weights(torch.from_numpy(perts),
                             torch.from_numpy(innov[:, 0]), tkern, 1.1,
                             method=method), ref)


def test_ketkf_weights_without_observations():
    perts = torch.zeros(3, 5, 0, dtype=torch.float64)
    out = tops.ketkf_weights(perts, torch.zeros(3, 1, 0, dtype=torch.float64),
                             tk.GaussKernel(), 1.3)
    ref = jops.ketkf_weights(jnp.zeros((3, 5, 0)), jnp.zeros((3, 1, 0)),
                             jk.GaussKernel(), 1.3)
    assert out.shape == (3, 5, 5)
    close(out, ref)


@pytest.mark.parametrize("degree", [8, 16])
def test_ketkf_cheb_analysis(rng, degree):
    """The same degree-d polynomial on both sides; the kernel with a column
    of zero scaled inputs (the empty-obs path) included."""
    perts, innov = obs_space(rng)
    perts[3] = 0.0
    innov[3] = 0.0
    sp = rng.normal(size=(2, 10, 7))
    mean = rng.normal(size=(2, 7))
    ref = jops.ketkf_cheb_analysis(
        jnp.asarray(perts), jnp.asarray(innov), jk.GaussKernel(1.5), 1.1,
        jnp.asarray(sp), jnp.asarray(mean), degree=degree)
    out = tops.ketkf_cheb_analysis(
        *(torch.from_numpy(a) for a in (perts, innov)), tk.GaussKernel(1.5),
        1.1, torch.from_numpy(sp), torch.from_numpy(mean), degree=degree)
    assert out.shape == (2, 10, 7)
    close(out, ref)
    # the empty column: mean + sqrt(rho) sp
    close(out[:, :, 3], mean[:, None, 3] + 1.1 ** 0.5 * sp[:, :, 3],
          tol=1e-5)


# -- the classes --------------------------------------------------------------

@pytest.mark.parametrize("smoother", [False, True])
@pytest.mark.parametrize("kernel,method", [
    ("GaussKernel", "eigh"), ("LinearKernel", "eigh"),
    ("GaussKernel", "newton")])
def test_ketkf_assimilate(pair, kernel, method, smoother):
    js, ts, jo, to = pair
    jkern = getattr(jk, kernel)(2.0) if kernel == "GaussKernel" else (
        jk.LinearKernel())
    ref = JT.KETKF(kernel=jkern, inf_factor=1.1, smoother=smoother,
                   method=method).assimilate(js, jo)
    alg = TT.KETKF(kernel=convert.from_tpu_assim(jkern, device="cpu"),
                   inf_factor=1.1, smoother=smoother, method=method)
    out = alg.assimilate(ts, to)
    assert out.valid and out.dtype == torch.float64
    close(out.data, ref.data)
    if kernel == "LinearKernel":
        close(out.data, TT.ETKF(1.1, smoother=smoother).assimilate(
            ts, to).data)


def test_ketkf_default_kernel_is_linear(pair):
    _, ts, _, to = pair
    alg = TT.KETKF(inf_factor=1.1)
    assert isinstance(alg.kernel, tk.LinearKernel)
    close(alg.assimilate(ts, to).data, TT.ETKF(1.1).assimilate(ts, to).data)


def lketkf_pair(kernel=None, radius=6.0, **kw):
    jax_loc = jloc.GaspariCohn((radius,), jax_coord1)
    jkern = kernel if kernel is not None else jk.GaussKernel(2.0)
    opts = dict(inf_factor=1.1, chunksize=None)
    opts.update(kw)
    return (JT.LKETKF(localization=jax_loc, kernel=jkern, **opts),
            TT.LKETKF(localization=convert.from_tpu_assim(jax_loc),
                      kernel=convert.from_tpu_assim(jkern, device="cpu"),
                      **opts))


LKETKF_CASES = [
    ("eigh", None, "topk"), ("eigh", 16, "topk"), ("eigh", 16, "window"),
    ("newton", None, "topk"), ("newton", 16, "topk"),
    ("cheb", None, "topk"), ("cheb", 16, "topk"), ("cheb", 16, "window")]


@pytest.mark.parametrize("method,max_obs,selection,smoother", [
    case + (smoother,) for smoother in (False, True) for case in LKETKF_CASES
    if not (smoother and case[2] == "window")])
def test_lketkf_assimilate(pair, method, max_obs, selection, smoother):
    """Filter and smoother mode (the smoother has no accuracy row in the JAX
    package: it is held against the JAX class here). The smoother stacks
    three obs times: 48 neighbors, and no window (the stacked coordinates
    are not sorted, which the window selection poisons)."""
    js, ts, jo, to = pair
    if smoother and max_obs is not None:
        max_obs = 48
    jax_alg, port_alg = lketkf_pair(method=method, max_obs=max_obs,
                                    selection=selection, smoother=smoother,
                                    cheb_degree=12 if method == "cheb"
                                    else None)
    ref = jax_alg.assimilate(js, jo)
    out = port_alg.assimilate(ts, to)
    assert out.valid and out.dtype == torch.float64
    assert out.n_times == ref.n_times
    close(out.data, ref.data)


def test_lketkf_cheb_auto_degree(pair):
    """The measured degree equals JAX's, and so does the analysis; the
    bound pass is non-strict on purpose."""
    js, ts, jo, to = pair
    jax_alg, port_alg = lketkf_pair(method="cheb", max_obs=16,
                                    selection="window")
    ens_obs_j, obs_j = jax_alg._apply_obs_operator(js, [jo])
    ens_obs_t, obs_t = port_alg._apply_obs_operator(ts, [to])
    _, perts_j, info_j = jax_alg._get_obs_space_variables(ens_obs_j, obs_j)
    _, perts_t, info_t = port_alg._get_obs_space_variables(ens_obs_t, obs_t)
    tr_j = float(jlk._lketkf_gram_trace_bound(
        jax_alg.localization, None, 16, "window", True, jax_alg.kernel,
        perts_j, js.grid_info(), info_j))
    tr_t = float(tlk._lketkf_gram_trace_bound(
        port_alg.localization, None, 16, "window", True, port_alg.kernel,
        perts_t, ts.grid_info(), info_t))
    assert tr_t == pytest.approx(tr_j, rel=1e-12)
    degree = port_alg._auto_cheb_degree(perts_t, ts.grid_info(), info_t)
    assert 6 <= degree <= 96
    close(port_alg.assimilate(ts, to).data, jax_alg.assimilate(js, jo).data)


@pytest.mark.parametrize("method", ["eigh", "cheb"])
def test_lketkf_chunked_equals_unchunked(pair, method):
    _, ts, _, to = pair
    _, whole = lketkf_pair(method=method, max_obs=16, cheb_degree=12)
    _, chunked = lketkf_pair(method=method, max_obs=16, cheb_degree=12,
                             chunksize=17)
    close(chunked.assimilate(ts, to).data, whole.assimilate(ts, to).data,
          tol=1e-12)


def test_lketkf_estimate_weights_on_cheb_instance_is_exact(pair):
    _, ts, _, to = pair
    _, cheb = lketkf_pair(method="cheb", max_obs=16)
    _, exact = lketkf_pair(method="eigh", max_obs=16)
    sliced = ts.sel_time_index(ts.time_index(None))
    ens_obs, filtered = cheb._apply_obs_operator(sliced, [to.sel_time(2.0)])
    w_c = cheb.estimate_weights(sliced, filtered, ens_obs)
    assert w_c.shape == (N_GRID, 10, 10)
    close(w_c, exact.estimate_weights(sliced, filtered, ens_obs))


def test_lketkf_linear_kernel_equals_letkf(pair):
    _, ts, _, to = pair
    loc = convert.from_tpu_assim(jloc.GaspariCohn((6.0,), jax_coord1))
    out = TT.LKETKF(loc, tk.LinearKernel(), 1.1).assimilate(ts, to)
    close(out.data, TT.LETKF(loc, 1.1).assimilate(ts, to).data)


def test_lketkf_config_errors():
    with pytest.raises(ValueError, match="weight"):
        TT.LKETKF(method="cheb", weight_save_path="w.h5")
    with pytest.raises(ValueError, match="method"):
        TT.LKETKF(method="woodbury")
    with pytest.raises(ValueError, match="selection"):
        TT.LKETKF(selection="nearest")
    assert TT.LKETKF().chunksize == 4096
    assert isinstance(TT.LKETKF().kernel, tk.LinearKernel)


@pytest.mark.parametrize("method", ["eigh", "cheb"])
def test_strict_window_overflow_is_nan(pair, method):
    """GC radius 2 with max_obs 4: columns with more than 4 in-support
    observations are NaN in the port (the JAX package gives them their
    prior); every other column equals JAX's."""
    js, ts, jo, to = pair
    jax_alg, port_alg = lketkf_pair(radius=2.0, method=method, max_obs=4,
                                    selection="window", cheb_degree=12)
    out = port_alg.assimilate(ts, to).data.numpy()
    ref = np.asarray(jax_alg.assimilate(js, jo).data)
    nan_cols = np.isnan(out).any(axis=(0, 1, 2))
    assert 0 < nan_cols.sum() < N_GRID
    assert np.isnan(out[..., nan_cols]).all()
    close(out[..., ~nan_cols], ref[..., ~nan_cols])
    # not strict: no NaN, and JAX's analysis everywhere
    jax_alg.max_obs_strict = port_alg.max_obs_strict = False
    close(port_alg.assimilate(ts, to).data, jax_alg.assimilate(js, jo).data)


def test_tanh_kernel_twosided_equals_lapack(pair, monkeypatch):
    """The Tanh kernel's double-centred Grams are indefinite. Routed
    through the two-sided Jacobi route (its plain version here, the gate
    opened to f64 CPU tensors), the f64 analysis equals the one through
    torch.linalg.eigh; a Gram is shown indefinite."""
    _, ts, _, to = pair
    _, port_alg = lketkf_pair(kernel=jk.TanhKernel(0.5, 0.3), max_obs=16)
    ref = port_alg.assimilate(ts, to)
    perts = torch.from_numpy(np.random.RandomState(3).normal(size=(10, 16)))
    gram, _ = tops.center_gram(tk.TanhKernel(0.5, 0.3)(perts, perts),
                               torch.zeros(10, 1, dtype=torch.float64))
    assert float(torch.linalg.eigvalsh(gram)[0]) < -1e-3
    calls = []
    from tpu_assim_torch.ops.cuda import jacobi as k7
    plain = k7.eigh_jacobi_plain
    monkeypatch.setattr(k7, "eigh_jacobi_plain",
                        lambda a, sweeps=7, with_sweeps=False: calls.append(
                            sweeps) or plain(a, sweeps, with_sweeps))
    monkeypatch.setattr(tl, "_takes_jacobi", lambda tensor, use: True)
    monkeypatch.setenv("TPU_ASSIM_EIGH_KERNEL", "twosided")
    out = port_alg.assimilate(ts, to)
    assert calls == [7]
    close(out.data, ref.data)


@pytest.mark.parametrize("cls", ["LETKF", "LKETKF"])
@pytest.mark.parametrize("transform", ["inflation", "normalizer"])
def test_transforms_around_the_analysis(pair, cls, transform):
    js, ts, jo, to = pair
    if transform == "inflation":
        jpre = [jtr.MultiplicativeInflation(1.2)]
        jpost = [jtr.MultiplicativeInflation(1.05)]
    else:
        jpre = [jtr.Normalizer((0.3, 1.7), [(0.2, 0.8)], (0.3, 1.7))]
        jpost = jpre
    tpre = [convert.from_tpu_assim(x, device="cpu") for x in jpre]
    tpost = [convert.from_tpu_assim(x, device="cpu") for x in jpost]
    jax_loc = jloc.GaspariCohn((6.0,), jax_coord1)
    kw = dict(inf_factor=1.1, chunksize=None)
    if cls == "LKETKF":
        kw["kernel"] = jk.GaussKernel(2.0)
    jax_alg = getattr(JT, cls)(jax_loc, pre_transform=jpre,
                               post_transform=jpost, **kw)
    if cls == "LKETKF":
        kw["kernel"] = convert.from_tpu_assim(kw["kernel"], device="cpu")
    port_alg = getattr(TT, cls)(convert.from_tpu_assim(jax_loc),
                                pre_transform=tpre, post_transform=tpost,
                                **kw)
    ref = jax_alg.assimilate(js, jo)
    out = port_alg.assimilate(ts, to)
    close(out.data, ref.data)
    plain = getattr(TT, cls)(port_alg.localization, **kw).assimilate(ts, to)
    assert not np.allclose(out.data.numpy(), plain.data.numpy())


def test_functional_solves_match_jax(pair):
    """``_lketkf_solve`` and ``_lketkf_cheb_analysis`` with the JAX
    positional signature, as bench.py config 11 calls them."""
    js, ts, jo, to = pair
    jax_alg, port_alg = lketkf_pair(max_obs=16, selection="window")
    sj, st = js.sel_time_index(2), ts.sel_time_index(2)
    ens_obs_j, obs_j = jax_alg._apply_obs_operator(sj, [jo.sel_time(2.0)])
    ens_obs_t, obs_t = port_alg._apply_obs_operator(st, [to.sel_time(2.0)])
    innov_j, perts_j, info_j = jax_alg._get_obs_space_variables(ens_obs_j,
                                                                obs_j)
    innov_t, perts_t, info_t = port_alg._get_obs_space_variables(ens_obs_t,
                                                                 obs_t)
    ref = jlk._lketkf_solve(jax_alg.localization, None, "eigh", 25, 16,
                            "window", True, jax_alg.kernel, perts_j, innov_j,
                            sj.grid_info(), info_j, jnp.asarray(1.1))
    out = tlk._lketkf_solve(port_alg.localization, None, "eigh", 25, 16,
                            "window", True, port_alg.kernel, perts_t, innov_t,
                            st.grid_info(), info_t, 1.1)
    assert out.shape == (N_GRID, 10, 10)
    close(out, ref)
    ref = jlk._lketkf_cheb_analysis(
        jax_alg.localization, None, 16, "window", True, 10, jax_alg.kernel,
        perts_j, innov_j, sj.grid_info(), info_j, jnp.asarray(1.1), sj.data)
    out = tlk._lketkf_cheb_analysis(
        port_alg.localization, 7, 16, "window", True, 10, port_alg.kernel,
        perts_t, innov_t, st.grid_info(), info_t, 1.1, st.data)
    close(out, ref)
