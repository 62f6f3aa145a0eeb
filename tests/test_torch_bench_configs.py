"""
The four paths of ``bench.py`` that ``chip_smoke.py`` phase 34 runs on the
card, held to the JAX package on the CPU at small sizes with each path's
structure kept:

- config 1, the global ETKF, at bench.py's own size (ens 20, grid 40, 20
  obs);
- config 12, a correlated R ``exp(-|dx| / 15) + 0.1 I`` whitened by its
  Cholesky factor; a test that fails when the whitening is skipped or
  applied from the wrong side;
- config 10, 4 stacked obs times over one network (tied coordinates) at
  the auto Chebyshev degree, which the port computes as JAX does;
- config 5, the 4-point-mean obs operator, whose stencil wraps round the
  grid's end.

Tolerances: the exact (eigh) paths and the f64 math of the fused1d path
(K1's plain version against JAX's ``_window_analysis_ref``) at 1e-10; the
fused1d analysis itself, which both packages run in f32 (the port's plain
version of K1 on the CPU, JAX's kernel in interpret mode), within 1e-5 of
max|JAX| with the same NaN entries: the committed f32 budget
(tests/test_accuracy_budget.py).

Run alone on the CPU:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_bench_configs.py -q``
"""

import inspect
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim import analysis as JA
from tpu_assim.ops import localization as jloc
from tpu_assim.ops.pallas import letkf as JL

from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.ops.cuda import letkf as TL

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402  (numpy only at import)
import chip_smoke  # noqa: E402

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
F32_TOL = 1e-5
RADIUS, INF = 20.0, 1.1


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


@pytest.fixture
def jax_loc():
    return jloc.GaspariCohn((RADIUS,), jax_coord1)


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def rel_close(port, ref, tol=F32_TOL):
    """Within ``tol`` of max|ref| on the finite entries, NaN where ref is."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    fin = ~np.isnan(ref)
    err = np.abs(port[fin] - ref[fin]).max() / np.abs(ref[fin]).max()
    assert err <= tol, err


def both(w):
    return ([None if a is None else jnp.asarray(a) for a in w],
            list(convert.arrays_to_torch(w, "cpu")))


def f32(w):
    return [a.astype(np.float32) if a is not None and a.dtype.kind == "f"
            else a for a in w]


def exp_corr(obs_x):
    """bench.py:654-657's correlated R over the obs coordinates."""
    return (np.exp(-np.abs(obs_x[:, None] - obs_x[None, :]) / 15.0)
            + 0.1 * np.eye(obs_x.shape[0]))


def stacked(w, n_t=4, seed=7):
    """bench.py:531-536: ``n_t`` obs times over one network, coordinates
    repeated (sorted, tied), new values and unit variances."""
    rnd = np.random.RandomState(seed)
    o = w[1].shape[0] * n_t
    return (w[0], rnd.normal(size=o).astype(w[1].dtype),
            np.ones(o, w[1].dtype), np.repeat(w[3], n_t), w[4],
            np.repeat(w[5], n_t, axis=0))


def exact_nb(w):
    return bench.exact_nb(JL.max_in_support_1d(w[5][:, 0], w[4][:, 0],
                                               RADIUS))


def jax_auto_degree(w, nb):
    """bench.py:544-549, with JAX's cheb_degree_for."""
    ens_obs = w[0][:, w[3]]
    znorm = (ens_obs - ens_obs.mean(0)) ** 2
    cs = np.concatenate([[0.0], np.cumsum(znorm.sum(0))])
    width = min(nb, len(w[3]))
    tr_max = float((cs[width:] - cs[:-width]).max())
    return JL.cheb_degree_for(1.0 + tr_max / ((w[0].shape[0] - 1) / INF))


def config(name, dtype=np.float64):
    """A small workload of config ``name`` (``bench.build_workload``'s
    recipe, obs every 10 columns as in bench.py) and its obs operators:
    ``(workload, port H, JAX H)``, the operators None for point obs."""
    if name == 5:
        # obs every 3.2 columns: the last at 509 of 512, so its stencil
        # wraps to columns 0 and 1
        w = bench.build_workload(10, 512, 160, dtype=dtype)
        sten = chip_smoke.stencil_4pt(w[3], 512)
        sten_t = torch.as_tensor(sten).long()
        return (w, lambda x: x[:, sten_t].mean(-1),
                lambda x: jnp.mean(jnp.take(x, sten, axis=-1), axis=-1))
    w = bench.build_workload(10, 400, 40, dtype=dtype)
    if name == 10:
        return stacked(w), None, None
    w = list(w)
    w[2] = exp_corr(w[5][:, 0].astype(np.float64)).astype(dtype)
    return tuple(w), None, None


def analyses(jax_loc, name, **opts):
    """The port's and JAX's make_letkf_analysis of config ``name``."""
    _, h_t, h_j = config(name)
    port = TA.make_letkf_analysis(convert.from_tpu_assim(jax_loc), INF,
                                  obs_operator=h_t, **opts)
    ref = JA.make_letkf_analysis(jax_loc, INF, obs_operator=h_j, **opts)
    return port, ref


def obs_space(w, h_t):
    """The port's f64 prologue: H x and the normalized obs space."""
    x = torch.from_numpy(w[0])
    ens_obs = x[:, torch.from_numpy(w[3]).long()] if h_t is None else h_t(x)
    return TA._normalized_obs_space(ens_obs, torch.from_numpy(w[1]),
                                    torch.from_numpy(w[2]))


# -- phase 34's inputs are bench.py's ------------------------------------------

@pytest.mark.parametrize("name", [1, 10, 12])
def test_phase34_inputs_are_bench_inputs(name):
    """chip_smoke.bench_config rebuilds bench.py's inputs of the config
    (config 5's recipe is the same build_workload at 2^20 columns, too
    large here; its stencil is checked below)."""
    w, nb, degree, stencil = chip_smoke.bench_config(name)
    if name == 1:
        ref = bench.build_workload(20, 40, 20)
    else:
        ref = bench.build_workload(40, 10000, 1000)
        if name == 10:
            ref = stacked(ref)
            assert degree == jax_auto_degree(ref, nb)
        else:
            ref = list(ref)
            ref[2] = (np.exp(-np.abs(ref[5][:, 0][:, None]
                                     - ref[5][:, 0][None, :]) / 15.0
                             ).astype("f4") + np.eye(1000, dtype="f4") * 0.1)
            assert degree == 12
        assert nb == exact_nb(ref)
    assert stencil is None
    for a, b in zip(w, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_config5_default_degree_is_bench_degree():
    """bench.py's config 5 passes no cheb_degree: both packages default to
    phase 34's DEGREE5."""
    for make in (TA.make_letkf_analysis, JA.make_letkf_analysis):
        assert inspect.signature(make).parameters["cheb_degree"].default \
            == chip_smoke.DEGREE5


# -- config 1: the global ETKF --------------------------------------------------

@pytest.mark.parametrize("inf", [1.0, INF])
def test_config1_etkf_matches_jax(inf):
    wj, wt = both(bench.build_workload(20, 40, 20, dtype="float64"))
    close(TA.make_etkf_analysis(inf)(*wt), JA.make_etkf_analysis(inf)(*wj))


# -- config 12: the correlated R -------------------------------------------------

def test_config12_whitening_matches_jax():
    w, _, _ = config(12)
    ens_obs = w[0][:, w[3]]
    out = TA._normalized_obs_space(*(torch.from_numpy(a)
                                     for a in (ens_obs, w[1], w[2])))
    ref = JA._normalized_obs_space(*(jnp.asarray(a)
                                     for a in (ens_obs, w[1], w[2])))
    for a, b in zip(out, ref):
        close(a, b)


@pytest.mark.parametrize("name", [12, 10, 5])
def test_eigh_analysis_matches_jax(jax_loc, name):
    w, _, _ = config(name)
    wj, wt = both(w)
    port, ref = analyses(jax_loc, name)
    close(port(*wt), ref(*wj))


@pytest.mark.parametrize("name", [12, 10, 5])
def test_fused1d_f64_math_matches_jax(name):
    """The f64 math of the fused1d path: the port's prologue and K1's plain
    version against JAX's prologue and _window_analysis_ref."""
    w, h_t, h_j = config(name)
    nb = exact_nb(w)
    degree = jax_auto_degree(w, nb) if name == 10 else 12
    perts, innov = obs_space(w, h_t)
    x = jnp.asarray(w[0])
    ens_obs = x[:, w[3]] if h_j is None else h_j(x)
    perts_j, innov_j = JA._normalized_obs_space(ens_obs, jnp.asarray(w[1]),
                                                jnp.asarray(w[2]))
    close(perts, perts_j)
    close(innov, innov_j)
    mean = w[0].mean(0)
    sp = (w[0] - mean)[None]
    reg = (w[0].shape[0] - 1) / INF
    out = TL.window_analysis_plain(
        perts, innov, torch.from_numpy(w[5][:, 0]),
        torch.from_numpy(w[4][:, 0]), torch.from_numpy(sp),
        torch.from_numpy(mean[None]), reg, RADIUS, ens_size=w[0].shape[0],
        nb=nb, degree=degree, epsilon=1e-5, taper="gc2", strict=True)
    ref = JL._window_analysis_ref(
        perts_j, innov_j, jnp.asarray(w[5][:, 0]), jnp.asarray(w[4][:, 0]),
        jnp.asarray(sp), jnp.asarray(mean[None, None]),
        jnp.asarray([reg, RADIUS]), ens_size=w[0].shape[0], nb=nb,
        degree=degree, epsilon=1e-5, taper="gc2")
    close(out, ref)


@pytest.mark.parametrize("bound", [False, True])
@pytest.mark.parametrize("name", [12, 10, 5])
def test_fused1d_analysis_matches_jax(jax_loc, name, bound):
    """The fused1d analysis as bench.py builds it: f32 on both sides, the
    port through K1's plain version, JAX through its kernel in interpret
    mode (config 10 at the auto degree)."""
    w, _, _ = config(name, np.float32)
    nb = exact_nb(w)
    degree = jax_auto_degree(w, nb) if name == 10 else 12
    opts = dict(method="fused1d", max_obs=nb, cheb_degree=degree)
    wj, wt = both(w)
    if bound:
        opts["geometry"] = (None if name == 5 else w[3], w[4], w[5])
        wj, wt = wj[:3], wt[:3]
    port, ref = analyses(jax_loc, name, **opts)
    out = port(*wt)
    assert out.dtype == torch.float32
    assert not torch.isnan(out).any()
    rel_close(out, ref(*wj))


def hand_whitened(w, side):
    """Config 12's inputs whitened by hand for a diagonal unit R: values
    and the obs operator premultiplied by L^{-1} (``"left"``, the
    contract: R = L L^T), by L^{-T} (``"transposed"``, the wrong factor),
    or left as they are with R's diagonal as variances (``"skipped"``)."""
    chol = np.linalg.cholesky(w[2])
    if side == "skipped":
        return (w[0], w[1], np.diag(w[2]).copy()) + tuple(w[3:]), None
    white = np.linalg.inv(chol if side == "left" else chol.T)
    white_t = torch.from_numpy(white.astype(w[0].dtype))
    idx = torch.from_numpy(w[3]).long()
    vals = (white @ w[1].astype(np.float64)).astype(w[0].dtype)
    return ((w[0], vals, np.ones_like(w[1])) + tuple(w[3:]),
            lambda x: (white_t @ x[:, idx].T).T)


@pytest.mark.parametrize("method", ["eigh", "fused1d"])
def test_config12_whitening_side(jax_loc, method):
    """The port's correlated-R analysis equals the analysis of the obs space
    whitened by hand by L^{-1} (R = L L^T) with a unit diagonal R: at 1e-10
    by eigh in f64, within 1e-5 by fused1d in f32. Whitening skipped or by
    L^{-T} (the wrong side) moves the analysis by far more."""
    dtype = np.float64 if method == "eigh" else np.float32
    tol = TOL if method == "eigh" else F32_TOL
    w, _, _ = config(12, dtype)
    loc = convert.from_tpu_assim(jax_loc)
    opts = {} if method == "eigh" else dict(
        method="fused1d", max_obs=exact_nb(w), cheb_degree=12)
    out = TA.make_letkf_analysis(loc, INF, **opts)(
        *convert.arrays_to_torch(w, "cpu")).double().numpy()
    for side in ("left", "transposed", "skipped"):
        wh, h = hand_whitened(w, side)
        ref = TA.make_letkf_analysis(loc, INF, obs_operator=h, **opts)(
            *convert.arrays_to_torch(wh, "cpu")).double().numpy()
        err = np.abs(out - ref).max() / np.abs(ref).max()
        if side == "left":
            assert err <= tol, err
        else:
            assert err > 1e-2, (side, err)


# -- config 10: tied coordinates at the auto degree ------------------------------

@pytest.mark.parametrize("size", ["small", "bench"])
def test_config10_auto_degree_matches_jax(size):
    """The port's cheb_degree_for over bench.py's spectral bound gives JAX's
    degree, at the small size and on bench.py's config-10 inputs, where
    both give the 47 that BENCH_r05_all.json records for JAX."""
    if size == "small":
        w, _, _ = config(10, np.float32)
    else:
        w = stacked(bench.build_workload(40, 10000, 1000))
    nb = exact_nb(w)
    degree = chip_smoke.auto_degree_1d(w[0], w[3], nb)
    assert degree == jax_auto_degree(w, nb)
    assert TL.cheb_degree_for is chip_smoke.k1.cheb_degree_for
    if size == "bench":
        assert (nb, degree) == (32, 47)
    else:
        assert degree > 16          # the high-degree regime


def test_config10_coordinates_are_tied():
    w, _, _ = config(10)
    ox = w[5][:, 0]
    assert np.all(ox[1:] >= ox[:-1]) and np.sum(ox[1:] == ox[:-1]) == 120


@pytest.mark.parametrize("nb,strict", [(None, True), (10, False),
                                       (13, False)])
def test_config10_window_on_ties_matches_jax_kernel(nb, strict):
    """K1's wrapper (its plain version on the CPU) takes the window JAX's
    kernel takes on tied coordinates: at the exact nb and where a window
    ends inside a run of 4 tied observations (nb 10, 13) and so must pick
    the same tied members; f32, within 1e-5 of max."""
    w, _, _ = config(10, np.float32)
    nb = nb or exact_nb(w)
    perts, innov = (t.numpy() for t in obs_space(w, None))
    mean = w[0].mean(0)
    arrays = (perts, innov, w[5][:, 0], w[4][:, 0], w[0] - mean, mean)
    k = w[0].shape[0]
    kw = dict(nb=nb, degree=jax_auto_degree(w, exact_nb(w)), strict=strict)
    out = TL.letkf_window_analysis_fused(
        *(torch.from_numpy(a) for a in arrays), (k - 1) / INF, RADIUS, k,
        **kw)
    ref = JL.letkf_window_analysis_fused(
        *(jnp.asarray(a) for a in arrays),
        jnp.asarray((k - 1) / INF, jnp.float32), RADIUS, k, interpret=True,
        **kw)
    assert not torch.isnan(out).any()
    rel_close(out, ref)


# -- config 5: the 4-point-mean obs operator --------------------------------------

def test_config5_stencil_wraps():
    """bench.py:337-339's stencil, built as phase 34 builds it: 4
    consecutive columns from each observation's own, the last ones
    wrapping round the grid's end."""
    w, h_t, h_j = config(5)
    sten = chip_smoke.stencil_4pt(w[3], 512)
    np.testing.assert_array_equal(
        sten, np.stack([(w[3] + s) % 512 for s in range(4)], axis=1))
    assert sten.dtype == np.int32
    assert np.any(sten[:, 3] < sten[:, 0])
    close(h_t(torch.from_numpy(w[0])), h_j(jnp.asarray(w[0])))
