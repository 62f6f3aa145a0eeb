"""
Parity of the port's neighborhood solvers against the JAX package on the
same numpy inputs:

- the Newton-Schulz helpers (ops.linalg) and the ``newton`` and
  ``woodbury`` weights (ops.etkf) in f64 at 1e-10;
- K4's and K5's plain versions, through their wrappers on CPU tensors,
  against the JAX kernels in interpret mode, in f32 within 1e-5 of
  max|ref| with identical NaN columns (ns 1 and 3, a ragged grid, empty
  neighborhoods, NaN-poisoned columns);
- ``make_letkf_analysis`` with ``cheb``, ``pallas``, ``newton`` and
  ``woodbury``, and its signature;
- the kernel library's hash covers the shared headers.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim import analysis as JA
from tpu_assim.ops import etkf as je
from tpu_assim.ops import linalg as jl
from tpu_assim.ops import localization as jloc
from tpu_assim.ops.pallas import letkf as J

from tpu_assim_torch import _build
from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.ops import etkf as te
from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops import localization as tloc
from tpu_assim_torch.ops.cuda import letkf as T

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
RADIUS = 4.0


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def rel_close(port, ref, tol=1e-5):
    """Within ``tol`` of max|ref| on the finite entries; NaN entries
    coincide."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    fin = ~np.isnan(ref)
    err = np.abs(port[fin] - ref[fin]).max() / np.abs(ref[fin]).max()
    assert err <= tol, err


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def spd_batch(rng, batch=5, n=6, shift=2.0):
    a = rng.normal(size=(batch, n, n))
    return a @ np.swapaxes(a, -1, -2) + shift * np.eye(n)


# -- Newton-Schulz helpers and weights, f64 ----------------------------------

@pytest.mark.parametrize("lam_min", [None, 2.0])
def test_newton_schulz_helpers(rng, lam_min):
    a = spd_batch(rng)
    for name in ("inv_sqrt_psd_newton", "sqrt_and_inv_sqrt_psd_newton"):
        out = getattr(tl, name)(t(a), num_iters=20, lam_min=lam_min)
        ref = getattr(jl, name)(jnp.asarray(a), num_iters=20,
                                lam_min=lam_min)
        for x, y in zip(out, ref):
            close(x, y)
    close(tl.inv_spd_newton(t(a), num_iters=20, lam_min=lam_min),
          jl.inv_spd_newton(jnp.asarray(a), num_iters=20, lam_min=lam_min))
    inv, _ = tl.inv_sqrt_psd_newton(t(a), num_iters=30, lam_min=lam_min)
    close(inv, np.linalg.inv(a), 1e-9)


def test_newton_weights_from_gram(rng):
    z = rng.normal(size=(4, 8, 20))
    y = rng.normal(size=(4, 20))
    gram = z @ np.swapaxes(z, -1, -2)
    zy = z @ y[..., None]
    out = te.etkf_weights_from_gram(t(gram), t(zy), 8, 1.2, method="newton",
                                    newton_iters=30)
    ref = je.etkf_weights_from_gram(jnp.asarray(gram), jnp.asarray(zy), 8,
                                    1.2, method="newton", newton_iters=30)
    for a, b in zip(out, ref):
        close(a, b)
    with pytest.raises(ValueError):
        te.etkf_weights_from_gram(t(gram), t(zy), 8, method="cholesky")


@pytest.mark.parametrize("method", ["newton", "woodbury"])
def test_letkf_weights_nbh(rng, method):
    k, l, g, nb = 8, 30, 7, 6
    perts = rng.normal(size=(k, l))
    obs = rng.normal(size=l)
    idx = rng.randint(0, l, size=(g, nb))
    w = rng.rand(g, nb)
    w[:, 4:] = 0.0
    w[2] = 0.0  # an empty neighborhood: the inflated prior
    out = te.letkf_weights_nbh(t(perts), t(obs), t(idx), t(w), 1.1,
                               method=method, newton_iters=20)
    ref = je.letkf_weights_nbh(jnp.asarray(perts), jnp.asarray(obs),
                               jnp.asarray(idx), jnp.asarray(w), 1.1,
                               method=method, newton_iters=20)
    close(out, ref)
    close(out[2], np.sqrt(1.1) * np.eye(k), 1e-9)


def test_letkf_weights_dense_newton(rng):
    perts = rng.normal(size=(8, 30))
    innov = rng.normal(size=30)
    w = np.abs(rng.normal(size=(9, 30)))
    out = te.letkf_weights_dense(t(perts), t(innov), t(w), 1.1,
                                 method="newton", newton_iters=30)
    ref = je.letkf_weights_dense(jnp.asarray(perts), jnp.asarray(innov),
                                 jnp.asarray(w), 1.1, method="newton",
                                 newton_iters=30)
    close(out, ref)


# -- K4: the Chebyshev solve over gathered neighborhoods, f32 ----------------

def nbh_case(rng, k=9, g=37, nb=6, ns=1, zero_cols=(), nan_cols=()):
    """Scaled neighborhoods [nb, k, g], innovations [nb, g], state slices;
    the last two slots empty (zero weight), but never the first."""
    w = rng.rand(nb, g)
    w[max(nb - 2, 1):] = 0.0
    w[:, list(zero_cols)] = 0.0
    sw = np.sqrt(w)
    zh = rng.normal(size=(nb, k, g)) * sw[:, None, :]
    yh = rng.normal(size=(nb, g)) * sw
    zh[:, :, list(nan_cols)] = np.nan
    yh[:, list(nan_cols)] = np.nan
    arrays = dict(zh=zh, yh=yh, sp=rng.normal(size=(ns, k, g)),
                  mean=rng.normal(size=(ns, g)))
    return {n: a.astype(np.float32) for n, a in arrays.items()}


def cheb_both(c, degree, inf=1.1, squeeze=False):
    k = c["zh"].shape[1]
    reg = (k - 1) / inf
    sp, mean = c["sp"], c["mean"]
    if squeeze:
        sp, mean = sp[0], mean[0]
    out = T.letkf_nbh_analysis_cheb(t(c["zh"]), t(c["yh"]), t(sp), t(mean),
                                    reg, k, degree=degree)
    ref = J.letkf_nbh_analysis_cheb(
        jnp.asarray(c["zh"]), jnp.asarray(c["yh"]), jnp.asarray(sp),
        jnp.asarray(mean), jnp.asarray(reg, jnp.float32), k, degree=degree,
        tile=16, interpret=True)
    return out, np.asarray(ref)


@pytest.mark.parametrize("ns,degree", [(1, 12), (3, 20)])
def test_cheb_wrapper_matches_jax_kernel(rng, ns, degree):
    """g = 37 with tile 16: the JAX kernel pads the grid, the port does
    not."""
    c = nbh_case(rng, ns=ns)
    before = dict(T.LAUNCHES)
    out, ref = cheb_both(c, degree, squeeze=ns == 1)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    rel_close(out, ref)
    assert dict(T.LAUNCHES) == before  # the plain version on the CPU


@pytest.mark.parametrize("nb", [1, 8, 16, 17])
@pytest.mark.parametrize("ns,degree", [(1, 12), (3, 20)])
def test_cheb_wrapper_packings_match_jax_kernel(rng, ns, degree, nb):
    """The windows that reach each packing of K4's register route: nb 1 and
    8 (4 columns a warp), 16 (2) and 17 (1), with a NaN column."""
    c = nbh_case(rng, nb=nb, ns=ns, nan_cols=(5,))
    out, ref = cheb_both(c, degree, squeeze=ns == 1)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    rel_close(out, ref)
    bad = np.isnan(out.numpy()).reshape(-1, 37).any(axis=0)
    assert bad[5] and bad.sum() == 1


def test_cheb_empty_neighborhoods_give_inflated_prior(rng):
    c = nbh_case(rng, zero_cols=range(37))
    out, ref = cheb_both(c, 10, inf=1.21)
    rel_close(out, ref)
    close(out.numpy(), c["mean"][:, None, :] + np.sqrt(1.21) * c["sp"], 1e-5)


def test_cheb_nan_columns_match(rng):
    c = nbh_case(rng, ns=3, nan_cols=(3, 20))
    out, ref = cheb_both(c, 12)
    rel_close(out, ref)
    assert np.isnan(out.numpy()[:, :, [3, 20]]).all()
    assert np.isfinite(np.delete(out.numpy(), [3, 20], axis=2)).all()


def test_nbh_cheb_plain_f64_equals_cheb_solve_apply(rng):
    c = nbh_case(rng, ns=2)
    c = {n: a.astype(np.float64) for n, a in c.items()}
    nodes, dct = J._cheb_nodes_dct(16)
    ref = J._cheb_solve_apply(jnp.asarray(nodes), jnp.asarray(dct),
                              jnp.asarray(c["zh"]), jnp.asarray(c["yh"]),
                              jnp.asarray(c["sp"]),
                              jnp.asarray(c["mean"][:, None, :]),
                              jnp.asarray(8 / 1.1), 9, 16)
    close(T.nbh_cheb_plain(t(c["zh"]), t(c["yh"]), t(c["sp"]), t(c["mean"]),
                           8 / 1.1, 9, 16), ref)


# -- K5: the Woodbury solve by Newton-Schulz iterations, f32 -----------------

def fused_both(c, num_iters, inf=1.1):
    zh = np.ascontiguousarray(c["zh"].transpose(2, 0, 1))     # [g, nb, k]
    yh = np.ascontiguousarray(c["yh"].T)
    sp = np.ascontiguousarray(c["sp"][0].T)                   # [g, k]
    mean = c["mean"][0]
    k = zh.shape[2]
    reg = (k - 1) / inf
    out = T.letkf_nbh_analysis_fused(t(zh), t(yh), t(sp), t(mean), reg, k,
                                     num_iters=num_iters)
    ref = J.letkf_nbh_analysis_fused(
        jnp.asarray(zh), jnp.asarray(yh), jnp.asarray(sp), jnp.asarray(mean),
        jnp.asarray(reg, jnp.float32), k, num_iters=num_iters, tile=16,
        interpret=True)
    return out, np.asarray(ref)


@pytest.mark.parametrize("nb", [1, 2, 6, 12, 16, 32, 33])
@pytest.mark.parametrize("num_iters", [10, 25])
def test_fused_wrapper_matches_jax_kernel(rng, num_iters, nb):
    """nb 6 as before; nb 1, 2, 12, 16 and 32, which pack 32, 16, 2, 2
    and 1 columns into a warp on K5's register route; and 33, the first nb
    of its shared route."""
    c = nbh_case(rng, nb=nb)
    before = dict(T.LAUNCHES)
    out, ref = fused_both(c, num_iters)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (37, 9)
    rel_close(out, ref)
    assert dict(T.LAUNCHES) == before


def test_fused_nan_and_empty_columns(rng):
    c = nbh_case(rng, zero_cols=(0, 1), nan_cols=(5,))
    out, ref = fused_both(c, 14)
    rel_close(out, ref)
    assert np.isnan(out.numpy()[5]).all()
    close(out.numpy()[:2], (c["mean"][0][:, None] + np.sqrt(1.1)
                            * c["sp"][0].T)[:2], 1e-5)


@pytest.mark.parametrize("wrapper", ["cheb", "fused"])
def test_wrappers_check_inputs(wrapper):
    fn = (T.letkf_nbh_analysis_cheb if wrapper == "cheb"
          else T.letkf_nbh_analysis_fused)
    shapes = ([(4, 5, 7), (4, 7), (5, 7), (7,)] if wrapper == "cheb"
              else [(7, 4, 5), (7, 4), (7, 5), (7,)])
    args = [torch.zeros(s) for s in shapes]
    with pytest.raises(TypeError):
        fn(*[a.double() for a in args], 3.0, 5)
    with pytest.raises(ValueError):
        fn(*args, 3.0, 6)
    with pytest.raises(ValueError):
        fn(*[a.to("meta") for a in args], 3.0, 5)


# -- make_letkf_analysis ------------------------------------------------------

def workload(rng, k=10, g=120, o=40, dtype=np.float64):
    obs_idx = np.sort(rng.choice(g, size=o, replace=False)).astype(np.int32)
    return (
        (rng.normal(size=(k, g)) + 2.0).astype(dtype),
        rng.normal(size=o).astype(dtype) + 2.0,
        np.full(o, 0.5, dtype),
        obs_idx,
        np.arange(g, dtype=dtype)[:, None],
        obs_idx.astype(dtype)[:, None],
    )


def test_make_letkf_analysis_signature_is_jax():
    port = list(inspect.signature(TA.make_letkf_analysis).parameters)
    ref = list(inspect.signature(JA.make_letkf_analysis).parameters)
    assert port == ref
    for name in ref:
        assert (inspect.signature(TA.make_letkf_analysis).parameters[name]
                .default == inspect.signature(JA.make_letkf_analysis)
                .parameters[name].default)


@pytest.mark.parametrize("method,selection,chunksize", [
    ("newton", "topk", None), ("newton", None, 50), ("woodbury", "window", 7),
])
def test_newton_methods_analysis_f64(rng, method, selection, chunksize):
    """``selection=None`` runs newton over the dense taper."""
    w = workload(rng)
    jax_loc = jloc.GaspariCohn((RADIUS,), jax_coord1)
    opts = dict(method=method, newton_iters=30)
    if selection is not None:
        opts.update(max_obs=12, selection=selection)
    ref = JA.make_letkf_analysis(jax_loc, 1.1, chunksize, **opts)(
        *(jnp.asarray(a) for a in w))
    out = TA.make_letkf_analysis(convert.from_tpu_assim(jax_loc), 1.1,
                                 chunksize, **opts)(
        *convert.arrays_to_torch(w, "cpu"))
    close(out, ref)


@pytest.mark.parametrize("method,selection,chunksize", [
    ("cheb", "window", None), ("cheb", "topk", 50), ("pallas", "window", None),
])
def test_kernel_methods_analysis_f32(rng, method, selection, chunksize):
    """cheb through K4's plain version (chunked: one call per chunk),
    pallas through K5's; both against the JAX package in f32."""
    w = workload(rng, dtype=np.float32)
    jax_loc = jloc.GaspariCohn((RADIUS,), jax_coord1)
    opts = dict(method=method, max_obs=12, selection=selection,
                cheb_degree=16, newton_iters=25, obs_block=64)
    ref = JA.make_letkf_analysis(jax_loc, 1.1, chunksize, **opts)(
        *(jnp.asarray(a) for a in w))
    out = TA.make_letkf_analysis(convert.from_tpu_assim(jax_loc), 1.1,
                                 chunksize, **opts)(
        *convert.arrays_to_torch(w, "cpu"))
    assert out.dtype == torch.float32 and out.shape == w[0].shape
    rel_close(out, ref)
    oracle = TA.make_letkf_analysis(convert.from_tpu_assim(jax_loc), 1.1,
                                    max_obs=12)(
        *convert.arrays_to_torch(w, "cpu", torch.float64))
    rel_close(out, oracle, 2e-4 if method == "pallas" else 1e-5)


def test_strict_window_overflow_poisons_kernel_methods(rng):
    """16 obs packed at x = 100 overflow nb = 12: the strict window
    selection NaN-poisons those columns through cheb and pallas (the JAX
    package's cheb and pallas map the poison to zero weights and leave
    those columns at the prior)."""
    g, o, k = 200, 40, 8
    obs_x = np.sort(np.concatenate([rng.uniform(0, g, size=o - 16),
                                    100 + rng.uniform(0, 1, size=16)]))
    w = (rng.normal(size=(k, g)).astype(np.float32),
         rng.normal(size=o).astype(np.float32), np.ones(o, np.float32),
         np.clip(np.rint(obs_x), 0, g - 1).astype(np.int32),
         np.arange(g, dtype=np.float32)[:, None],
         obs_x.astype(np.float32)[:, None])
    loc = convert.from_tpu_assim(jloc.GaspariCohn((RADIUS,), jax_coord1))
    wt = convert.arrays_to_torch(w, "cpu")
    _, w_nbh = tloc.neighborhood_select_window(
        loc, TA._with_time(wt[4]), TA._with_time(wt[5]), 12)
    poisoned = torch.isnan(w_nbh).any(1)
    assert 0 < int(poisoned.sum()) < g
    for method in ("cheb", "pallas"):
        out = TA.make_letkf_analysis(loc, 1.1, method=method, max_obs=12,
                                     selection="window")(*wt)
        assert torch.equal(torch.isnan(out).any(0), poisoned)
        assert torch.equal(torch.isnan(out).all(0), poisoned)


def test_kernel_methods_need_neighborhoods(rng):
    loc = convert.from_tpu_assim(jloc.GaspariCohn((RADIUS,), jax_coord1))
    for method in ("cheb", "pallas", "woodbury"):
        with pytest.raises(ValueError, match="max_obs"):
            TA.make_letkf_analysis(loc, 1.1, method=method)
    with pytest.raises(ValueError):
        TA.make_letkf_analysis(loc, 1.1, method="unknown")


# -- the build ---------------------------------------------------------------

def test_library_hash_covers_headers(tmp_path, monkeypatch):
    for src in _build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._library_path(n) for n in _build.KERNELS}
    header = tmp_path / "cheb_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.KERNELS}
    assert all(before[n] != after[n] for n in _build.KERNELS)
    assert {"letkf_nbh_cheb", "letkf_nbh_ns"} <= set(_build.KERNELS)
