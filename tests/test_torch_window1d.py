"""
Parity of the port's 1-D window analysis (tpu_assim_torch.ops.cuda.letkf)
against the JAX package on the same numpy inputs.

- Host helpers: equal.
- ``_taper_poly``, ``_cheb_solve_apply`` and ``window_analysis_plain``
  against their JAX twins in f64 at 1e-10 (``window_analysis_plain``
  against ``_window_analysis_ref`` for o >= nb only: with o < nb the JAX
  reference gathers past the last observation and counts it several times,
  where its kernel counts every observation once).
- The wrapper (plain version on CPU) against the JAX kernel in interpret
  mode, in f32 within 1e-5 max|ref|, with identical NaN columns — including
  o < nb, which pins the kernel's semantics.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim.ops.pallas import letkf as J

from tpu_assim_torch.ops.cuda import letkf as T

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def window_case(rng, k=10, g=256, o=64, ns=1, radius=3.0, dtype=np.float32,
                cluster=0):
    """Sorted obs coordinates on a [0, g) grid, random perturbations;
    ``cluster`` extra obs near the middle overflow its columns."""
    obs_x = np.sort(rng.uniform(0, g, size=o))
    if cluster:
        obs_x = np.sort(np.concatenate(
            [obs_x, g / 2 + rng.uniform(0, 1, size=cluster)]))
    o = obs_x.shape[0]
    arrays = dict(
        perts=rng.normal(size=(k, o)), innov=rng.normal(size=o),
        obs_x=obs_x, grid_x=np.arange(g, dtype=float),
        sp=rng.normal(size=(ns, k, g)), mean=rng.normal(size=(ns, g)))
    return {n: a.astype(dtype) for n, a in arrays.items()}, radius


def port_fused(c, radius, nb, **kw):
    return T.letkf_window_analysis_fused(
        *(torch.from_numpy(c[n]) for n in
          ("perts", "innov", "obs_x", "grid_x", "sp", "mean")),
        (c["perts"].shape[0] - 1) / 1.1, radius, c["perts"].shape[0], nb=nb,
        **kw).numpy()


def jax_fused(c, radius, nb, **kw):
    return np.asarray(J.letkf_window_analysis_fused(
        *(jnp.asarray(c[n]) for n in
          ("perts", "innov", "obs_x", "grid_x", "sp", "mean")),
        jnp.asarray((c["perts"].shape[0] - 1) / 1.1, jnp.float32), radius,
        c["perts"].shape[0], nb=nb, interpret=True, **kw))


# -- host helpers ------------------------------------------------------------

def test_cheb_degree_for_equal():
    for lam in (0.5, 1.0, 1.05, 2.0, 7.3, 40.0, 1e3, 1e6):
        for tol in (1e-4, 1e-6, 1e-9):
            assert T.cheb_degree_for(lam, tol) == J.cheb_degree_for(lam, tol)


@pytest.mark.parametrize("degree", [6, 12, 16])
def test_cheb_nodes_dct_equal(degree):
    for a, b in zip(T._cheb_nodes_dct(degree), J._cheb_nodes_dct(degree)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
def test_support_helpers_equal(rng, taper):
    obs_x = np.sort(rng.uniform(0, 500, size=90))
    grid_x = np.arange(500, dtype=float)
    for radius in (2.0, 5.0, 11.0):
        assert T.max_in_support_1d(obs_x, grid_x, radius, taper) == \
            J.max_in_support_1d(obs_x, grid_x, radius, taper)
        for nb in (4, 12):
            assert T.required_obs_block(obs_x, grid_x, nb, radius=radius,
                                        taper=taper) == \
                J.required_obs_block(obs_x, grid_x, nb, radius=radius,
                                     taper=taper)


# -- f64 parity of the plain pieces -------------------------------------------

@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
def test_taper_poly(taper):
    z = np.linspace(0.0, 2.5, 251)
    close(T._taper_poly(torch.from_numpy(z), taper, 1e-5),
          J._taper_poly(jnp.asarray(z), taper, 1e-5))
    with pytest.raises(ValueError):
        T._taper_poly(torch.from_numpy(z), "box", 1e-5)


@pytest.mark.parametrize("ns", [1, 3])
def test_cheb_solve_apply(rng, ns):
    nb, k, cols, degree = 6, 9, 40, 12
    zh = rng.normal(size=(nb, k, cols)) * 0.7
    yh = rng.normal(size=(nb, cols))
    sp = rng.normal(size=(ns, k, cols))
    mean = rng.normal(size=(ns, 1, cols))
    reg = (k - 1) / 1.1
    nodes, dct = J._cheb_nodes_dct(degree)
    ref = J._cheb_solve_apply(jnp.asarray(nodes), jnp.asarray(dct),
                              jnp.asarray(zh), jnp.asarray(yh),
                              jnp.asarray(sp), jnp.asarray(mean),
                              jnp.asarray(reg), k, degree)
    nodes_t, dct_t = (torch.from_numpy(a).double() for a in (nodes, dct))
    out = T._cheb_solve_apply(nodes_t, dct_t, torch.from_numpy(zh),
                              torch.from_numpy(yh), torch.from_numpy(sp),
                              torch.from_numpy(mean),
                              torch.tensor(reg, dtype=torch.float64), k,
                              degree)
    close(out, ref)


@pytest.mark.parametrize("taper,ns", [("gc2", 1), ("gcinf", 3)])
def test_window_plain_matches_jax_reference(rng, taper, ns):
    c, radius = window_case(rng, ns=ns, dtype=np.float64)
    nb = max(8, J.max_in_support_1d(c["obs_x"], c["grid_x"], radius, taper))
    k = c["perts"].shape[0]
    reg = (k - 1) / 1.1
    ref = J._window_analysis_ref(
        *(jnp.asarray(c[n]) for n in ("perts", "innov", "obs_x", "grid_x",
                                      "sp")),
        jnp.asarray(c["mean"][:, None, :]), jnp.asarray([reg, radius]),
        ens_size=k, nb=nb, degree=12, epsilon=1e-5, taper=taper)
    out = T.window_analysis_plain(
        *(torch.from_numpy(c[n]) for n in ("perts", "innov", "obs_x",
                                           "grid_x", "sp", "mean")),
        reg, radius, ens_size=k, nb=nb, degree=12, epsilon=1e-5,
        taper=taper, strict=True)
    assert out.dtype == torch.float64
    close(out, ref)


# -- the wrapper against the JAX kernel (interpret mode), f32 ----------------

CASES = {
    "gc2 ns1": dict(),
    "gcinf ns1": dict(taper="gcinf"),
    "gc2 ns3": dict(ns=3),
    "gcinf ns3": dict(ns=3, taper="gcinf"),
    "strict overflow": dict(cluster=12),
    "truncating, not strict": dict(cluster=12, strict=False),
    "unsorted obs": dict(unsorted=True),
    "o < nb": dict(o=5, strict=False),
    "o < nb strict": dict(o=5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_wrapper_matches_jax_kernel(rng, case):
    opts = dict(CASES[case])
    kw = {n: opts.pop(n) for n in ("taper", "strict") if n in opts}
    unsorted = opts.pop("unsorted", False)
    c, radius = window_case(rng, **opts)
    nb = 8
    if unsorted:
        c["obs_x"][[3, 9]] = c["obs_x"][[9, 3]]
    ref = jax_fused(c, radius, nb, degree=12, **kw)
    out = port_fused(c, radius, nb, degree=12, **kw)
    assert out.shape == ref.shape and out.dtype == np.float32
    nan_ref = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(out), nan_ref)
    if case.startswith("strict"):
        cols = nan_ref.any(axis=0)
        assert 0 < cols.sum() < cols.size  # only the overflowing columns
    if unsorted:
        assert nan_ref.all()
        return
    fin = ~nan_ref
    err = np.abs(out[fin] - ref[fin]).max()
    assert err <= 1e-5 * np.abs(ref[fin]).max(), err


def test_obs_block_and_tile_change_nothing(rng):
    c, radius = window_case(rng, ns=3)
    base = port_fused(c, radius, 8)
    for kw in (dict(obs_block=16), dict(obs_block=64, tile=32)):
        np.testing.assert_array_equal(port_fused(c, radius, 8, **kw), base)


def test_wrapper_cpu_runs_plain_without_launch(rng):
    c, radius = window_case(rng)
    before = dict(T.LAUNCHES)
    out = port_fused(c, radius, 8, degree=12)
    k = c["perts"].shape[0]
    plain = T.window_analysis_plain(
        *(torch.from_numpy(c[n]) for n in ("perts", "innov", "obs_x",
                                           "grid_x", "sp", "mean")),
        (k - 1) / 1.1, radius, ens_size=k, nb=8, degree=12, epsilon=1e-5,
        taper="gc2", strict=True)
    np.testing.assert_array_equal(out, plain.numpy())
    assert T.LAUNCHES == before


def test_wrapper_validates_inputs(rng):
    c, radius = window_case(rng)
    args = [torch.from_numpy(c[n]) for n in
            ("perts", "innov", "obs_x", "grid_x", "sp", "mean")]
    k = args[0].shape[0]
    with pytest.raises(TypeError):
        T.letkf_window_analysis_fused(*[a.double() for a in args], 1.0,
                                      radius, k)
    with pytest.raises(ValueError):
        T.letkf_window_analysis_fused(*args, 1.0, radius, k + 1)
    with pytest.raises(ValueError):
        T.letkf_window_analysis_fused(*args[:5], args[5][:, :-1], 1.0,
                                      radius, k)
    with pytest.raises(ValueError):
        T.letkf_window_analysis_fused(*args, 1.0, radius, k, taper="box")


def test_plain_gradient_is_finite(rng):
    """The plain version is the future backward of the kernel: zero taper
    weights must not turn into NaN cotangents."""
    c, radius = window_case(rng, g=64, o=16)
    args = [torch.from_numpy(c[n]).double() for n in
            ("perts", "innov", "obs_x", "grid_x", "sp", "mean")]
    args[0].requires_grad_(True)
    args[4].requires_grad_(True)
    k = args[0].shape[0]
    out = T.window_analysis_plain(*args, (k - 1) / 1.1, radius, ens_size=k,
                                  nb=8, degree=12, epsilon=1e-5,
                                  taper="gc2", strict=True)
    out.square().sum().backward()
    assert torch.isfinite(args[0].grad).all()
    assert torch.isfinite(args[4].grad).all()
