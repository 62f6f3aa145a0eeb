"""
Parity of the port's 2-D window analysis (tpu_assim_torch.ops.cuda.letkf,
kernel K6 and its plain version) and of ``make_letkf_analysis(method=
"fused2d")`` against the JAX package on the same numpy inputs:

- the host helpers ``required_obs_block_2d`` and ``max_in_support_2d``:
  equal;
- ``window2d_plain`` against the JAX kernels' plain twin ``_window2d_ref``
  in f64 at 1e-10;
- the wrapper (plain version on CPU) against the JAX kernel in interpret
  mode, banded and whole-table, with extra coordinate dims, ns > 1, strict
  NaN columns and band-overflow poison: f32 within 1e-5 of max|ref|, with
  identical NaN columns;
- ``make_letkf_analysis("fused2d")`` against the JAX one (1e-5) and the
  JAX f64 eigh oracle (5e-4, the JAX package's own bound);
- the eigh analysis with a strict window overflow returns NaN columns as
  the JAX package does; ``convert.from_tpu_assim`` defaults to the card.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim import analysis as JA
from tpu_assim.ops import localization as jloc
from tpu_assim.ops.pallas import letkf as J

from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.ops.cuda import letkf as T

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10


def rel_close(port, ref, tol=1e-5):
    """Within ``tol`` of max|ref| on the finite entries; NaN entries
    coincide."""
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    fin = ~np.isnan(ref)
    if fin.any():
        err = np.abs(port[fin] - ref[fin]).max() / np.abs(ref[fin]).max()
        assert err <= tol, err


def jax_dist(n_dims):
    def dist(gc, oi):
        return jnp.stack([jnp.abs(oi[:, 1 + j] - gc[1 + j])
                          for j in range(n_dims)], 0)
    return dist


def port_dist(n_dims):
    def dist(gc, oi):
        return torch.stack([torch.abs(oi[:, 1 + j] - gc[1 + j])
                            for j in range(n_dims)], 0)
    return dist


def locs(radii, n_dims=2):
    """The JAX and the port Gaspari-Cohn localization over ``n_dims``
    coordinate columns."""
    jl = jloc.GaspariCohn(radii, jax_dist(n_dims))
    return jl, convert.from_tpu_assim(jl, port_dist(n_dims))


def case_2d(rng, nr=24, nc=24, o=80, k=8, ns=1, nz=1, jitter=0.4):
    """A row-major nr x nc grid (x nz levels), o observations near random
    cells, random normalized perturbations and state slices (f32)."""
    g = nr * nc * nz
    zz, yy, xx = np.meshgrid(np.arange(nz, dtype="f8"),
                             np.arange(nr, dtype="f8"),
                             np.arange(nc, dtype="f8"), indexing="ij")
    grid = np.stack([xx.ravel(), yy.ravel()] + ([zz.ravel()] if nz > 1
                                                 else []), 1)
    pos = rng.choice(g, size=o, replace=False)
    obs = grid[pos] + rng.uniform(-jitter, jitter, size=(o, grid.shape[1]))
    f4 = np.float32
    return dict(perts=rng.normal(size=(k, o)).astype(f4),
                innov=rng.normal(size=o).astype(f4), obs_xy=obs,
                grid_xy=grid, sp=rng.normal(size=(ns, k, g)).astype(f4),
                mean=rng.normal(size=(ns, g)).astype(f4), pos=pos)


ARGS = ("perts", "innov", "obs_xy", "grid_xy", "sp", "mean")


def port_2d(c, rx, ry, **kw):
    k = c["perts"].shape[0]
    return T.letkf_window_analysis_fused_2d(
        *(torch.from_numpy(c[n]) for n in ARGS), (k - 1) / 1.1, rx, ry, k,
        **kw).numpy()


def jax_2d(c, rx, ry, **kw):
    k = c["perts"].shape[0]
    return np.asarray(J.letkf_window_analysis_fused_2d(
        *(jnp.asarray(c[n]) for n in ARGS),
        jnp.asarray((k - 1) / 1.1, jnp.float32), rx, ry, k, interpret=True,
        **kw))


# -- host helpers --------------------------------------------------------------

@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
def test_host_helpers_equal(rng, taper):
    for nr, nc, o, tile in ((24, 24, 80, 128), (8, 70, 200, 64),
                            (30, 17, 5, 128)):
        c = case_2d(rng, nr, nc, o)
        obs, grid = c["obs_xy"], c["grid_xy"]
        for rx, ry in ((4.0, 4.0), (2.5, 6.0)):
            assert T.required_obs_block_2d(obs[:, 1], grid[:, 1], ry, tile) \
                == J.required_obs_block_2d(obs[:, 1], grid[:, 1], ry, tile)
            assert T.max_in_support_2d(obs, grid, rx, ry, taper, 1e-5,
                                       tile) == \
                J.max_in_support_2d(obs, grid, rx, ry, taper, 1e-5, tile)
    assert T.max_in_support_2d(np.zeros((0, 2)), grid, 4.0, 4.0) == 0


# -- the plain version against the JAX kernel's plain twin, f64 ---------------

@pytest.mark.parametrize("taper,ns,n_dims", [("gc2", 1, 2), ("gcinf", 2, 2),
                                             ("gc2", 1, 3)])
def test_plain_matches_jax_reference_f64(rng, taper, ns, n_dims):
    """One banded table through ``window2d_plain``, and its per-tile masked
    slices, cut here, through ``_window2d_ref``, the plain twin of the JAX
    kernels (it has no strict guard: nb covers every column)."""
    c = case_2d(rng, 16, 16, 60, ns=ns, nz=2 if n_dims == 3 else 1)
    k, o = c["perts"].shape
    g = c["grid_xy"].shape[0]
    tile, width = 128, 48
    order = np.argsort(c["obs_xy"][:, 1], kind="stable")
    table = np.concatenate([c["perts"][:, order].T, c["innov"][order, None],
                            c["obs_xy"][order]], 1).astype(np.float64)
    table = np.concatenate(
        [table, np.full((width, table.shape[1]), np.finfo("f4").max)])
    table[o:, :k + 1] = 0.0
    n_tiles = g // tile
    off = rng.randint(0, 8, size=n_tiles) * 2
    a = rng.randint(0, 6, size=n_tiles)
    bands = np.stack([off, a, a + rng.randint(20, width - 6,
                                              size=n_tiles)]).astype("i4")
    grid = c["grid_xy"].T.copy()
    radii = (4.0, 3.0, 1.5)[:n_dims]
    scal = np.array(((k - 1) / 1.1,) + radii)
    nb = 40
    opts = dict(ens_size=k, nb=nb, degree=16, epsilon=1e-5, taper=taper,
                tile=tile)
    sp, mean = c["sp"].astype("f8"), c["mean"].astype("f8")
    packs = np.stack([table[f:f + width].T.copy() for f in off])
    for t in range(n_tiles):
        out_band = ((np.arange(width) < a[t])
                    | (np.arange(width) >= bands[2, t]))
        packs[t, k + 1, out_band] = np.finfo("f4").max
    ref = J._window2d_ref(
        jnp.asarray(packs), jnp.asarray(grid), jnp.asarray(sp),
        jnp.asarray(mean[:, None]), jnp.asarray(scal), n_dims=n_dims, **opts)
    out = T.window2d_plain(*(torch.from_numpy(x) for x in (
        table, bands, grid, sp, mean, scal)), width=width, strict=False,
        chunk=128, **opts)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_plain_nan_observation_poisons_only_where_it_weighs(rng):
    """A NaN in one observation's perturbations and innovation poisons the
    columns whose windows hold it at nonzero weight; the columns whose
    windows hold it at zero weight stay finite: a slot of zero weight is
    zeroed, not multiplied by its weight, as K6 leaves it out."""
    c = case_2d(rng, 24, 24, 80)
    k, o = c["perts"].shape
    c["perts"][:, o // 2] = np.nan
    c["innov"][o // 2] = np.nan
    block = J.required_obs_block_2d(c["obs_xy"][:, 1], c["grid_xy"][:, 1],
                                    2.0)
    args, width = T.window2d_inputs(
        *(torch.from_numpy(np.asarray(c[n])) for n in ARGS[:4]),
        torch.from_numpy(c["sp"]), torch.from_numpy(c["mean"]),
        (k - 1) / 1.1, 2.0, 2.0, block)
    kw = dict(width=width, ens_size=k, nb=64, degree=16, epsilon=1e-5,
              taper="gc2")
    out = T.window2d_plain(*args, strict=False, **kw)
    weighs, holds = [], []
    for _, sel, w, _ in T._window2d_windows(
            args[0], args[1], args[2], args[5], width=width, nb=64, k=k,
            epsilon=1e-5, taper="gc2", tile=128, chunk=16384):
        nan_slot = torch.isnan(sel[..., 0])
        weighs.append((nan_slot & (w > 0)).any(-1).reshape(-1))
        holds.append(nan_slot.any(-1).reshape(-1))
    weighs, holds = torch.cat(weighs), torch.cat(holds)
    assert torch.equal(torch.isnan(out).any(1).any(0), weighs)
    assert 0 < int(weighs.sum()) < int(holds.sum())


# -- the wrapper against the JAX kernel (interpret mode), f32 ----------------

CASES = {
    "banded": dict(),
    "banded ns2 gcinf": dict(ns=2, taper="gcinf"),
    "whole table": dict(block="all"),
    "radii 5 3, ragged grid": dict(radii=(5.0, 3.0), nr=21, nc=19, nb=80),
    "extra dim": dict(nz=3, radii=(4.0, 4.0), extra=(1.5,)),
    "extra dim whole table": dict(nz=2, extra=(2.0,), block="all"),
    "strict overflow": dict(nb=16),
    "strict overflow whole table": dict(nb=40, block="all"),
    "truncating, not strict": dict(nb=16, strict=False),
    "band overflow poison": dict(block=16, nb=80),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_matches_jax_kernel(rng, case):
    opts = dict(CASES[case])
    rx, ry = opts.pop("radii", (4.0, 4.0))
    block = opts.pop("block", None)
    extra = opts.pop("extra", ())
    kw = {n: opts.pop(n) for n in ("taper", "strict") if n in opts}
    nb = opts.pop("nb", 64)
    c = case_2d(rng, **opts)
    o = c["perts"].shape[1]
    if block is None:
        block = J.required_obs_block_2d(c["obs_xy"][:, 1], c["grid_xy"][:, 1],
                                        ry)
    elif block == "all":
        block = o
    kw.update(obs_block=block, nb=nb, degree=16, extra_radii=extra)
    ref = jax_2d(c, rx, ry, **kw)
    out = port_2d(c, rx, ry, **kw)
    assert out.shape == ref.shape and out.dtype == np.float32
    rel_close(out, ref)
    nan_cols = np.isnan(ref).any(axis=(0, 1)).sum()
    if "overflow" in case:
        assert 0 < nan_cols
    if case.startswith("strict"):
        assert nan_cols < ref.shape[-1]     # only the overflowing columns
    if "overflow" not in case:
        assert nan_cols == 0


def test_wrapper_two_dim_state_and_validation(rng):
    c = case_2d(rng, 12, 12, 30)
    c["sp"], c["mean"] = c["sp"][0], c["mean"][0]
    blk = J.required_obs_block_2d(c["obs_xy"][:, 1], c["grid_xy"][:, 1], 3.0)
    before = dict(T.LAUNCHES)
    out = port_2d(c, 3.0, 3.0, obs_block=blk, nb=30, degree=12)
    assert T.LAUNCHES == before            # CPU tensors: the plain version
    rel_close(out, jax_2d(c, 3.0, 3.0, obs_block=blk, nb=30, degree=12))
    with pytest.raises(ValueError, match="obs_block"):
        port_2d(c, 3.0, 3.0, obs_block=0)
    with pytest.raises(ValueError, match="coordinate columns"):
        port_2d(c, 3.0, 3.0, obs_block=blk, extra_radii=(1.0,))
    args = [torch.from_numpy(c[n]) for n in ARGS]
    with pytest.raises(TypeError):
        T.letkf_window_analysis_fused_2d(*args[:4], args[4].double(),
                                         args[5], 1.0, 3.0, 3.0, 8,
                                         obs_block=blk)
    g = c["grid_xy"].shape[0] // 128 * 128
    table = torch.zeros(40, 8 + 3)
    bands = torch.zeros(3, g // 128, dtype=torch.int64)
    with pytest.raises(ValueError, match="shapes"):
        T.window2d_banded(table, bands, torch.zeros(2, g),
                          torch.zeros(1, 8, g), torch.zeros(1, g),
                          torch.ones(3), width=16, ens_size=8)


# -- make_letkf_analysis(method="fused2d") -----------------------------------

def analysis_case(rng, nr=20, nc=20, o=60, k=8, nz=1):
    c = case_2d(rng, nr, nc, o, k=k, nz=nz, jitter=0.0)
    g = c["grid_xy"].shape[0]
    return (rng.normal(size=(k, g)), rng.normal(size=o),
            rng.uniform(0.5, 1.5, size=o), c["pos"].astype("i4"),
            c["grid_xy"], c["obs_xy"])


@pytest.mark.parametrize("variant", ["radius 4", "radii 5 3 bound",
                                     "3 coords", "obs_block given"])
def test_make_letkf_analysis_fused2d(rng, variant):
    n_dims = 3 if variant == "3 coords" else 2
    w = analysis_case(rng, 12, 12, 48, nz=3) if n_dims == 3 else \
        analysis_case(rng)
    w32 = [a.astype("f4") if a.dtype.kind == "f" else a for a in w]
    radii = {"radius 4": (4.0,), "radii 5 3 bound": (5.0, 3.0),
             "3 coords": (2.5, 2.5, 1.5)}.get(variant, (4.0, 4.0))
    jax_loc, port_loc = locs(radii, n_dims)
    opts = dict(method="fused2d", max_obs=60 if n_dims == 2 else 48,
                cheb_degree=32 if n_dims == 2 else 20)
    if variant == "obs_block given":
        opts["obs_block"] = J.required_obs_block_2d(w[5][:, 1], w[4][:, 1],
                                                    4.0)
    if variant.endswith("bound"):
        geometry = (w[3], w[4], w[5])
        ref = JA.make_letkf_analysis(jax_loc, 1.1, geometry=geometry,
                                     **opts)(*map(jnp.asarray, w32[:3]))
        out = TA.make_letkf_analysis(port_loc, 1.1, geometry=geometry,
                                     **opts)(*map(torch.from_numpy, w32[:3]))
    else:
        ref = JA.make_letkf_analysis(jax_loc, 1.1, **opts)(
            *map(jnp.asarray, w32))
        out = TA.make_letkf_analysis(port_loc, 1.1, **opts)(
            *map(torch.from_numpy, w32))
    assert out.dtype == torch.float32
    rel_close(out, ref)
    exact = JA.make_letkf_analysis(jax_loc, 1.1, method="eigh")(
        *map(jnp.asarray, w))
    rel_close(out, exact, tol=5e-4)


def test_fused2d_strict_raises_like_jax(rng):
    w = analysis_case(rng)
    jax_loc, port_loc = locs((4.0, 4.0))
    nb = J.max_in_support_2d(w[5], w[4], 4.0, 4.0) - 1
    for make, loc, conv in ((JA.make_letkf_analysis, jax_loc, jnp.asarray),
                            (TA.make_letkf_analysis, port_loc,
                             torch.from_numpy)):
        with pytest.raises(ValueError, match="in-support"):
            make(loc, 1.1, method="fused2d", max_obs=nb)(*map(conv, w))
        with pytest.raises(ValueError, match="in-support"):
            make(loc, 1.1, method="fused2d", max_obs=nb,
                 geometry=(w[3], w[4], w[5]))
    out = TA.make_letkf_analysis(port_loc, 1.1, method="fused2d", max_obs=nb,
                                 max_obs_strict=False)(
        *map(torch.from_numpy, w))
    assert torch.isfinite(out).all()


# -- the two repairs -----------------------------------------------------------

@pytest.mark.parametrize("radius", [6.0, 1.5])
def test_eigh_strict_window_overflow_gives_nan_like_jax(rng, radius):
    """k 8, g 64, o 40, GC r=6 (every column overflows) or 1.5 (some do),
    max_obs=4, strict window selection, f64: the overflowing columns are
    NaN on both sides, the others agree."""
    k, g, o = 8, 64, 40
    idx = np.sort(rng.choice(g, size=o, replace=False)).astype("i4")
    w = (rng.normal(size=(k, g)), rng.normal(size=o), np.full(o, 0.5), idx,
         np.arange(g, dtype="f8")[:, None], idx.astype("f8")[:, None])
    jl = jloc.GaspariCohn((radius,), jax_dist(1))
    opts = dict(method="eigh", max_obs=4, selection="window")
    ref = np.asarray(JA.make_letkf_analysis(jl, 1.1, **opts)(
        *map(jnp.asarray, w)))
    out = TA.make_letkf_analysis(convert.from_tpu_assim(jl, port_dist(1)),
                                 1.1, **opts)(*map(torch.from_numpy, w))
    nan_cols = np.isnan(ref).any(axis=0)
    assert 0 < nan_cols.sum() and (nan_cols.all() == (radius == 6.0))
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    np.testing.assert_allclose(out.numpy()[:, ~nan_cols],
                               ref[:, ~nan_cols], rtol=TOL, atol=TOL)


def test_from_tpu_assim_defaults_to_the_card(rng):
    from tpu_assim import EnsembleState as JState

    default = inspect.signature(convert.from_tpu_assim).parameters["device"]
    assert default.default == "cuda"
    js = JState(jnp.asarray(rng.normal(size=(1, 1, 4, 6))),
                times=np.zeros(1), grid_coords=np.arange(6.0)[:, None])
    if torch.cuda.is_available():
        assert convert.from_tpu_assim(js).data.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            convert.from_tpu_assim(js)
    assert convert.from_tpu_assim(js, device="cpu").data.device.type == "cpu"
