"""
Gradients through the port's window and neighborhood kernels K1, K4 and K6
(``tpu_assim_torch.ops.cuda.letkf``: ``_Window1D``, ``_NbhCheb``,
``_Window2D``), against the JAX package's custom VJPs on the same numpy
inputs. On the CPU each Function's forward is its plain version; its
backward, the same on either device, replays the plain version.

- ``gradcheck`` in f64 (fast mode: random projections of the Jacobian)
  of each Function, every differentiable input including ``reg``. The
  inputs that reach the Chebyshev coefficients (the
  perturbations, the coordinates, ``reg``) go through coefficients rounded
  to f32, as the JAX twin rounds them (``_cheb_solve_apply``), so finite
  differences carry ~1.2e-7 / eps of rounding noise: those are checked at
  eps 1e-3 within 5e-4 absolute (1e-3 relative), the rest at gradcheck's
  defaults.
- Each backward in f64 against ``jax.vjp`` of JAX's own reference
  (``_window_analysis_ref``, ``_cheb_solve_apply``, ``_window2d_dma_ref``)
  at 1e-10, with ``o >= nb``.
- Each route in f32 against ``jax.grad`` through JAX's custom-VJP function,
  its kernel in interpret mode: within 1e-5 of max|JAX gradient|.
- The counterparts of ``tests/test_differentiable.py``'s
  ``TestFusedKernelVJP`` and ``TestFused2DVJP`` at JAX's bounds (fused1d
  and cheb against newton 2e-5, rho against finite differences rtol 1e-3,
  fused2d against newton 3e-5) and of
  ``test_lketkf_cheb_grad_through_kernel_params``.
- The inflation's gradient, which the wrappers cut before (``float(reg)``),
  reaches rho through fused1d, cheb, fused2d and the x-strips.
- At ``o < nb`` K1's gradient is that of the port's own forward (finite
  differences); JAX's reference counts the last observation several times
  there (ROADMAP Queue 3).
- A loss over the healthy columns of a strict-poisoned analysis has finite
  gradients.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_assim import analysis as JA
from tpu_assim.interface.lketkf import _lketkf_cheb_analysis as j_lketkf_cheb
from tpu_assim.ops import kernels as jkernels
from tpu_assim.ops import localization as jloc
from tpu_assim.ops.pallas import letkf as J
from tpu_assim.testing import dummy_distance as j_dummy_distance

from tpu_assim_torch import analysis as TA
from tpu_assim_torch import convert
from tpu_assim_torch.interface.lketkf import _lketkf_cheb_analysis
from tpu_assim_torch.ops import kernels as tkernels
from tpu_assim_torch.ops.cuda import letkf as T
from tpu_assim_torch.ops.localization import GaspariCohn, GaspariCohnInf
from tpu_assim_torch.testing import dummy_distance

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

# gradcheck of the inputs that reach the f32-rounded Chebyshev coefficients
COEF_CHECK = dict(eps=1e-3, atol=5e-4, rtol=1e-3)
K1_STATICS = dict(radius=2.5, ens_size=6, nb=8, degree=10, epsilon=1e-5)


def tensors(arrays, grad=True):
    return [torch.tensor(a, requires_grad=grad and a.dtype.kind == "f")
            for a in arrays]


def k1_arrays(seed, k=6, o=20, g=24, ns=1):
    """K1's inputs from a seed: sorted observation coordinates on [0, g)."""
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(k, o)), rng.normal(size=o),
            np.sort(rng.uniform(0, g, size=o)), np.arange(g, dtype=float),
            rng.normal(size=(ns, k, g)), rng.normal(size=(ns, g)),
            np.array((k - 1) / 1.1)]


def k1_fn(taper="gc2", **kw):
    st = dict(K1_STATICS, **kw)
    return lambda *a: T._Window1D.apply(
        *a, st["radius"], st["ens_size"], st["nb"], st["degree"],
        st["epsilon"], taper, False)


def k4_arrays(seed, k=6, nb=8, g=24, ns=1):
    rng = np.random.RandomState(seed)
    sw = np.sqrt(rng.uniform(size=(nb, g)))
    return [rng.normal(size=(nb, k, g)) * sw[:, None], rng.normal(
        size=(nb, g)) * sw, rng.normal(size=(ns, k, g)),
        rng.normal(size=(ns, g)), np.array((k - 1) / 1.1)]


def k6_arrays(seed, k=6, nr=12, nc=12, o=40, nb=8, block="band"):
    """K6's inputs in f64: a 12 x 12 row-major grid, ``o`` observations at
    random cells shifted off the grid points, tables and bands from
    ``window2d_inputs`` (banded: each tile's y-band; "all": every tile
    takes the whole table). Returns (arrays, width, nb)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(nr, dtype="f8"), np.arange(nc, dtype="f8"),
                         indexing="ij")
    grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
    cells = rng.choice(nr * nc, size=o, replace=False)
    obs_xy = grid_xy[cells] + rng.uniform(-0.4, 0.4, size=(o, 2))
    ry = 3.0
    ob = (o if block == "all"
          else J.required_obs_block_2d(obs_xy[:, 1], grid_xy[:, 1], ry))
    f32 = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.normal(size=(k, o)), rng.normal(size=o), obs_xy, grid_xy,
        rng.normal(size=(1, k, nr * nc)), rng.normal(size=(1, nr * nc)))]
    (table, bands, grid, sp, mean, scal), width = T.window2d_inputs(
        *f32, (k - 1) / 1.1, 3.5, ry, ob)
    arrays = [table.double().numpy(), bands.numpy(), grid.double().numpy(),
              sp.double().numpy(), mean.double().numpy(),
              scal.double().numpy()]
    return arrays, width, nb


def k6_fn(width, nb, k=6, degree=10):
    return lambda *a: T._Window2D.apply(*a, width, k, nb, degree, 1e-5,
                                        "gc2", False, 128)


def gradcheck_split(fn, arrays, exact):
    """gradcheck of ``fn`` at its defaults in the inputs named by the
    indices ``exact`` (linear paths), then at ``COEF_CHECK`` in every
    floating input."""
    xs = tensors(arrays, grad=False)
    for i in exact:
        xs[i].requires_grad_()
    assert torch.autograd.gradcheck(fn, xs, fast_mode=True)
    xs = tensors(arrays)
    assert torch.autograd.gradcheck(fn, xs, fast_mode=True, **COEF_CHECK)


# -- gradcheck in f64 ---------------------------------------------------------

@pytest.mark.parametrize("taper,ns", [("gc2", 1), ("gcinf", 2)])
def test_gradcheck_window1d(taper, ns):
    """``_Window1D`` in perts, innov, obs_x, grid_x, sp, mean and reg: k 6,
    o 20, g 24, nb 8, degree 10 (truncating windows, strict off)."""
    gradcheck_split(k1_fn(taper), k1_arrays(3, ns=ns), exact=(1, 4, 5))


def test_gradcheck_nbh_cheb():
    """``_NbhCheb`` in zh, yh, sp, mean and reg: nb 8, k 6, g 24, degree
    10."""
    def fn(*a):
        return T._NbhCheb.apply(*a, 6, 10)

    gradcheck_split(fn, k4_arrays(5, ns=2), exact=(1, 2, 3))


@pytest.mark.parametrize("block", ["band", "all"])
def test_gradcheck_window2d(block):
    """``_Window2D`` in table, grid, sp, mean and scal (reg and radii): a
    12 x 12 grid (two tiles, the second padded), 40 observations, nb 8,
    degree 10; ``bands`` is int32 and gets no gradient."""
    arrays, width, nb = k6_arrays(7, block=block)
    fn = k6_fn(width, nb)
    gradcheck_split(fn, arrays, exact=(3, 4))
    xs = tensors(arrays)
    assert not xs[1].requires_grad
    grads = torch.autograd.grad(fn(*xs).sum(), [x for x in xs
                                                if x.requires_grad])
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[0][:, -2:].abs().max()) > 0   # the coordinates


# -- each backward against jax.vjp of JAX's reference, f64 --------------------

def vjp_close(port_grads, jax_grads, tol=1e-10):
    for p, j in zip(port_grads, jax_grads):
        np.testing.assert_allclose(p.numpy(), np.asarray(j).reshape(p.shape),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
def test_window1d_backward_matches_jax_vjp(taper):
    arrays = k1_arrays(11, ns=2, o=24)
    xs = tensors(arrays)
    out = k1_fn(taper)(*xs)
    ct = np.random.RandomState(12).normal(size=out.shape)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(ct))
    st = K1_STATICS

    def ref(p, i, ox, gx, s, m, r):
        return J._window_analysis_ref(
            p, i, ox, gx, s, m[:, None, :], jnp.stack([r, st["radius"]]),
            ens_size=st["ens_size"], nb=st["nb"], degree=st["degree"],
            epsilon=st["epsilon"], taper=taper)

    ref_out, vjp = jax.vjp(jax.jit(ref), *map(jnp.asarray, arrays))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=1e-10, atol=1e-10)
    vjp_close(grads, vjp(jnp.asarray(ct)))


def test_nbh_cheb_backward_matches_jax_vjp():
    arrays = k4_arrays(13, ns=3)
    xs = tensors(arrays)
    out = T._NbhCheb.apply(*xs, 6, 10)
    ct = np.random.RandomState(14).normal(size=out.shape)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(ct))
    nodes, dct = (jnp.asarray(a) for a in J._cheb_nodes_dct(10))

    def ref(zh, yh, sp, mean, reg):
        return J._cheb_solve_apply(nodes, dct, zh, yh, sp, mean[:, None, :],
                                   reg, 6, 10)

    _, vjp = jax.vjp(jax.jit(ref), *map(jnp.asarray, arrays))
    vjp_close(grads, vjp(jnp.asarray(ct)))


@pytest.mark.parametrize("block", ["band", "all"])
def test_window2d_backward_matches_jax_vjp(block):
    """Against ``_window2d_dma_ref`` (the backward of ``_window2d_dma_call``;
    the port's table is its slot-major ``pack_full``), nb 16 with every band
    holding at least 16 observations: the gradients in the innovations, sp
    and mean at 1e-10; those that reach the Chebyshev coefficients (the
    perturbation and coordinate columns of the table, the grid, scal)
    within 1e-7 of their max. JAX rounds the coefficients' cotangents to f32
    in its batched product (XLA's own order of summation there, which the
    port's f32 product does not share at this size), so its f64 gradient is
    f32-accurate on that path; the port's differs from it by ~1e-8 of the
    max."""
    arrays, width, _ = k6_arrays(15, o=60, block=block)
    nb = 16
    xs = tensors(arrays)
    out = k6_fn(width, nb)(*xs)
    ct = np.random.RandomState(16).normal(size=out.shape)
    grads = torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                                torch.from_numpy(ct))

    x_row = 6 + 1
    big = np.finfo(np.float32).max

    def ref(pack, grid, sp, mean, scal):
        # _window2d_dma_ref with each tile's slice cut at its static offset
        # (its dynamic_slice fails to transpose with float64 enabled)
        tiles = []
        for off, a, b in arrays[1].T:
            blk = pack[off:off + width].T
            iota = jnp.arange(width)
            xm = jnp.where((iota >= a) & (iota < b), blk[x_row], big)
            tiles.append(jnp.concatenate(
                [blk[:x_row], xm[None, :], blk[x_row + 1:]], axis=0))
        return J._window2d_ref(
            jnp.stack(tiles), grid, sp, mean[:, None, :], scal, ens_size=6,
            nb=nb, degree=10, epsilon=1e-5, taper="gc2", tile=128, n_dims=2)

    ref_out, vjp = jax.vjp(jax.jit(ref), *(jnp.asarray(arrays[i])
                                  for i in (0, 2, 3, 4, 5)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=1e-10, atol=1e-10)
    ref_grads = [np.asarray(j) for j in vjp(jnp.asarray(ct))]
    # the innovation column, sp and mean do not reach the coefficients
    vjp_close([grads[0][:, 6], grads[2], grads[3]],
              [ref_grads[0][:, 6], ref_grads[2], ref_grads[3]])
    for p, j in zip((grads[0], grads[1], grads[4]),
                    (ref_grads[0], ref_grads[1], ref_grads[4])):
        assert np.abs(p.numpy() - j).max() <= 1e-7 * np.abs(j).max()


# -- each route in f32 against jax.grad through JAX's custom VJPs -------------

def graph_names(out):
    """The names of the backward nodes that produced ``out``."""
    names, todo = [], [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None:
            names.append(node.name())
            todo.extend(n for n, _ in node.next_functions)
    return " ".join(names)


def grads_close(port, ref, tol=1e-5):
    """Each port gradient within ``tol`` of max|JAX gradient|."""
    for p, j in zip(port, ref):
        p = p.double().numpy()
        j = np.asarray(j, np.float64).reshape(p.shape)
        assert np.isfinite(p).all() and np.isfinite(j).all()
        scale = np.abs(j).max()
        assert scale > 0
        assert np.abs(p - j).max() <= tol * scale, (
            np.abs(p - j).max() / scale)


def test_fused1d_grads_match_jax_kernel_vjp():
    """``letkf_window_analysis_fused`` against JAX's (``_window_call``) in
    f32: every input, reg included; k 8, o 48, g 128, nb 12, degree 16."""
    rng = np.random.RandomState(21)
    k, o, g = 8, 48, 128
    arrays = [a.astype(np.float32) for a in (
        rng.normal(size=(k, o)), rng.normal(size=o),
        np.sort(rng.uniform(0, g, size=o)), np.arange(g),
        rng.normal(size=(k, g)), rng.normal(size=g),
        np.array((k - 1) / 1.1))]
    ct = rng.normal(size=(k, g)).astype(np.float32)
    kw = dict(nb=12, degree=16, taper="gc2")

    def jax_loss(*a):
        return jnp.sum(J.letkf_window_analysis_fused(
            *a[:6], a[6], 4.0, k, interpret=True, **kw) * ct)

    ref = jax.jit(jax.grad(jax_loss, argnums=tuple(range(7))))(
        *map(jnp.asarray, arrays))
    xs = tensors(arrays)
    out = T.letkf_window_analysis_fused(*xs[:6], xs[6], 4.0, k, **kw)
    assert "_Window1D" in graph_names(out)
    grads_close(torch.autograd.grad((out * torch.from_numpy(ct)).sum(), xs),
                ref)


def test_nbh_cheb_grads_match_jax_kernel_vjp():
    """``letkf_nbh_analysis_cheb`` against JAX's (``_cheb_call``) in f32,
    ns 2: zh, yh, sp, mean and reg."""
    arrays = [a.astype(np.float32) for a in k4_arrays(22, k=8, nb=12, g=160,
                                                       ns=2)]
    ct = np.random.RandomState(23).normal(size=(2, 8, 160)).astype(
        np.float32)

    def jax_loss(*a):
        return jnp.sum(J.letkf_nbh_analysis_cheb(
            *a, 8, degree=16, interpret=True) * ct)

    ref = jax.jit(jax.grad(jax_loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, arrays))
    xs = tensors(arrays)
    out = T.letkf_nbh_analysis_cheb(*xs, 8, degree=16)
    assert "_NbhCheb" in graph_names(out)
    grads_close(torch.autograd.grad((out * torch.from_numpy(ct)).sum(), xs),
                ref)


def jax_dist2(gc, oi):
    return jnp.stack([jnp.abs(oi[:, 1] - gc[1]), jnp.abs(oi[:, 2] - gc[2])],
                     0)


def port_dist2(gc, oi):
    return torch.stack([torch.abs(oi[:, 1] - gc[1]),
                        torch.abs(oi[:, 2] - gc[2])], 0)


def workload_2d(rng, nr=12, nc=12, ens=8, o=40):
    """The 2-D workload of ``TestFused2DVJP`` (f64)."""
    yy, xx = np.meshgrid(np.arange(nr, dtype="f8"), np.arange(nc, dtype="f8"),
                         indexing="ij")
    grid_xy = np.stack([xx.ravel(), yy.ravel()], 1)
    state = rng.normal(size=(ens, nr * nc))
    obs_idx = rng.choice(nr * nc, size=o, replace=False)
    return (state, rng.normal(size=o), rng.uniform(0.5, 1.5, size=o),
            obs_idx.astype("i4"), grid_xy, grid_xy[obs_idx])


@pytest.mark.parametrize("route", ["fused2d", "strips"])
def test_2d_grads_match_jax_kernel_vjp(route):
    """``make_letkf_analysis(method="fused2d")`` (one K6 call over the
    whole table) and ``make_strip_letkf_2d`` (3 x-strips) against JAX's
    (``_window2d_dma_call`` / ``_window2d_call``) in f32: the gradients in
    the state and in rho."""
    rng = np.random.RandomState(24)
    w = workload_2d(rng, nr=16, nc=24, o=64)
    state, obs_vals, obs_var, cells, grid_xy, obs_xy = w
    f32 = [a.astype(np.float32) for a in (state, obs_vals, obs_var)]
    jl = jloc.GaspariCohn((3.5,), jax_dist2)
    tl = convert.from_tpu_assim(jl, port_dist2, device="cpu")
    ct = rng.normal(size=state.shape).astype(np.float32)
    if route == "fused2d":
        # the band width given: JAX's fused2d cannot compute it under jit
        opts = dict(max_obs=40, cheb_degree=24,
                    obs_block=J.required_obs_block_2d(obs_xy[:, 1],
                                                      grid_xy[:, 1], 3.5))

        def jax_fn(rho):
            return JA.make_letkf_analysis(jl, rho, method="fused2d",
                                          **opts)

        def port_fn(rho):
            return TA.make_letkf_analysis(tl, rho, method="fused2d", **opts)

        rest = (cells, grid_xy, obs_xy)
    else:
        opts = dict(n_strips=3, max_obs=40, cheb_degree=24)

        def jax_fn(rho):
            return JA.make_strip_letkf_2d(jl, (cells, grid_xy, obs_xy),
                                          inf_factor=rho, **opts)

        def port_fn(rho):
            return TA.make_strip_letkf_2d(tl, (cells, grid_xy, obs_xy),
                                          inf_factor=rho, **opts)

        rest = ()

    def jax_loss(x, rho):
        return jnp.sum(jax_fn(rho)(x, *map(jnp.asarray, f32[1:] + list(
            rest))) * ct)

    # in f32 mode, as on the TPU: with float64 enabled the transpose of the
    # JAX strips' dynamic_slice mixes int32 and int64 offsets and fails
    with jax.enable_x64(False):
        ref = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
            jnp.asarray(f32[0]), jnp.asarray(1.1, jnp.float32))
    x = torch.tensor(f32[0], requires_grad=True)
    rho = torch.tensor(1.1, requires_grad=True)
    out = port_fn(rho)(x, *(torch.as_tensor(a) for a in f32[1:]
                             + list(rest)))
    grads_close(torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                    (x, rho)), ref)


# -- the counterparts of TestFusedKernelVJP and TestFused2DVJP ----------------

def workload_1d(rng, ens=8, g_pts=48, o=16):
    """The 1-D workload of ``TestFusedKernelVJP`` (f64)."""
    state = rng.normal(size=(ens, g_pts))
    obs_idx = np.sort(rng.choice(g_pts, size=o, replace=False))
    grid_coords = np.arange(g_pts, dtype="f8")[:, None]
    return [torch.as_tensor(a) for a in (
        state, rng.normal(size=o), np.full((o,), 0.5), obs_idx, grid_coords,
        grid_coords[obs_idx])]


def port_dist1(gc, oi):
    return torch.abs(oi[:, 1] - gc[1])[None, :]


def state_grad(method, args, loc, **kw):
    analyse = TA.make_letkf_analysis(loc, 1.1, method=method,
                                     newton_iters=40, **kw)
    x = args[0].clone().requires_grad_()
    (grad,) = torch.autograd.grad(
        (analyse(x, *args[1:]) ** 2).sum(), x)
    return grad


@pytest.mark.parametrize("method", ["cheb", "fused1d"])
def test_fused_grad_matches_newton(rng, method):
    """``TestFusedKernelVJP.test_fused_grad_matches_newton``: 2e-5 of
    max|newton gradient|."""
    args = workload_1d(rng)
    loc = GaspariCohn((5.0,), port_dist1)
    g_fast = state_grad(method, args, loc, max_obs=12, cheb_degree=30)
    g_ref = state_grad("newton", args, loc, max_obs=12, cheb_degree=30)
    assert bool(torch.isfinite(g_fast).all())
    scale = float(g_ref.abs().max())
    np.testing.assert_allclose(g_fast.numpy() / scale, g_ref.numpy() / scale,
                               atol=2e-5, rtol=0)


def test_fused2d_grad_matches_newton(rng):
    """``TestFused2DVJP.test_fused2d_grad_matches_newton``: 3e-5 of
    max|newton gradient|."""
    w = [torch.as_tensor(a) for a in workload_2d(rng)]
    loc = GaspariCohn((3.5,), port_dist2)
    g_fast = state_grad("fused2d", w, loc, max_obs=40, cheb_degree=30)
    g_ref = state_grad("newton", w, loc, max_obs=40, cheb_degree=30)
    assert bool(torch.isfinite(g_fast).all())
    scale = float(g_ref.abs().max())
    np.testing.assert_allclose(g_fast.numpy() / scale, g_ref.numpy() / scale,
                               atol=3e-5, rtol=0)


def rho_loss(route, rng):
    """``loss(rho)``: sum(analysis^2) through ``route`` on the workloads of
    ``TestFusedKernelVJP`` (1-D) and ``TestFused2DVJP`` (2-D, and 3
    x-strips)."""
    if route in ("fused1d", "cheb"):
        args = workload_1d(rng)
        loc = GaspariCohn((5.0,), port_dist1)
        return lambda rho: (TA.make_letkf_analysis(
            loc, rho, method=route, max_obs=12, cheb_degree=30)(*args)
            ** 2).sum()
    w = [torch.as_tensor(a) for a in workload_2d(rng)]
    loc = GaspariCohn((3.5,), port_dist2)
    if route == "fused2d":
        return lambda rho: (TA.make_letkf_analysis(
            loc, rho, method="fused2d", max_obs=40, cheb_degree=30)(*w)
            ** 2).sum()
    geometry = (w[3].numpy(), w[4].numpy(), w[5].numpy())
    return lambda rho: (TA.make_strip_letkf_2d(
        loc, geometry, 3, inf_factor=rho, max_obs=40, cheb_degree=30)(
        *w[:3]) ** 2).sum()


@pytest.mark.parametrize("route", ["fused1d", "cheb", "fused2d", "strips"])
def test_inf_factor_grad_matches_finite_differences(rng, route):
    """``TestFusedKernelVJP.test_fused_inf_factor_grad`` (fused1d there)
    on every route of K1, K4 and K6: d loss / d rho against central
    differences of eps 1e-3, rtol 1e-3. The wrappers used to cut this
    gradient (``float(reg)``, and ``torch.tensor([reg, ...])`` in the
    strips): no tensor that requires a gradient becomes a number now."""
    loss = rho_loss(route, rng)
    rho = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (g,) = torch.autograd.grad(loss(rho), rho)
    eps = 1e-3
    with torch.no_grad():
        fd = (loss(torch.tensor(1.1 + eps, dtype=torch.float64))
              - loss(torch.tensor(1.1 - eps, dtype=torch.float64))) / (2 * eps)
    assert np.isfinite(float(g)) and float(g) != 0.0
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)


def test_lketkf_cheb_grad_through_kernel_params(rng):
    """``TestRound5PathsDifferentiable.test_lketkf_cheb_grad_through_
    kernel_params`` on the port's ``testing.dummy_distance``: finite,
    nonzero gradients in the lengthscale and the inflation, the
    lengthscale's against central differences (rtol 1e-4), both against
    JAX's at 1e-8."""
    g, k, o = 24, 6, 16
    perts = rng.randn(k, o)
    innov = rng.randn(o)
    gi = np.concatenate([np.zeros((g, 1)), np.arange(g, dtype=float)[:, None]],
                        1)
    oi = np.concatenate([np.zeros((o, 1)),
                         np.sort(rng.uniform(0, g, size=o))[:, None]], 1)
    data = rng.randn(1, 1, k, g)

    def loss(lengthscale, inf):
        out = _lketkf_cheb_analysis(
            GaspariCohn((6.0,), dummy_distance), None, None, "topk", True,
            24, tkernels.GaussKernel(lengthscale=lengthscale),
            *(torch.as_tensor(a) for a in (perts, innov, gi, oi)), inf,
            torch.as_tensor(data))
        return (out ** 2).sum()

    ls = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    inf = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    gl, gi_f = torch.autograd.grad(loss(ls, inf), (ls, inf))
    assert np.isfinite(float(gl)) and abs(float(gl)) > 0
    assert np.isfinite(float(gi_f)) and abs(float(gi_f)) > 0
    eps = 1e-5
    with torch.no_grad():
        fd = (float(loss(torch.tensor(2.0 + eps, dtype=torch.float64), 1.1))
              - float(loss(torch.tensor(2.0 - eps, dtype=torch.float64),
                           1.1))) / (2 * eps)
    np.testing.assert_allclose(float(gl), fd, rtol=1e-4)

    def jax_loss(lengthscale, inf_):
        out = j_lketkf_cheb(
            jloc.GaspariCohn((6.0,), j_dummy_distance), None, None, "topk",
            True, 24, jkernels.GaussKernel(lengthscale=lengthscale),
            *map(jnp.asarray, (perts, innov, gi, oi)), inf_,
            jnp.asarray(data))
        return jnp.sum(out ** 2)

    jl, ji = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(2.0),
                                                jnp.asarray(1.1))
    np.testing.assert_allclose([float(gl), float(gi_f)],
                               [float(jl), float(ji)], rtol=1e-8)


# -- the o < nb window, poisoned columns, dispatch ----------------------------

def test_window1d_grad_o_below_nb():
    """5 observations for 8 slots: K1's gradient is its own forward's
    (gradcheck), every observation counted once; JAX's reference clamps its
    gather and counts the last one several times, so its gradient differs
    (ROADMAP Queue 3)."""
    arrays = k1_arrays(31, o=5)
    fn = k1_fn()
    gradcheck_split(fn, arrays, exact=(1, 4, 5))
    xs = tensors(arrays)
    (g_port,) = torch.autograd.grad(fn(*xs).sum(), xs[1])
    st = K1_STATICS
    g_jax = jax.jit(jax.grad(lambda i: jnp.sum(J._window_analysis_ref(
        *map(jnp.asarray, arrays[:1]), i, *map(jnp.asarray, arrays[2:4]),
        jnp.asarray(arrays[4]), jnp.asarray(arrays[5])[:, None, :],
        jnp.asarray([float(arrays[6]), st["radius"]]),
        ens_size=st["ens_size"], nb=st["nb"], degree=st["degree"],
        epsilon=st["epsilon"], taper="gc2"))))(jnp.asarray(arrays[1]))
    assert np.abs(g_port.numpy() - np.asarray(g_jax)).max() > 1e-2


@pytest.mark.parametrize("route", ["fused1d", "fused2d"])
def test_healthy_columns_give_finite_grads(route):
    """A strict window that overflows NaN-poisons its columns in the
    forward (K1's and K6's own poison); the replay runs without it, so a
    loss over the other columns has finite gradients in the state and in
    rho."""
    rng = np.random.RandomState(41)
    if route == "fused1d":
        w = workload_1d(rng, g_pts=64, o=40)
        loc = GaspariCohn((5.0,), port_dist1)
        worst = T.max_in_support_1d(w[5][:, 0].numpy(), w[4][:, 0].numpy(),
                                    5.0)
    else:
        w = [torch.as_tensor(a) for a in workload_2d(rng, o=60)]
        loc = GaspariCohn((3.5,), port_dist2)
        worst = T.max_in_support_2d(w[5].numpy(), w[4].numpy(), 3.5, 3.5)
    nb = worst - 1                          # the worst columns overflow
    x = w[0].clone().requires_grad_()
    rho = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    analyse = TA.make_letkf_analysis(loc, rho, method=route, max_obs=nb,
                                     cheb_degree=16)
    with pytest.raises(ValueError, match="in-support"):
        analyse(x, *w[1:])                  # the host check, when strict
    strict = _strict_poisoned(route, [x] + w[1:], rho, nb)
    bad = torch.isnan(strict).any(0)
    assert 0 < int(bad.sum()) < bad.numel()
    loss = (strict[:, ~bad] ** 2).sum()
    gx, grho = torch.autograd.grad(loss, (x, rho))
    assert bool(torch.isfinite(gx).all()) and float(gx.abs().max()) > 0
    assert np.isfinite(float(grho)) and float(grho) != 0.0


def _strict_poisoned(route, w, rho, nb):
    """The strict analysis past the host check: the wrapper called directly
    with ``strict=True``, so that the kernel's own poison acts."""
    x = w[0]
    ens_obs = x[:, w[3].long()]
    perts, innov = TA._normalized_obs_space(ens_obs, w[1], w[2])
    k = x.shape[0]
    mean = x.mean(0)
    sp = x - mean
    f32 = [t.to(torch.float32) for t in (perts, innov, sp, mean)]
    reg = (k - 1) / rho
    if route == "fused1d":
        return T.letkf_window_analysis_fused(
            f32[0], f32[1], w[5][:, 0].float(), w[4][:, 0].float(), f32[2],
            f32[3], reg, 5.0, k, nb=nb, degree=16, strict=True)
    return T.letkf_window_analysis_fused_2d(
        f32[0], f32[1], w[5], w[4], f32[2], f32[3], reg, 3.5, 3.5, k,
        obs_block=w[1].shape[0], nb=nb, degree=16, strict=True)


def test_dispatch_and_no_graph_without_grad():
    """The Functions only where a graph is recorded; on CPU tensors no
    kernel is launched; ``reg`` as a number or an f64 tensor."""
    arrays = [a.astype(np.float32) for a in k1_arrays(51)]
    xs = tensors(arrays)
    before = dict(T.LAUNCHES)
    with torch.no_grad():
        out = T.letkf_window_analysis_fused(*xs[:6], xs[6], 2.5, 6, nb=8)
    assert out.grad_fn is None
    plain = T.letkf_window_analysis_fused(
        *(x.detach() for x in xs[:6]), 5 / 1.1, 2.5, 6, nb=8)
    assert plain.grad_fn is None
    out = T.letkf_window_analysis_fused(*xs[:6], 5 / 1.1, 2.5, 6, nb=8)
    assert "_Window1D" in graph_names(out)
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0,
                               equal_nan=True)
    reg64 = torch.tensor(5 / 1.1, dtype=torch.float64, requires_grad=True)
    out = T.letkf_window_analysis_fused(
        *(x.detach() for x in xs[:6]), reg64, 2.5, 6, nb=8)
    (g,) = torch.autograd.grad(out.sum(), reg64)
    assert g.dtype == torch.float64 and float(g) != 0.0
    assert T.LAUNCHES == before


def test_taper_poly_grad_finite_at_pad_coordinates():
    """``_taper_poly`` keeps its values and has a finite gradient at the
    +float32.max coordinates of K6's pad slots."""
    z = torch.tensor([0.0, 0.3, 0.7, 1.2, 1.7, 1.99, 2.0, 3.0,
                      float(np.finfo(np.float32).max) / 4.0],
                     requires_grad=True)
    x = z.detach()
    for taper, lo in (("gc2", 0.5), ("gcinf", 0.25)):
        w = T._taper_poly(z, taper, 1e-5)
        # the values of the unbounded clamp
        wide = torch.clamp(x, min=lo)
        if taper == "gc2":
            ref = torch.where(x < 2.0, GaspariCohn._f2(wide), 0.0)
            ref = torch.where(x < 1.0, GaspariCohn._f1(x), ref)
        else:
            ref = torch.where(x < 2.0, GaspariCohnInf._f4(wide), 0.0)
            ref = torch.where(x < 1.5, GaspariCohnInf._f3(wide), ref)
            ref = torch.where(x < 1.0, GaspariCohnInf._f2(wide), ref)
            ref = torch.where(x < 0.5, GaspariCohnInf._f1(x), ref)
        ref = torch.where(ref > 1e-5, ref, 0.0)
        assert torch.equal(w.detach(), ref)
        (g,) = torch.autograd.grad(w.sum(), z)
        assert bool(torch.isfinite(g).all())
        assert float(g[-1]) == 0.0
