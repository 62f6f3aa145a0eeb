"""
Parity of the PyTorch port's localization, linear-algebra and ETKF cores
(tpu_assim_torch.ops.localization / linalg / etkf, interface.mixin_local,
convert) against the JAX package on the same numpy inputs, in f64 at 1e-10.
Weight matrices and recompositions are compared, never eigenvectors, whose
signs are arbitrary.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim.interface import mixin_local as jml
from tpu_assim.models import Lorenz96 as JLorenz96
from tpu_assim.models import RK4Integrator as JRK4
from tpu_assim.ops import etkf as je
from tpu_assim.ops import linalg as jl
from tpu_assim.ops import localization as jloc

from tpu_assim_torch import convert
from tpu_assim_torch.interface import mixin_local as tml
from tpu_assim_torch.ops import etkf as te
from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops import localization as tloc

TOL = 1e-10


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def spd_batch(rng, batch=6, n=7, rank=None):
    a = rng.normal(size=(batch, n, rank or n))
    return a @ np.swapaxes(a, -1, -2)


# -- localization ----------------------------------------------------------

def test_safe_sqrt_values_and_zero_gradient(rng):
    w = np.abs(rng.normal(size=20))
    w[[0, 5, 7]] = 0.0
    close(tloc.safe_sqrt(t(w)), jloc.safe_sqrt(jnp.asarray(w)))
    x = t(w).requires_grad_(True)
    tloc.safe_sqrt(x).sum().backward()
    assert torch.isfinite(x.grad).all()
    assert (x.grad[[0, 5, 7]] == 0).all()


def test_abs_and_periodic_distance(rng):
    grid = rng.uniform(0, 40, size=2)
    obs = rng.uniform(0, 40, size=(15, 2))
    close(tloc.abs_distance(t(grid), t(obs)),
          jloc.abs_distance(jnp.asarray(grid), jnp.asarray(obs)))
    close(tloc.periodic_distance(40.0)(t(grid), t(obs)),
          jloc.periodic_distance(40.0)(jnp.asarray(grid), jnp.asarray(obs)))


@pytest.mark.parametrize("kind", ["gc2", "gc2_2d", "gcinf"])
def test_taper_weights_match(rng, kind):
    grid = np.concatenate([np.zeros((50, 1)), rng.uniform(0, 60, (50, 2))],
                          axis=1)
    obs = np.concatenate([np.zeros((30, 1)), rng.uniform(0, 60, (30, 2))],
                         axis=1)
    if kind == "gc2":
        jax_loc = jloc.GaspariCohn((7.0,), jax_coord1)
        dist = None
    elif kind == "gc2_2d":
        jax_loc = jloc.GaspariCohn(
            (7.0, 11.0), lambda gc, oi: jloc.abs_distance(gc[1:], oi[:, 1:]))
        dist = lambda gc, oi: tloc.abs_distance(gc[1:], oi[:, 1:])  # noqa
    else:
        jax_loc = jloc.GaspariCohnInf(9.0, jax_coord1)
        dist = None
    port = convert.from_tpu_assim(jax_loc, dist)
    ref = jax_loc.taper_weights(jnp.asarray(grid), jnp.asarray(obs))
    out = port.taper_weights(t(grid), t(obs))
    assert out.shape == ref.shape
    close(out, ref)
    assert (out > 0).any() and (out == 0).any()


@pytest.mark.parametrize("cls", ["GaspariCohn", "GaspariCohnInf"])
def test_taper_polynomial_statics(cls):
    z = np.linspace(0.05, 2.5, 101)
    jcls, tcls = getattr(jloc, cls), getattr(tloc, cls)
    for name in ("_f1", "_f2", "_f3", "_f4"):
        if hasattr(jcls, name):
            close(getattr(tcls, name)(t(z)), getattr(jcls, name)(jnp.asarray(z)))


@pytest.mark.parametrize("taper", ["gc2", "gcinf"])
@pytest.mark.parametrize("epsilon", [0.0, 1e-5, 1e-2, 0.5, 2.0])
def test_taper_support_z_equal(taper, epsilon):
    assert tloc.taper_support_z(taper, epsilon) == jloc.taper_support_z(
        taper, epsilon)


def test_taper_support_z_rejects_unknown():
    with pytest.raises(ValueError):
        tloc.taper_support_z("box")


# -- linalg ----------------------------------------------------------------

def test_evd_and_rev_evd(rng):
    a = spd_batch(rng, rank=3)
    ev_t, u_t, inv_t = tl.evd(t(a), 0.7)
    ev_j, u_j, inv_j = jl.evd(jnp.asarray(a), 0.7)
    close(ev_t, ev_j)
    close(inv_t, inv_j)
    close(tl.rev_evd(ev_t, u_t), jl.rev_evd(ev_j, u_j))
    close(tl.rev_evd(ev_t, u_t), a + 0.7 * np.eye(7), 1e-9)


def test_eigh_psd_recomposes(rng):
    a = spd_batch(rng)
    evals, evects = tl.eigh_psd(t(a))
    close(evals, jl.eigh_psd(jnp.asarray(a), use_jacobi=False)[0])
    close(tl.rev_evd(evals, evects), a, 1e-9)


def test_inv_and_inv_sqrt_psd_eigh(rng):
    a = spd_batch(rng, rank=4)
    inv_t, isq_t = tl.inv_and_inv_sqrt_psd_eigh(t(a), 2.5)
    inv_j, isq_j = jl.inv_and_inv_sqrt_psd_eigh(jnp.asarray(a), 2.5)
    close(inv_t, inv_j)
    close(isq_t, isq_j)


def test_matrix_product_and_diagonal_add(rng):
    x = rng.normal(size=(3, 5, 8))
    y = rng.normal(size=(3, 4, 8))
    close(tl.matrix_product(t(x), t(y)),
          jl.matrix_product(jnp.asarray(x), jnp.asarray(y)))
    m = rng.normal(size=(3, 6, 6))
    close(tl.diagonal_add(t(m), 1.5), jl.diagonal_add(jnp.asarray(m), 1.5))


# -- etkf ------------------------------------------------------------------

def test_etkf_prior_weights():
    close(te.etkf_prior_weights(6, 1.3), je.etkf_prior_weights(6, 1.3))


def test_etkf_weights_from_gram(rng):
    z = rng.normal(size=(5, 10, 30))
    y = rng.normal(size=(5, 30))
    gram = z @ np.swapaxes(z, -1, -2)
    zy = (z @ y[..., None])
    out_t = te.etkf_weights_from_gram(t(gram), t(zy), 10, 1.2)
    out_j = je.etkf_weights_from_gram(jnp.asarray(gram), jnp.asarray(zy), 10,
                                      1.2)
    for a, b in zip(out_t, out_j):
        close(a, b)


@pytest.mark.parametrize("n_obs", [0, 25])
def test_etkf_weights(rng, n_obs):
    perts = rng.normal(size=(9, n_obs))
    obs = rng.normal(size=(1, n_obs))
    close(te.etkf_weights(t(perts), t(obs), 1.1),
          je.etkf_weights(jnp.asarray(perts), jnp.asarray(obs), 1.1))


def test_letkf_weights_dense(rng):
    perts = rng.normal(size=(8, 40))
    innov = rng.normal(size=40)
    w = np.abs(rng.normal(size=(12, 40)))
    w[w < 0.5] = 0.0
    w[3] = 0.0  # an obs-free column: the inflated prior
    out = te.letkf_weights_dense(t(perts), t(innov), t(w), 1.1)
    ref = je.letkf_weights_dense(jnp.asarray(perts), jnp.asarray(innov),
                                 jnp.asarray(w), 1.1)
    close(out, ref)
    close(out[3], np.sqrt(1.1) * np.eye(8))


@pytest.mark.parametrize("method", ["newton", "woodbury"])
def test_unported_solvers_raise(rng, method):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te.etkf_weights_from_gram(t(np.eye(3)[None]), t(np.ones((1, 3, 1))),
                                  3, method=method)


# -- mixin_local -----------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 7, 50, 64])
def test_map_grid_chunked(rng, chunk):
    grid = rng.normal(size=(50, 2))

    def fn_t(c):
        return torch.stack([c.sum(1), c.prod(1)], dim=1)

    def fn_j(c):
        return jnp.stack([c.sum(1), c.prod(1)], axis=1)

    close(tml.map_grid_chunked(fn_t, t(grid), chunk),
          jml.map_grid_chunked(fn_j, jnp.asarray(grid), chunk))


# -- convert ---------------------------------------------------------------

def test_arrays_to_torch_keeps_integer_arrays():
    f, i, none = convert.arrays_to_torch(
        [np.ones(3), np.arange(3, dtype=np.int32), None], "cpu",
        torch.float32)
    assert f.dtype == torch.float32 and i.dtype == torch.int32
    assert none is None


def test_from_tpu_assim_objects():
    integ = convert.from_tpu_assim(JRK4(JLorenz96(8.5), dt=0.025))
    assert integ.dt == 0.025 and integ.model.forcing == 8.5
    gc = convert.from_tpu_assim(jloc.GaspariCohn((3.0, 4.0), jax_coord1,
                                                 epsilon=1e-4))
    assert list(gc.radius) == [3.0, 4.0] and gc.epsilon == 1e-4
    assert gc.dist_func is convert.coord1_distance
    gci = convert.from_tpu_assim(jloc.GaspariCohnInf(5.0, jax_coord1))
    assert isinstance(gci, tloc.GaspariCohnInf) and gci.radius == 5.0
    with pytest.raises(TypeError):
        convert.from_tpu_assim(object())
