"""
Parity of the PyTorch port's Lorenz-96 model, RK4 integrator and fused RK4
forecast (tpu_assim_torch.models) against the JAX package on the same numpy
inputs: the model and integrator in f64 at 1e-10; the fused forecast's
plain version against the JAX kernel in interpret mode in f32 within
1e-5 max|ref| (the two only reassociate the stage combination); its
gradient against jax.grad of the JAX kernel's VJP in f64 at 1e-10 and in
f32 within 1e-5 max|ref|. The CUDA kernel's tiling (rk4_plan) and its
emulation (rk4_tiles_plain) against the plain version, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim.models import Lorenz96 as JLorenz96
from tpu_assim.models import RK4Integrator as JRK4
from tpu_assim.models import integrate_trajectory as j_traj
from tpu_assim.models.pallas_forecast import fused_rk4_steps as j_fused

from tpu_assim_torch import convert
from tpu_assim_torch.models import (
    BaseIntegrator,
    Lorenz96,
    RK4Integrator,
    integrate_trajectory,
)
from tpu_assim_torch.models import cuda_forecast as cf

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.fixture
def state(rng):
    return rng.normal(size=(6, 40)) + 2.0


@pytest.mark.parametrize("forcing", ["scalar", "array"])
def test_lorenz96_matches(rng, state, forcing):
    f = 8.0 if forcing == "scalar" else rng.uniform(6, 10, size=40)
    out = Lorenz96(torch.from_numpy(f) if forcing == "array" else f)(
        torch.from_numpy(state))
    close(out, JLorenz96(f)(jnp.asarray(state)))


def test_lorenz96_neighbours():
    """Ring neighbours: x_{i+1} is roll(-1), x_{i-2} roll(2), x_{i-1}
    roll(1)."""
    x = torch.arange(8, dtype=torch.float64)
    i = 3
    want = (x[i + 1] - x[i - 2]) * x[i - 1] - x[i] + 8.0
    assert Lorenz96()(x)[i] == want
    assert Lorenz96()(x)[0] == (x[1] - x[6]) * x[7] - x[0] + 8.0


def test_rk4_integrate_matches(state):
    integ = convert.from_tpu_assim(JRK4(JLorenz96(), dt=0.05))
    close(integ.integrate(torch.from_numpy(state)),
          JRK4(JLorenz96(), dt=0.05).integrate(jnp.asarray(state)))


@pytest.mark.parametrize("save_every", [1, 3])
def test_integrate_trajectory_matches(state, save_every):
    out = integrate_trajectory(RK4Integrator(Lorenz96(), 0.05),
                               torch.from_numpy(state), 6, save_every)
    ref = j_traj(JRK4(JLorenz96(), 0.05), jnp.asarray(state), 6, save_every)
    assert out.shape == ref.shape
    close(out, ref)


def test_integrator_validation():
    with pytest.raises(ValueError):
        BaseIntegrator(Lorenz96(), dt=0)
    with pytest.raises(TypeError):
        BaseIntegrator(Lorenz96(), dt="0.1")
    with pytest.raises(TypeError):
        BaseIntegrator(42)
    with pytest.raises(ValueError):
        integrate_trajectory(RK4Integrator(Lorenz96()), torch.zeros(4), 5, 2)
    with pytest.raises(NotImplementedError):
        BaseIntegrator(Lorenz96()).integrate(torch.zeros(4))


@pytest.mark.parametrize("shape", [(8, 128), (2, 3, 64)])
def test_rk4_plain_matches_jax_fused_kernel(rng, shape):
    """rk4_steps_plain against the JAX Pallas forecast in interpret mode,
    both in f32."""
    x = (rng.normal(size=shape) + 2.0).astype(np.float32)
    ref = np.asarray(j_fused(JLorenz96(), jnp.asarray(x), 0.05, 4,
                             interpret=True))
    out = cf.rk4_steps_plain(Lorenz96(), torch.from_numpy(x), 0.05, 4)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_fused_rk4_cpu_runs_plain_and_matches_integrator(state):
    before = dict(cf.LAUNCHES)
    integ = RK4Integrator(Lorenz96(), 0.05)
    x = torch.from_numpy(state)
    out = cf.fused_rk4_steps(integ.model, x, integ.dt, 3)
    assert torch.equal(out, cf.rk4_steps_plain(integ.model, x, 0.05, 3))
    ref = x
    for _ in range(3):
        ref = integ.integrate(ref)
    close(out, ref, 1e-12)
    assert cf.LAUNCHES == before  # no kernel launch for a CPU tensor


def test_supports_fused_rk4_gate():
    integ = RK4Integrator(Lorenz96(), 0.05)
    assert cf.supports_fused_rk4(integ, (40, 10000))
    assert cf.supports_fused_rk4(integ, (40, 19370))
    assert cf.supports_fused_rk4(integ, (40, 19371))  # no cap on a row
    assert cf.supports_fused_rk4(integ, (40, 2 ** 20))
    assert cf.supports_fused_rk4(integ, (40, 4))
    assert not cf.supports_fused_rk4(integ, (40, 3))
    assert not cf.supports_fused_rk4(integ, (40, 100), dtype_bytes=8)

    class MyRK4(RK4Integrator):
        pass

    assert not cf.supports_fused_rk4(MyRK4(Lorenz96()), (4, 100))
    assert not cf.supports_fused_rk4(
        RK4Integrator(lambda x: -x), (4, 100))
    assert not cf.supports_fused_rk4(
        RK4Integrator(Lorenz96(torch.ones(100))), (4, 100))


PLAN_G = (4, 5, 37, 208, 209, 10000, 19371)
PLAN_STEPS = (0, 1, 4, 5, 9)


@pytest.mark.parametrize("n_steps", PLAN_STEPS)
@pytest.mark.parametrize("g", PLAN_G)
def test_rk4_plan(g, n_steps):
    """A tile of 32 p points keeps 8 halo points a step on the left and 4
    on the right; the interiors cover the ring exactly once; ceil(n_steps
    / steps) launches, one for the cycle's 4 steps."""
    plan = cf.rk4_plan(g, n_steps)
    s = plan.steps
    assert 1 <= s <= cf.MAX_STEPS and s == min(max(n_steps, 1),
                                                 cf.MAX_STEPS)
    assert plan.p == cf.TILE_P
    assert (plan.left, plan.right) == (8 * s, 4 * s)
    assert plan.left + plan.stride + plan.right == 32 * plan.p
    assert plan.launches == -(-n_steps // s)
    if n_steps == 4:
        assert plan.launches == 1
    written = [t * plan.stride + j for t in range(plan.tiles)
               for j in range(plan.stride) if t * plan.stride + j < g]
    assert written == list(range(g))
    assert (plan.tiles - 1) * plan.stride < g


def _same_bits(out, ref):
    """Equal wherever finite, NaN in the same places."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], ref[~nan])


@pytest.mark.parametrize("shape, n_steps", [
    ((3, g), n) for g in PLAN_G for n in PLAN_STEPS] + [((2, 3, 8, 64), 4),
                                                        ((2, 3, 8, 64), 9)])
def test_rk4_tiles_plain_matches_plain(rng, shape, n_steps):
    """The kernel's decomposition (tiles with their halo, the edge lanes'
    values, the ring wrap, the launches of n_steps) gives the plain
    version's bits, NaN in the same places; one row carries a NaN."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    x.view(-1, shape[-1])[1, shape[-1] // 2] = float("nan")
    plan = cf.rk4_plan(shape[-1], n_steps)
    ref = cf.rk4_steps_plain(Lorenz96(), x, 0.05, n_steps)
    out = cf.rk4_tiles_plain(Lorenz96(), x, 0.05, n_steps, plan)
    assert out.shape == ref.shape and out.dtype == torch.float32
    _same_bits(out, ref)
    assert bool(torch.isnan(out).any()) and bool(torch.isfinite(out).any())


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-10),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("n_steps", [1, 4, 5])
def test_fused_rk4_grad_matches_jax(rng, dtype, tol, n_steps):
    """The Function's gradient (its forward on the plain route for a CPU
    tensor) against jax.grad through the JAX kernel's custom VJP in
    interpret mode; f32 within 1e-5 max|ref| (the two loops may round in
    another order)."""
    import jax

    x = (rng.normal(size=(4, 128)) + 2.0).astype(dtype)
    ct = rng.normal(size=(4, 128)).astype(dtype)

    def j_loss(v):
        return jnp.sum(j_fused(JLorenz96(), v, 0.05, n_steps,
                               interpret=True) * ct)

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    before = dict(cf.LAUNCHES)
    xt = torch.from_numpy(x).requires_grad_()
    out = cf.fused_rk4_steps(Lorenz96(), xt, 0.05, n_steps)
    assert out.grad_fn is not None
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(ct))
    assert grad.dtype == xt.dtype
    assert np.abs(grad.numpy() - ref).max() <= tol * np.abs(ref).max()
    assert cf.LAUNCHES == before


@pytest.mark.parametrize("n_steps", [0, 1, 3])
def test_fused_rk4_gradcheck(rng, n_steps):
    x = torch.from_numpy(rng.normal(size=(2, 12)) + 2.0).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v: cf.fused_rk4_steps(Lorenz96(), v, 0.05, n_steps), (x,))


# -- Lorenz '84 ------------------------------------------------------------------

L84_TOL = 1e-12


@pytest.mark.parametrize("params", [{}, dict(damp_factor=0.3, dis_factor=3.5,
                                             symm_forcing=6.0,
                                             asymm_forcing=1.5)])
def test_lorenz84_matches_jax(rng, params):
    from tpu_assim.models import Lorenz84 as JLorenz84
    from tpu_assim_torch.models import Lorenz84

    x = rng.normal(size=(5, 7, 3))
    model, ref = Lorenz84(**params), JLorenz84(**params)
    assert str(model) == str(ref)
    close(model(torch.from_numpy(x)), ref(jnp.asarray(x)), L84_TOL)


def test_lorenz84_rk4_trajectory_matches_jax(rng):
    from tpu_assim.models import Lorenz84 as JLorenz84
    from tpu_assim_torch.models import Lorenz84

    x0 = rng.normal(size=(4, 3)) + np.array([1.0, 0.0, -0.5])
    out = integrate_trajectory(RK4Integrator(Lorenz84(), dt=0.05),
                               torch.from_numpy(x0), 40, save_every=4)
    ref = j_traj(JRK4(JLorenz84(), dt=0.05), jnp.asarray(x0), 40,
                 save_every=4)
    assert out.shape == ref.shape
    close(out, ref, L84_TOL)
