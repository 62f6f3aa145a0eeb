"""
Parity of the PyTorch port's Lorenz-96 model, RK4 integrator and fused RK4
forecast (tpu_assim_torch.models) against the JAX package on the same numpy
inputs: the model and integrator in f64 at 1e-10; the fused forecast's
plain version against the JAX kernel in interpret mode in f32 within
1e-5 max|ref| (the two only reassociate the stage combination).
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
    assert not cf.supports_fused_rk4(integ, (40, 19371))  # row > 227 KB
    assert not cf.supports_fused_rk4(integ, (40, 3))
    assert not cf.supports_fused_rk4(integ, (40, 100), dtype_bytes=8)

    class MyRK4(RK4Integrator):
        pass

    assert not cf.supports_fused_rk4(MyRK4(Lorenz96()), (4, 100))
    assert not cf.supports_fused_rk4(
        RK4Integrator(lambda x: -x), (4, 100))
    assert not cf.supports_fused_rk4(
        RK4Integrator(Lorenz96(torch.ones(100))), (4, 100))
