"""
The port's Lorenz-96 examples (``examples/torch_learn_inflation.py``,
``torch_cycled_lorenz96.py``, ``torch_lienks_l96.py``) on the CPU against
their JAX twins, rebuilt here as the JAX examples build them; and the
port's ``testing/`` and ``utils/profiling``.

- The examples make their arrays in torch's default dtype, as the JAX ones
  make theirs in JAX's; the tests run both in f64 (JAX's x64, torch's
  default dtype set to f64 here).
- ``make_loss`` at ``--cycles 4`` and 3 gradient steps: the loss within
  1e-5 relative, d loss / d log_rho within 1e-4 relative, rho after 3
  steps within 1e-4 relative.
- The cycled LETKF (dense eigh and ``--fast``) and the localized IEnKS over
  a few cycles: each cycle's RMSE within 1e-5 relative.
"""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_assim import testing as JT
from tpu_assim.analysis import make_cycle_step as j_make_cycle_step
from tpu_assim.analysis import make_letkf_analysis as j_make_letkf_analysis
from tpu_assim.analysis import make_lienks_step as j_make_lienks_step
from tpu_assim.models import Lorenz96, RK4Integrator, integrate_trajectory
from tpu_assim.ops.localization import GaspariCohn

import tpu_assim_torch as TT
from tpu_assim_torch import testing as TTS
from tpu_assim_torch.utils import profiling

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def example(name):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def f64_default():
    """torch's default dtype f64 (JAX's x64) for the test's duration."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- examples/learn_inflation.py ----------------------------------------------

def jax_learn_inflation(cycles, steps, lr=0.5, n_ens=16, n_grid=40):
    """The JAX example's loss and descent, as ``examples/learn_inflation.py``
    builds them: ``[(loss, grad, rho after the step), ...]``."""
    rng = np.random.RandomState(7)
    n_obs = n_grid // 2
    obs_idx = jnp.asarray(np.arange(0, n_grid, 2, dtype=np.int32))
    obs_var = 0.5
    dt, n_int = 0.05, 2
    integ = RK4Integrator(Lorenz96(), dt=dt)
    truth0 = jnp.asarray(8.0 + rng.randn(n_grid))
    spinup = integrate_trajectory(integ, truth0, 200)[-1]
    truths = integrate_trajectory(
        integ, spinup, cycles * n_int)[n_int - 1::n_int][:cycles]
    obs_seq = jnp.asarray(
        np.asarray(truths)[:, np.asarray(obs_idx)]
        + np.sqrt(obs_var) * rng.randn(cycles, n_obs))
    ens0 = jnp.asarray(np.asarray(spinup)[None, :]
                       + 1.5 * rng.randn(n_ens, n_grid))
    grid_coords = jnp.arange(n_grid, dtype=jnp.float32)[:, None]
    obs_coords = grid_coords[obs_idx]
    ovar = jnp.full((n_obs,), obs_var, jnp.float32)

    def dist(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    loc = GaspariCohn((4.0,), dist)

    def loss_fn(log_rho):
        rho = jnp.exp(log_rho)
        analyse = j_make_letkf_analysis(loc, rho, method="fused1d",
                                        max_obs=16, cheb_degree=16)

        def cycle(ens, obs_truth):
            obs_vals, truth = obs_truth

            def body(s, _):
                return integ.integrate(s), None

            fc, _ = jax.lax.scan(body, ens, None, length=n_int)
            ana = analyse(fc, obs_vals, ovar, obs_idx, grid_coords,
                          obs_coords)
            return ana, jnp.mean((jnp.mean(ana, axis=0) - truth) ** 2)

        _, errs = jax.lax.scan(cycle, ens0.astype(jnp.float32),
                               (obs_seq, truths.astype(jnp.float32)))
        return jnp.mean(errs)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    log_rho = jnp.asarray(0.0)
    out = []
    for _ in range(steps):
        val, g = grad_fn(log_rho)
        log_rho = log_rho - lr * g
        out.append((float(val), float(g), float(jnp.exp(log_rho))))
    return out


def test_learn_inflation_matches_jax(f64_default):
    """``make_loss`` (cycles 4, ens 16, grid 40, seed 7) and 3 steps of
    descent against the JAX example's."""
    mod = example("torch_learn_inflation")
    loss = mod.make_loss(cycles=4, device="cpu")
    ref = jax_learn_inflation(cycles=4, steps=3)
    log_rho = torch.zeros((), requires_grad=True)
    val = loss(log_rho)
    (g,) = torch.autograd.grad(val, log_rho)
    assert loss.twin["ens0"].dtype == torch.float64
    assert rel(float(val.detach()), ref[0][0]) <= 1e-5
    assert rel(float(g), ref[0][1]) <= 1e-4
    history = mod.descend(loss, 3, 0.5, "cpu")
    for (v, rho), (v_ref, _, rho_ref) in zip(history, ref):
        assert rel(v, v_ref) <= 1e-5
        assert rel(rho, rho_ref) <= 1e-4


def test_examples_need_a_card_unless_asked():
    """``--device cuda`` (the default) exits without a card; nothing falls
    back to the CPU unasked."""
    mod = example("torch_learn_inflation")
    if torch.cuda.is_available():
        assert mod.device_or_exit("cuda").type == "cuda"
    else:
        with pytest.raises(SystemExit, match="--device cpu"):
            mod.device_or_exit("cuda")
    assert mod.device_or_exit("cpu").type == "cpu"


# -- examples/cycled_lorenz96.py ----------------------------------------------

def jax_cycled(cycles, fast, spinup, grid=40, ens=20, obs_every=2,
               obs_var=0.5, radius=4.0, inf=1.1, dt=0.05, steps=4):
    """The JAX example's cycle loop: each cycle's RMSE."""
    rng = np.random.RandomState(42)
    integ = RK4Integrator(Lorenz96(forcing=8.0), dt=dt)
    truth = jnp.asarray(rng.normal(size=grid) + 8.0)
    truth = integrate_trajectory(integ, truth, spinup)[-1]
    state = truth[None, :] + jnp.asarray(rng.normal(size=(ens, grid)))
    obs_idx = jnp.asarray(np.arange(0, grid, obs_every, dtype=np.int32))
    n_obs = len(obs_idx)
    ovar = jnp.full((n_obs,), obs_var)
    grid_coords = jnp.asarray(np.arange(grid, dtype=float))[:, None]
    obs_coords = grid_coords[obs_idx]

    def dist_periodic(gc, oi):
        d = jnp.abs(oi[:, 1] - gc[1])
        return jnp.minimum(d, grid - d)[None, :]

    def dist_abs(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    loc = GaspariCohn((radius,), dist_abs if fast else dist_periodic)
    opts = dict(method="fused1d", max_obs=16) if fast else {}
    step = j_make_cycle_step(integ, steps, loc, inf_factor=inf, **opts)
    rmses = []
    for _ in range(cycles):
        truth = integrate_trajectory(integ, truth, steps)[-1]
        obs = truth[obs_idx] + jnp.asarray(
            rng.normal(size=n_obs) * np.sqrt(obs_var))
        state = step(state, obs, ovar, obs_idx, grid_coords, obs_coords)
        rmses.append(float(jnp.sqrt(jnp.mean(
            (jnp.mean(state, 0) - truth) ** 2))))
    return rmses


@pytest.mark.parametrize("fast", [False, True])
def test_cycled_lorenz96_matches_jax(f64_default, fast, capsys):
    """6 cycles (dense eigh; ``--fast``: fused1d, K1's plain version) from
    a truth spun up 100 steps: the example's 500 (25 model time units) would
    grow the two RK4s' f64 rounding (their operations fuse differently)
    past any bound."""
    mod = example("torch_cycled_lorenz96")
    argv = ["--cycles", "6", "--device", "cpu"] + (["--fast"] if fast
                                                   else [])
    profiling.reset()
    rmses = mod.run(mod.parser().parse_args(argv), spinup=100)
    ref = jax_cycled(6, fast, spinup=100)
    assert len(rmses) == 6
    assert rel(rmses, ref) <= 1e-5
    assert profiling.timings()["forecast+analysis"]["count"] == 6


# -- examples/lienks_l96.py ---------------------------------------------------

def jax_lienks(n_cycles, g=40, k=20, n_int=4):
    """The JAX example's loop: the smoothed and free RMSEs of the second
    half."""
    rng = np.random.RandomState(0)
    integ = RK4Integrator(Lorenz96(), dt=0.05)
    truth = jnp.asarray(rng.normal(size=g) + 8.0)
    truth = integrate_trajectory(integ, truth, 200)[-1]
    ens = truth[None, :] + jnp.asarray(rng.normal(size=(k, g)))
    free = ens
    obs_idx = jnp.arange(0, g, 2, dtype=jnp.int32)
    obs_var = jnp.full((g // 2,), 0.25)
    grid_coords = jnp.arange(g, dtype=float)[:, None]
    obs_coords = grid_coords[obs_idx]

    def dist_fn(gc, oi):
        return jnp.abs(oi[:, 1] - gc[1])[None, :]

    step = j_make_lienks_step(GaspariCohn((4.0,), dist_fn), integ, n_int,
                              n_outer=3, tau=0.6, max_obs=18,
                              selection="window")
    rmse_da, rmse_free = [], []
    for c in range(n_cycles):
        truth_next = integrate_trajectory(integ, truth, n_int)[-1]
        obs = truth_next[obs_idx] + 0.5 * jnp.asarray(
            rng.normal(size=g // 2))
        ens = step(ens, obs, obs_var, obs_idx, grid_coords, obs_coords)
        for _ in range(n_int):
            ens = integ.integrate(ens)
            free = integ.integrate(free)
        truth = truth_next
        if c >= n_cycles // 2:
            rmse_da.append(float(jnp.sqrt(jnp.mean(
                (jnp.mean(ens, 0) - truth) ** 2))))
            rmse_free.append(float(jnp.sqrt(jnp.mean(
                (jnp.mean(free, 0) - truth) ** 2))))
    return rmse_da, rmse_free


def test_lienks_l96_matches_jax(f64_default):
    """4 cycles of the localized IEnKS (the RMSEs of the last two)."""
    mod = example("torch_lienks_l96")
    rmse_da, rmse_free = mod.run("cpu", n_cycles=4)
    ref_da, ref_free = jax_lienks(4)
    assert len(rmse_da) == 2
    assert rel(rmse_da, ref_da) <= 1e-5
    assert rel(rmse_free, ref_free) <= 1e-5


# -- testing/ -----------------------------------------------------------------

def test_dummy_distance_and_localization_match_jax(rng):
    grid = rng.uniform(0, 20, size=(7, 2))
    obs = rng.uniform(0, 20, size=(11, 2))
    np.testing.assert_array_equal(
        TTS.dummy_distance(torch.as_tensor(grid[3]),
                           torch.as_tensor(obs)).numpy(),
        np.asarray(JT.dummy_distance(jnp.asarray(grid[3]),
                                     jnp.asarray(obs))))
    w = TTS.DummyLocalization().taper_weights(torch.as_tensor(grid),
                                              torch.as_tensor(obs))
    ref = JT.DummyLocalization().taper_weights(jnp.asarray(grid),
                                               jnp.asarray(obs))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    assert float(w.max()) > 0 and float(w.min()) == 0.0
    with pytest.raises(NotImplementedError):
        TTS.DummyLocalization().localize_cov()


def test_dummy_obs_operator_model_and_module(rng):
    data = rng.normal(size=(2, 3, 4, 5))
    state = TT.EnsembleState(data, var_names=("y", "x"), device="cpu")
    obs = TT.Observation(rng.normal(size=(2, 5)), np.eye(5),
                         obs_coords=np.arange(5, dtype=float)[:, None],
                         times=np.array([2.0, 0.0]), device="cpu")
    out = TTS.dummy_obs_operator()(obs, state)
    np.testing.assert_array_equal(out.numpy(), data[1][[2, 0]])
    assert TTS.dummy_model(state) == (state, state)
    x = torch.as_tensor(rng.normal(size=(3, 2)))
    np.testing.assert_array_equal(
        TTS.DummyNeuralModule()(x).numpy(),
        np.asarray(JT.DummyNeuralModule()(jnp.asarray(x.numpy()))))


def test_generate_random_weights():
    w = TTS.generate_random_weights(6)
    assert w.shape == (6, 6) and w.dtype == torch.float64
    assert torch.equal(w, TTS.generate_random_weights(6, seed=42))
    assert not torch.equal(w, TTS.generate_random_weights(6, seed=7))
    # near the identity: the mean part at 0.1, the perturbations at 0.05
    assert float((w - torch.eye(6, dtype=torch.float64)).abs().max()) < 1.0


def test_cuda_decorator():
    calls = []

    @TTS.if_cuda_decorator
    def needs_card(value):
        calls.append(value)
        return value

    assert TTS.if_gpu_decorator is TTS.if_cuda_decorator
    assert needs_card.__name__ == "needs_card"
    if TTS.cuda_available():
        assert needs_card(3) == 3 and calls == [3]
    else:
        with pytest.raises(pytest.skip.Exception, match="CUDA"):
            needs_card(3)
        assert calls == []


# -- utils/profiling ----------------------------------------------------------

def test_phase_timings_accumulate_and_report():
    profiling.reset()
    for _ in range(3):
        with profiling.phase("forecast"):
            torch.ones(8).sum()
    with profiling.phase("analysis", block=True):
        torch.ones(8).sum()
    t = profiling.timings()
    assert t["forecast"]["count"] == 3 and t["analysis"]["count"] == 1
    assert t["forecast"]["total_s"] >= 0.0
    np.testing.assert_allclose(
        t["forecast"]["mean_ms"], 1e3 * t["forecast"]["total_s"] / 3)
    text = profiling.report()
    assert text.splitlines()[0].split() == ["phase", "calls", "total", "[s]",
                                            "mean", "[ms]"]
    assert "forecast" in text and "analysis" in text
    profiling.reset()
    assert profiling.timings() == {}


def test_phase_leaves_out_a_body_that_raises():
    profiling.reset()
    with pytest.raises(RuntimeError):
        with profiling.phase("failing"):
            raise RuntimeError("boom")
    assert "failing" not in profiling.timings()
    profiling.reset()


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.phase("traced"):
            torch.ones(16).cumsum(0)
    path = log_dir / "trace.json"
    assert path.exists() and path.stat().st_size > 0
    assert "traced" in path.read_text()
    assert os.path.isdir(log_dir)
