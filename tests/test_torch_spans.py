"""
The program's spans (``tpu_assim_torch.utils.profiling.span``): with no
profiler running a span enters nothing; under ``torch.profiler`` the cycle
and IEnKS steps record their layer boundaries with the names, nesting and
counts below. The kernel launch spans (``kernel.window1d``,
``kernel.rk4_l96``, ``kernel.svd_jacobi``) open around the CUDA launches
only, so these CPU steps, which take the kernels' plain routes, record
none of them.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_assim_torch.analysis import make_cycle_step, make_lienks_step
from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.utils import profiling

G, K, O = 64, 8, 16


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler")


def _dist(grid_coord, obs_coords):
    return torch.abs(obs_coords[:, 1] - grid_coord[1])[None, :]


@pytest.fixture
def problem():
    gen = torch.Generator().manual_seed(7)
    grid_x = torch.arange(G, dtype=torch.float32)[:, None]
    obs_idx = torch.arange(0, G, G // O)
    return dict(prior=torch.randn(K, G, generator=gen) + 1.0,
                obs=torch.randn(O, generator=gen), var=torch.ones(O),
                obs_idx=obs_idx, grid_x=grid_x, obs_x=grid_x[obs_idx],
                integ=RK4Integrator(Lorenz96(8.0), dt=0.05),
                loc=GaspariCohn((4.0,), _dist, epsilon=1e-5))


def _cycle(p, bound):
    opts = dict(inf_factor=1.1, method="fused1d", max_obs=8, cheb_degree=16)
    if bound:
        step = make_cycle_step(p["integ"], 4, p["loc"], geometry=(
            p["obs_idx"].numpy(), p["grid_x"].numpy(), p["obs_x"].numpy()),
            **opts)
        return lambda: step(p["prior"], p["obs"], p["var"])
    step = make_cycle_step(p["integ"], 4, p["loc"], **opts)
    return lambda: step(p["prior"], p["obs"], p["var"], p["obs_idx"],
                        p["grid_x"], p["obs_x"])


def _lienks(p):
    step = make_lienks_step(p["loc"], p["integ"], 4, n_outer=2, max_obs=8,
                            selection="window")
    return lambda: step(p["prior"], p["obs"], p["var"], p["obs_idx"],
                        p["grid_x"], p["obs_x"])


def _recorded_spans(run):
    """``Counter`` of ``(span, enclosing program span or None)`` recorded
    while ``run()`` runs under the profiler, names without the prefix."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    prefix = profiling.SPAN_PREFIX
    out = collections.Counter()
    for ev in prof.events():
        if not ev.name.startswith(prefix):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith(prefix):
            parent = parent.cpu_parent
        out[(ev.name[len(prefix):],
             None if parent is None else parent.name[len(prefix):])] += 1
    return out


def test_span_with_no_profiler_enters_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not torch.autograd._profiler_enabled()
    ctx = profiling.span("forecast")
    assert isinstance(ctx, contextlib.nullcontext)
    assert ctx is profiling.span("cycle.step")
    with profiling.span("forecast") as entered:
        assert entered is None


def test_steps_run_with_no_profiler_and_record_function_raising(
        monkeypatch, problem):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert torch.isfinite(_cycle(problem, True)()).all()
    assert torch.isfinite(_lienks(problem)()).all()


def test_phase_times_with_no_profiler_and_enters_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    profiling.reset()
    with profiling.phase("gated"):
        torch.ones(4).sum()
    assert profiling.timings()["gated"]["count"] == 1
    profiling.reset()


def test_span_records_its_prefixed_name_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("lienks.outer"):
            torch.ones(4).sum()
    names = [ev.name for ev in prof.events()]
    assert names.count("tpu_assim_torch.lienks.outer") == 1


@pytest.mark.parametrize("bound", [True, False],
                         ids=["geometry-bound", "geometry-per-call"])
def test_cycle_step_spans(problem, bound):
    assert _recorded_spans(_cycle(problem, bound)) == {
        ("cycle.step", None): 1,
        ("forecast", "cycle.step"): 1,
        ("letkf.analysis", "cycle.step"): 1,
    }


def test_lienks_step_spans(problem):
    assert _recorded_spans(_lienks(problem)) == {
        ("lienks.step", None): 1,
        ("lienks.taper", "lienks.step"): 1,
        ("lienks.outer", "lienks.step"): 2,
        ("forecast", "lienks.outer"): 2,
        ("lienks.inner", "lienks.outer"): 2,
        ("linalg.svd", "lienks.inner"): 4,
    }


@pytest.mark.parametrize("which", ["cycle", "lienks"])
def test_spans_leave_the_result_unchanged(problem, which):
    run = _cycle(problem, True) if which == "cycle" else _lienks(problem)
    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    np.testing.assert_array_equal(plain.numpy(), traced.numpy())
