"""
The benchmark's 2-D cell ``grid2d-1024.strips`` (bench.py config 8 through
``make_strip_letkf_2d``) at a small size on the CPU, with no JAX: the
strips entry against the benchmark's f64 reference and the TF32 control,
the reference's 2-D window against a loop over every observation, its
round-robin Jacobi against LAPACK, its column-sorted LETKF against the
1-D reference's, K6's work count, and the strip path's spans and scalar
copies.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench.inputs import make_inputs
from port_bench.parts import load
from port_bench.reference import letkf, letkf_sorted, symeig_rr, taper
from port_bench.reference.precision import Products
from port_bench.reference.window import sqrt_taper, support_window
from port_bench.reference.window2d import Window2D
from port_bench.tests.conftest import ROOT
from port_bench.work import k1, k6, peaks
from tpu_assim_torch.analysis import (
    _strip_inputs_2d,
    _strip_plan_2d,
    make_strip_letkf_2d,
)
from tpu_assim_torch.utils import profiling

# One intra-op thread: the suite runs in several worker processes.
torch.set_num_threads(1)

CONFIG = json.loads(
    (ROOT / "port_bench" / "configs" / "grid2d-1024.json").read_text())
TRAFFIC = json.loads(
    (ROOT / "port_bench" / "traffic" / "strips.json").read_text())
# config 8's density of observed cells (10^5 / 2^20) on a 64 x 64 grid
TINY = dict(CONFIG, nx=64, ny=64, grid=4096, n_obs=390, ens_size=10,
            n_strips=4)
CPU = torch.device("cpu")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.abs().max())


def _network(cfg):
    return load("networks", "cells2d").build(cfg, 0)


def _window(net, dtype=torch.float64):
    loc = CONFIG["localization"]
    return Window2D(torch.as_tensor(net["obs_x"], dtype=dtype),
                    torch.as_tensor(net["grid_x"], dtype=dtype),
                    loc["radius"], loc["epsilon"], chunk=1000)


def _conv_counts(cfg):
    """Each cell's observations of nonzero weight by a 2-D convolution of
    the observed cells with the taper's support: the network's cells are
    the grid's, so a cell's weight depends on its offset alone."""
    nx, ny = cfg["nx"], cfg["ny"]
    occ = torch.zeros(nx * ny)
    occ[torch.as_tensor(_network(cfg)["obs_idx"])] = 1.0
    rx, ry = CONFIG["localization"]["radius"]
    dx = torch.arange(-int(2 * rx) + 1, int(2 * rx), dtype=torch.float64)
    dy = torch.arange(-int(2 * ry) + 1, int(2 * ry), dtype=torch.float64)
    w = (taper.gaspari_cohn(dy.abs() / ry, 0.0)[:, None]
         * taper.gaspari_cohn(dx.abs() / rx, 0.0)[None, :])
    mask = (w > CONFIG["localization"]["epsilon"]).float()
    counts = torch.nn.functional.conv2d(
        occ.view(1, 1, ny, nx), mask[None, None],
        padding=(dy.numel() // 2, dx.numel() // 2))
    return counts.round().long().view(-1)


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_strips_entry_matches_reference(seed):
    """The strips' f32 step within f32 rounding of the f64 reference; the
    reference with TF32 products far outside it."""
    entry = load("entries", "strips").build(
        TINY, TRAFFIC, make_inputs(TINY, TRAFFIC, seed, CPU), CPU)
    prior = entry.initial()
    ref = entry.reference(prior, 1, Products("f64"))
    assert _rel(entry.run(prior, 1), ref) < 2e-6
    assert _rel(entry.reference(prior, 1, Products("tf32")), ref) > 5e-5


def test_window2d_matches_every_observation():
    """Indices and weights of a few columns against a loop over every
    observation of the network."""
    net = _network(TINY)
    win = _window(net)
    cols = torch.tensor([0, 63, 2000, 2080, 4095])
    idx, sw = win(cols)
    rx, ry = CONFIG["localization"]["radius"]
    eps = CONFIG["localization"]["epsilon"]
    obs, grid = net["obs_x"].astype(np.float64), net["grid_x"]
    for row, col in enumerate(cols.tolist()):
        want = {}
        for j, (ox, oy) in enumerate(obs):
            wt = float(taper.gaspari_cohn(
                torch.tensor(abs(ox - grid[col, 0]) / rx), 0.0)
                * taper.gaspari_cohn(
                    torch.tensor(abs(oy - grid[col, 1]) / ry), 0.0))
            if wt > eps:
                want[j] = wt
        got = {int(i): float(s) ** 2
               for i, s in zip(idx[row], sw[row]) if s > 0}
        assert sorted(got) == sorted(want)
        assert max(abs(got[j] - want[j]) for j in want) < 1e-15
    assert idx.shape[1] == int(win.counts(cols).max())


@pytest.mark.parametrize("m", [1, 2, 3, 8, 21, 46])
def test_round_robin_jacobi_matches_lapack(m):
    gen = torch.Generator().manual_seed(m)
    z = torch.randn(8, m, 40, generator=gen, dtype=torch.float64)
    a = z @ z.transpose(1, 2)
    lam, vec = symeig_rr.eigh(a)
    scale = a.abs().amax((1, 2))
    assert float(((torch.sort(lam, 1).values - torch.linalg.eigvalsh(a))
                  .abs().amax(1) / scale).max()) < 1e-12
    rec = (vec * lam[:, None, :]) @ vec.transpose(1, 2)
    assert float(((rec - a).abs().amax((1, 2)) / scale).max()) < 1e-12
    eye = torch.eye(m, dtype=torch.float64)
    assert float((vec.transpose(1, 2) @ vec - eye).abs().max()) < 1e-12


def test_sorted_analysis_is_the_1d_reference():
    """The column-sorted LETKF (LAPACK on the CPU) and the 1-D reference
    (its serial Jacobi) on the same 1-D windows."""
    gen = torch.Generator().manual_seed(5)
    k, g, o, radius, eps = 8, 96, 40, 3.0, 1e-5
    obs_x = torch.sort(torch.rand(o, generator=gen, dtype=torch.float64)
                       * g).values
    grid_x = torch.arange(g, dtype=torch.float64)
    prior = torch.randn(k, g, generator=gen, dtype=torch.float64)
    ens_obs = torch.randn(k, o, generator=gen, dtype=torch.float64)
    vals, var = torch.randn(o, generator=gen), torch.full((o,), 0.5)

    def window(cols):
        idx, valid = support_window(obs_x, grid_x[cols], radius)
        return idx, sqrt_taper(obs_x, grid_x[cols], idx, valid, radius, eps)

    f64 = Products("f64")
    want = letkf.analysis(prior, ens_obs, vals, var, window, 1.1, f64,
                          block=32)
    counts = window(slice(None))[1].gt(0).sum(1)
    got = letkf_sorted.analysis(prior, ens_obs, vals, var, window, counts,
                                1.1, f64, block=32)
    assert _rel(got, want) < 1e-12


def test_k6_work_is_the_per_column_count():
    net = _network(TINY)
    counts = _window(net).counts()
    assert torch.equal(counts, _conv_counts(TINY))
    flops, n_bytes = k6.work(10, 4096, 390, counts, 16)
    assert flops == sum(k1.cheb_flops(10, int(m), 1, 16) for m in counts)
    assert n_bytes == 4 * (2 * 10 * 4096 + 4096 + 10 * 390 + 3 * 390
                           + 2 * 4096)


def test_k6_bound_at_config_8():
    """6.18e10 FLOPs, 0.923 ms at 67 TFLOP/s (bytes: 0.109 ms)."""
    cfg = CONFIG
    ms, by = peaks.bound_ms(*k6.work(cfg["ens_size"], cfg["grid"],
                                     cfg["n_obs"], _conv_counts(cfg),
                                     cfg["cheb_degree"]))
    assert by == "operations"
    assert ms == pytest.approx(0.9229, abs=1e-4)


def _small_strips():
    net = load("networks", "cells2d").build(
        dict(TINY, nx=32, ny=32, grid=1024, n_obs=98), 0)
    loc = load("localizations", "gaspari_cohn_2d").program(
        CONFIG["localization"])
    fn = make_strip_letkf_2d(loc, (net["obs_idx"], net["grid_x"],
                                   net["obs_x"]), n_strips=2,
                             inf_factor=1.1, cheb_degree=16)
    gen = torch.Generator().manual_seed(2)
    return fn, torch.randn(6, 1024, generator=gen), torch.randn(
        98, generator=gen), torch.ones(98)


def test_strip_spans_once_a_call(monkeypatch):
    """``strip.analysis`` around the call and ``strip.scatter`` inside it,
    each once a call; K6's launch span only on a card. K6's plain version
    is stubbed: its thousands of small operations would take the profiler
    longer to list than the rest of this file takes to run."""
    from tpu_assim_torch import analysis

    monkeypatch.setattr(analysis, "window2d_banded",
                        lambda *args, **kwargs: torch.zeros_like(args[3]))
    fn, prior, vals, var = _small_strips()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            fn(prior, vals, var)
    prefix = profiling.SPAN_PREFIX
    seen = collections.Counter()
    for ev in prof.events():
        if ev.name.startswith(prefix):
            parent = ev.cpu_parent
            while parent is not None and not parent.name.startswith(prefix):
                parent = parent.cpu_parent
            seen[(ev.name[len(prefix):],
                  None if parent is None else parent.name[len(prefix):])] += 1
    assert seen == {("strip.analysis", None): 2,
                    ("strip.scatter", "strip.analysis"): 2}


def test_strip_scalars_copied_once_for_a_number():
    """A number ``reg`` gives the same device tensor every call; a tensor
    ``reg`` keeps its graph."""
    net = _network(TINY)
    loc = load("localizations", "gaspari_cohn_2d").program(
        CONFIG["localization"])
    plan = _strip_plan_2d(loc, net["grid_x"], net["obs_x"], 4, None, True)
    perts, innov = torch.randn(10, 390), torch.randn(390)
    sp, mean = torch.randn(1, 10, 4096), torch.randn(1, 4096)

    def scal(reg):
        return _strip_inputs_2d(plan, perts, innov, sp, mean, reg, 16)[0][5]

    first = scal(9 / 1.1)
    assert scal(9 / 1.1) is first
    assert torch.equal(first, torch.tensor([9 / 1.1, 4.0, 4.0]))
    reg = torch.tensor(9 / 1.1, requires_grad=True)
    live = scal(reg)
    assert live.requires_grad and torch.equal(live.detach(), first)
    assert scal(9 / 1.2) is not first
