"""
The port's members x grid sharded cycle
(tpu_assim_torch.parallel.forecast) and the grid-sharded LETKF over a
tuple of mesh axes, against the JAX package on its 8 virtual CPU devices
(tests/conftest.py) in f64, and against the port in one process.

- The tuple of axes: ``sharded_letkf_weights`` and
  ``sharded_letkf_analysis`` with ``axis_name=("ens", "grid")`` on
  ``make_forecast_analysis_mesh(2, 4)`` against JAX's within 1e-10, from
  whole tensors and from GlobalTensors; ``"grid"`` as ``("grid",)``, bit
  for bit; ``sharded_lienks_step`` over both axes as over a grid mesh of
  8, bit for bit.
- The forecast and the cycle step against JAX's dryrun ``full_step``
  (``__graft_entry__.py``), built here: the state constrained to
  ``P(None, None, "ens", "grid")``, a scan of RK4 steps, the model
  equivalents, ``sharded_letkf_analysis`` over both axes; on 2 x 4, 4 x 2
  and 1 x 8, with halos narrower than a shard, wider (spanning several
  shards, wrapping) and of ``L + R >= g``; within 1e-10.
- Against the port's unsharded ``make_cycle_step``; from GlobalTensors of
  any split, bit for bit the whole-tensor step; a step's result into the
  next; an integrator of unknown reach (the whole ensemble); the re-split
  alone; the model equivalents alone; the K3 gate at shard shapes;
  members or columns that do not split evenly raise before any exchange.
- Two processes over gloo (the mesh's owners split by grid half, so the
  ring halo, the model equivalents and the re-split cross them), from
  whole tensors and from blocks, bit for bit one process; an uneven grid
  raises on both ranks and neither hangs. The harness is
  tests/test_torch_multihost.py's ``run_two``.
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from tpu_assim.models import Lorenz96 as JLorenz96
from tpu_assim.models import RK4Integrator as JRK4
from tpu_assim.ops.localization import GaspariCohn as JGaspariCohn
from tpu_assim.parallel import letkf as jpl
from tpu_assim.parallel import mesh as jmesh

from tpu_assim_torch import analysis as TA
from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops.cuda import svd as k3
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.parallel import forecast as pf
from tpu_assim_torch.parallel import letkf as tpl
from tpu_assim_torch.parallel import lienks as plk
from tpu_assim_torch.parallel import make_forecast_analysis_mesh
from tpu_assim_torch.parallel import make_grid_mesh, sharded_lienks_step
from tpu_assim_torch.parallel import multihost as mh

from test_torch_multihost import REPO, run_two

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
CPU8 = ["cpu"] * 8
DT, INF, RADIUS = 0.05, 1.1, 4.0
BOTH = ("ens", "grid")
LAYOUTS = [(2, 4), (4, 2), (1, 8)]
# (g, RK4 steps): L = 8 n, R = 4 n against g / S columns a grid shard
HALOS = {
    "narrower than a shard": (128, 2),      # L 16, R 8
    "wider than a shard": (64, 3),          # L 24, R 12; 16 to 32 a shard
}


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def problem(rng, g, k=8, o=None):
    """(state, obs_vals, obs_var, obs_idx, grid_coords, obs_coords) as
    numpy: the dryrun's evenly spaced observations, ``o`` of them."""
    o = o or g // 2
    locs = np.linspace(0, g, num=o, endpoint=False)
    return (rng.normal(size=(k, g)), rng.normal(size=o), np.full(o, 0.5),
            np.rint(locs).astype(np.int32) % g,
            np.arange(g, dtype=np.float64)[:, None], locs[:, None])


def t(a):
    return torch.from_numpy(np.asarray(a))


def port_loc():
    return GaspariCohn((RADIUS,), coord1_distance)


def port_step(mesh, n_steps, **kw):
    return pf.sharded_cycle_step(mesh, RK4Integrator(Lorenz96(), DT),
                                 n_steps, port_loc(), INF, **kw)


def jax_mesh(n_ens, n_grid):
    return JMesh(np.asarray(jax.devices()[:n_ens * n_grid]).reshape(
        n_ens, n_grid), BOTH)


def jax_full_step(w, n_ens, n_grid, n_steps):
    """JAX's dryrun ``full_step`` on a mesh ``(ens, grid)``: the forecast
    under ``P(None, None, "ens", "grid")``, the analysis over both axes.
    Returns (forecast [k, g], analysis [k, g])."""
    mesh = jax_mesh(n_ens, n_grid)
    integrator = JRK4(JLorenz96(), DT)
    loc = JGaspariCohn((RADIUS,), jax_coord1)
    sharding = NamedSharding(mesh, P(None, None, "ens", "grid"))

    @jax.jit
    def full_step(data, obs_vals, obs_var, obs_idx, grid_info, obs_info):
        data = jax.lax.with_sharding_constraint(data, sharding)
        forecast, _ = jax.lax.scan(
            lambda s, _: (integrator.integrate(s), None), data, None,
            length=n_steps)
        ens_obs = jnp.take(forecast[0, 0], obs_idx, axis=-1)
        rcinv = 1.0 / jnp.sqrt(obs_var)
        mean = jnp.mean(ens_obs, axis=0, keepdims=True)
        perts = (ens_obs - mean) * rcinv
        innov = (obs_vals - mean[0]) * rcinv
        return forecast, jpl.sharded_letkf_analysis(
            mesh, loc, forecast, perts, innov, grid_info, obs_info, INF,
            axis_name=BOTH)

    info = lambda c: np.hstack([np.zeros_like(c), c])     # noqa: E731
    forecast, out = full_step(jnp.asarray(w[0])[None, None],
                              *map(jnp.asarray, w[1:4]), jnp.asarray(
                                  info(w[4])), jnp.asarray(info(w[5])))
    return np.asarray(forecast)[0, 0], np.asarray(out)[0, 0]


# -- the grid-sharded LETKF over a tuple of axes ------------------------------

def obs_space(rng, k=10, l=24, g=64):
    """tests/test_parallel.py's obs-space problem and a [2, 1, k, g]
    state."""
    return (rng.normal(size=(2, 1, k, g)), rng.randn(k, l), rng.randn(l),
            np.hstack([np.zeros((g, 1)), np.arange(g)[:, None] * 1.0]),
            np.hstack([np.zeros((l, 1)), rng.uniform(0, g, size=(l, 1))]))


@functools.lru_cache(maxsize=None)
def jax_letkf(axis_name):
    """JAX's sharded weights and analysis of ``obs_space`` (seed 42) on its
    2 x 4 mesh, the grid over ``axis_name``, each under one jit."""
    data, perts, innov, ginfo, oinfo = obs_space(np.random.RandomState(42))
    mesh = jmesh.make_forecast_analysis_mesh(2, 4)
    jl = JGaspariCohn((8.0,), jax_coord1)
    weights = jax.jit(lambda *a: jpl.sharded_letkf_weights(
        mesh, jl, *a, INF, axis_name=axis_name))(
            *map(jnp.asarray, (perts, innov, ginfo, oinfo)))
    analysis = jax.jit(lambda *a: jpl.sharded_letkf_analysis(
        mesh, jl, *a, INF, axis_name=axis_name))(
            *map(jnp.asarray, (data, perts, innov, ginfo, oinfo)))
    return np.asarray(weights), np.asarray(analysis)


@pytest.mark.parametrize("form", ["whole", "global"])
@pytest.mark.parametrize("axis_name", [BOTH, ("grid", "ens")])
def test_tuple_axes_match_jax(form, axis_name):
    """The grid split over both axes of a 2 x 4 mesh, in either order:
    the weights and the analysis within 1e-10 of JAX's; a GlobalTensor
    input gives 8 blocks of 8 columns, the whole result bit for bit."""
    data, perts, innov, ginfo, oinfo = obs_space(np.random.RandomState(42))
    ref_w, ref_a = jax_letkf(axis_name)
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    loc = GaspariCohn((8.0,), coord1_distance)
    split = dict(axis_name=(tuple(axis_name),))
    ginfo_in = (t(ginfo) if form == "whole" else
                mh.host_local_to_global(mesh, t(ginfo), axis=0, **split))
    data_in = (t(data) if form == "whole" else
               mh.host_local_to_global(mesh, t(data), axis=3, **split))
    weights = tpl.sharded_letkf_weights(mesh, loc, t(perts), t(innov),
                                        ginfo_in, t(oinfo), INF,
                                        axis_name=axis_name)
    out = tpl.sharded_letkf_analysis(mesh, loc, data_in, t(perts), t(innov),
                                     t(ginfo), t(oinfo), INF,
                                     axis_name=axis_name)
    if form == "global":
        assert isinstance(out, mh.GlobalTensor) and len(out.blocks) == 8
        assert out.block_shape() == (2, 1, 10, 8)
        whole = tpl.sharded_letkf_analysis(mesh, loc, t(data), t(perts),
                                           t(innov), t(ginfo), t(oinfo), INF,
                                           axis_name=axis_name)
        weights, out = weights.gather(), out.gather()
        assert torch.equal(out, whole)
    close(weights, ref_w)
    close(out, ref_a)


def test_tuple_axes_equal_jax_grid_axis():
    """JAX's analyses over ("ens", "grid") and over "grid" agree within
    1e-12; so do the port's two, each within 1e-10 of JAX's."""
    data, perts, innov, ginfo, oinfo = obs_space(np.random.RandomState(42))
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    loc = GaspariCohn((8.0,), coord1_distance)
    args = (t(data), t(perts), t(innov), t(ginfo), t(oinfo), INF)
    both = tpl.sharded_letkf_analysis(mesh, loc, *args, axis_name=BOTH)
    grid = tpl.sharded_letkf_analysis(mesh, loc, *args)
    close(both, grid, 1e-12)
    close(grid, jax_letkf("grid")[1])
    close(jax_letkf("grid")[1], jax_letkf(BOTH)[1], 1e-12)


@pytest.mark.parametrize("which", ["analysis", "weights"])
def test_single_axis_as_tuple_bit_for_bit(rng, which):
    """``"grid"`` and ``("grid",)`` are one split: the same bits, also on
    a mesh of one axis."""
    data, perts, innov, ginfo, oinfo = obs_space(rng)
    loc = GaspariCohn((8.0,), coord1_distance)
    for mesh in (make_forecast_analysis_mesh(2, 4, devices=CPU8),
                 make_grid_mesh(8, devices=CPU8)):
        if which == "analysis":
            fn = lambda **kw: tpl.sharded_letkf_analysis(  # noqa: E731
                mesh, loc, t(data), t(perts), t(innov), t(ginfo), t(oinfo),
                INF, **kw)
        else:
            fn = lambda **kw: tpl.sharded_letkf_weights(  # noqa: E731
                mesh, loc, t(perts), t(innov), t(ginfo), t(oinfo), INF, **kw)
        assert torch.equal(fn(), fn(axis_name=("grid",)))


def test_sharded_lienks_takes_a_tuple_of_axes(rng):
    """``sharded_lienks_step`` over both axes of a 2 x 4 mesh: its 8
    shards give the 8-shard grid mesh's step bit for bit."""
    w = [t(a) for a in problem(rng, 64)]
    w[0] = w[0] + 2.0
    kw = dict(n_outer=2, tau=0.8, max_obs=18, selection="window")
    args = (port_loc(), RK4Integrator(Lorenz96(), DT), 3)
    both = sharded_lienks_step(make_forecast_analysis_mesh(
        2, 4, devices=CPU8), *args, axis_name=BOTH, **kw)(*w)
    grid = sharded_lienks_step(make_grid_mesh(8, devices=CPU8), *args,
                               **kw)(*w)
    assert torch.equal(both, grid)


def test_global_tensor_split_over_other_axes_raises(rng):
    data, perts, innov, ginfo, oinfo = obs_space(rng)
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    glob = mh.host_local_to_global(mesh, t(data), axis=3,
                                   axis_name=(("grid", "ens"),))
    with pytest.raises(ValueError, match="splits over"):
        tpl.sharded_letkf_analysis(mesh, port_loc(), glob, t(perts),
                                   t(innov), t(ginfo), t(oinfo), INF,
                                   axis_name=BOTH)


# -- the members x grid forecast and cycle against JAX ------------------------

@pytest.mark.parametrize("halo", list(HALOS))
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_cycle_matches_jax_full_step(rng, layout, halo):
    """The forecast and the step within 1e-10 of JAX's ``full_step`` on
    the same mesh shape."""
    g, n_steps = HALOS[halo]
    w = problem(rng, g)
    ref_fc, ref = jax_full_step(w, *layout, n_steps)
    mesh = make_forecast_analysis_mesh(*layout, devices=CPU8)
    fc = pf.sharded_forecast(mesh, RK4Integrator(Lorenz96(), DT),
                             n_steps)(t(w[0]))
    out = port_step(mesh, n_steps)(*map(t, w))
    assert out.shape == (8, g) and out.dtype == torch.float64
    close(fc, ref_fc)
    close(out, ref)


def test_halo_wider_than_the_ring_matches_jax(rng):
    """g 32 on 1 x 8 (4 columns a shard), 3 RK4 steps: L + R = 36 >= g, the
    halo wraps the whole ring."""
    w = problem(rng, 32)
    _, ref = jax_full_step(w, 1, 8, 3)
    mesh = make_forecast_analysis_mesh(1, 8, devices=CPU8)
    close(port_step(mesh, 3)(*map(t, w)), ref)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}x{x[1]}")
def test_cycle_matches_the_unsharded_step(rng, layout):
    """Against the port's ``make_cycle_step`` (dense eigh): within 1e-12
    of max; the forecast alone within 1e-13 (the segment's arithmetic is
    the ring's)."""
    w = [t(a) for a in problem(rng, 64)]
    mesh = make_forecast_analysis_mesh(*layout, devices=CPU8)
    integrator = RK4Integrator(Lorenz96(), DT)
    ref = TA.make_cycle_step(integrator, 3, port_loc(), INF)(*w)
    out = port_step(mesh, 3)(*w)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    fc = pf.sharded_forecast(mesh, integrator, 3)(w[0])
    ring = TA._forecast(integrator, 3, w[0])
    assert float((fc - ring).abs().max()) <= 1e-13 * float(ring.abs().max())


def test_forecast_in_f32_is_the_ring_bit_for_bit(rng):
    """f32 through K2's plain version on the CPU: each segment's interior
    equals the whole ring's bit for bit."""
    state = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32))
    integrator = RK4Integrator(Lorenz96(), DT)
    for layout in LAYOUTS:
        mesh = make_forecast_analysis_mesh(*layout, devices=CPU8)
        fc = pf.sharded_forecast(mesh, integrator, 3)(state)
        assert torch.equal(fc, TA._forecast(integrator, 3, state))


def test_one_dim_grid_mesh(rng):
    """A grid mesh without an ``ens`` axis (the dryrun's odd case): every
    member on each position, the analysis over the mesh's one axis."""
    w = [t(a) for a in problem(rng, 48)]
    mesh = make_grid_mesh(3, devices=["cpu"] * 3)
    out = port_step(mesh, 2)(*w)
    ref = TA.make_cycle_step(RK4Integrator(Lorenz96(), DT), 2, port_loc(),
                             INF)(*w)
    close(out, ref, 1e-12)


# -- GlobalTensors, routes and the re-split -----------------------------------

def global_forms(mesh, state):
    """The state as GlobalTensors of three splits: the forecast layout,
    the analysis layout, the columns over the grid axis alone."""
    return {
        "forecast layout": mh.host_local_to_global(mesh, state, axis=(0, 1),
                                                   axis_name=BOTH),
        "analysis layout": mh.host_local_to_global(mesh, state, axis=1,
                                                   axis_name=(BOTH,)),
        "grid axis": mh.host_local_to_global(mesh, state, axis=1),
    }


@pytest.mark.parametrize("form", ["forecast layout", "analysis layout",
                                  "grid axis"])
def test_global_inputs_equal_whole(rng, form):
    """A GlobalTensor state of any split (and grid coords split over the
    analysis axes) gives the whole-tensor step's blocks bit for bit, in
    the analysis layout; that result into the next step equals the whole
    tensors' second step."""
    w = [t(a) for a in problem(rng, 64)]
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    step = port_step(mesh, 3)
    whole = step(*w)
    glob = global_forms(mesh, w[0])[form]
    coords = mh.host_local_to_global(mesh, w[4], axis=0, axis_name=(BOTH,))
    out = step(glob, *w[1:4], coords, w[5])
    assert isinstance(out, mh.GlobalTensor)
    assert out.dims == (1,) and out.axes == (BOTH,) and len(out.blocks) == 8
    assert torch.equal(out.gather(), whole)
    again = step(out, *w[1:])
    assert torch.equal(again.gather(), step(whole, *w[1:]))


def test_forecast_global_input_stays_in_the_forecast_layout(rng):
    w = [t(a) for a in problem(rng, 64)]
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    fc = pf.sharded_forecast(mesh, RK4Integrator(Lorenz96(), DT), 3)
    out = fc(global_forms(mesh, w[0])["analysis layout"])
    assert out.dims == (0, 1) and out.axes == (("ens",), ("grid",))
    assert out.block_shape() == (4, 16)
    assert torch.equal(out.gather(), fc(w[0]))


def test_resplit_copies_exactly(rng):
    """Every pair of splits, both ways: the blocks of ``x`` re-split are
    the whole tensor's slices bit for bit."""
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    state = t(rng.normal(size=(8, 64)))
    forms = global_forms(mesh, state)
    for a in forms.values():
        for b in forms.values():
            got = mh.resplit(a, b)
            assert got.dims == b.dims and got.axes == b.axes
            for key, block in got.blocks.items():
                assert torch.equal(block, state[b.slices(key)])


class ShiftIntegrator(RK4Integrator):
    """An RK4 over Lorenz-96 of another type: its reach is not known."""


def test_unknown_reach_takes_the_whole_ensemble(rng, monkeypatch):
    """An integrator whose reach is not known integrates the whole
    ensemble (no ring exchange) and gives the same step."""
    w = [t(a) for a in problem(rng, 64)]
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    ref = port_step(mesh, 3)(*w)
    monkeypatch.setattr(plk, "exchange_blocks", None)
    out = pf.sharded_cycle_step(mesh, ShiftIntegrator(Lorenz96(), DT), 3,
                                port_loc(), INF)(*w)
    close(out, ref, 0.0)


@pytest.mark.parametrize("n_int, integrator", [(0, "l96"), (3, None)])
def test_no_forecast_is_the_analysis_alone(rng, n_int, integrator):
    w = [t(a) for a in problem(rng, 64)]
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    integ = RK4Integrator(Lorenz96(), DT) if integrator else None
    out = pf.sharded_cycle_step(mesh, integ, n_int, port_loc(), INF)(*w)
    ref = TA.make_letkf_analysis(port_loc(), INF)(*w)
    close(out, ref, 1e-12)


@pytest.mark.parametrize("k, g, layout", [(8, 60, (2, 4)), (6, 64, (4, 2)),
                                          (8, 36, (1, 8))])
def test_uneven_split_raises_before_any_exchange(rng, monkeypatch, k, g,
                                                 layout):
    """Members over ens (6 over 4), columns over the analysis (60 over 8)
    or over the forecast (36 over 8): ValueError, no exchange."""
    def no_call(*a, **kw):
        raise AssertionError("an exchange started")

    for module, name in ((plk, "exchange_blocks"), (plk, "all_blocks"),
                         (mh, "all_blocks"), (mh, "_transfer")):
        monkeypatch.setattr(module, name, no_call)
    w = [t(a) for a in problem(rng, g, k=k)]
    mesh = make_forecast_analysis_mesh(*layout, devices=CPU8)
    with pytest.raises(ValueError, match="split evenly"):
        port_step(mesh, 2)(*w)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_obs_equivalents_copy_exactly(rng, layout):
    """The model equivalents of an ensemble in the forecast layout, with
    observations in every block, repeated and at both ends of the grid,
    are ``x[:, obs_idx]`` bit for bit."""
    state = t(rng.normal(size=(8, 64)))
    obs_idx = torch.as_tensor(np.r_[0, 63, 63, rng.randint(0, 64, 29)])
    mesh = make_forecast_analysis_mesh(*layout, devices=CPU8)
    fc = pf._split(state, pf._forecast_layout(mesh, state.shape))
    keys = fc.keys()
    got = plk.obs_equivalents([fc.blocks[key] for key in keys],
                              fc.splits[1], obs_idx, None, "cpu")
    assert torch.equal(got, state[:, obs_idx])


@pytest.mark.parametrize("shards, k3_calls", [(4, 4), (8, 0)])
def test_k3_gate_sees_the_shard_batch(rng, monkeypatch, shards, k3_calls):
    """f32 at g 1024 with the gate opened to CPU tensors: 4 analysis
    shards of 256 columns give K3's plain version one [256, 8, 8] batch
    each, 8 shards of 128 take LAPACK; both within 1e-5 of max of the
    unsharded step, whose one batch of 1024 takes K3."""
    monkeypatch.setattr(tl, "JACOBI_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.delenv("TPU_ASSIM_JACOBI", raising=False)
    calls = []
    plain = k3.svd_jacobi_plain
    monkeypatch.setattr(k3, "svd_jacobi_plain",
                        lambda a, sweeps=20: calls.append(tuple(a.shape))
                        or plain(a, sweeps))
    w = [a.float() if a.is_floating_point() else a
         for a in map(t, problem(rng, 1024, o=256))]
    mesh = make_forecast_analysis_mesh(2, shards // 2, devices=CPU8)
    out = port_step(mesh, 2)(*w)
    assert calls == [(256, 8, 8)] * k3_calls
    calls.clear()
    ref = TA.make_cycle_step(RK4Integrator(Lorenz96(), DT), 2, port_loc(),
                             INF)(*w)
    assert calls == [(1024, 8, 8)]
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# -- two processes ------------------------------------------------------------

WORKER = """
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
out, repo = sys.argv[1], sys.argv[2]
sys.path.insert(0, repo)
sys.modules["jax"] = None
from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.parallel import multihost as mh
from tpu_assim_torch.parallel.forecast import sharded_cycle_step
from tpu_assim_torch.parallel.mesh import make_forecast_analysis_mesh

mh.initialize_multihost(timeout=60.0)
rank = mh.process_index()
w = dict(np.load(os.path.join(out, "inputs.npz")))
args = [torch.from_numpy(w[n]) for n in ("state", "vals", "var", "idx",
                                         "grid", "ocoords")]
res = {}
for n_ens, n_grid in ((2, 4), (4, 2)):
    # the owners split by grid half: the ring halo, the model equivalents
    # and the re-split cross the processes
    owners = [[0] * (n_grid // 2) + [1] * (n_grid // 2)] * n_ens
    mesh = make_forecast_analysis_mesh(n_ens, n_grid, devices=["cpu"] * 8,
                                       owners=owners)
    step = sharded_cycle_step(mesh, RK4Integrator(Lorenz96(), 0.05), 3,
                              GaspariCohn((4.0,), coord1_distance), 1.1)
    name = f"{n_ens}x{n_grid}"
    res[name] = step(*args)
    half = args[0].shape[1] // 2
    local = args[0][:, rank * half:(rank + 1) * half]
    glob = step(mh.host_local_to_global(mesh, local, axis=(0, 1),
                                        axis_name=("ens", "grid")),
                *args[1:])
    mine = sorted(k for k in glob.keys() if glob.owner(k) == rank)
    assert sorted(glob.blocks) == mine and len(mine) == 4, glob
    res[name + "_blocks"] = glob.gather()
    res[name + "_chain"] = step(glob, *args[1:]).gather()
    try:
        step(args[0][:, :60], *args[1:])
        res[name + "_uneven"] = np.zeros(1)
    except ValueError:
        res[name + "_uneven"] = np.ones(1)
np.savez(os.path.join(out, f"rank{rank}.npz"),
         **{n: np.asarray(v) for n, v in res.items()})
mh.shutdown_multihost()
"""


def test_two_processes_bit_for_bit_one(tmp_path):
    """2 x 4 and 4 x 2 over two gloo processes, 4 shards of ``"cpu"``
    each: whole tensors, blocks, and the blocks' result into a second
    step, each bit for bit the one-process step on both ranks; an uneven
    grid raises on both."""
    rng = np.random.RandomState(11)
    w = problem(rng, 64)
    names = ("state", "vals", "var", "idx", "grid", "ocoords")
    np.savez(tmp_path / "inputs.npz", **dict(zip(names, w)))
    run_two(tmp_path, "cycle", command=[sys.executable, "-c", WORKER,
                                        str(tmp_path), REPO])
    args = [t(a) for a in w]
    for layout in [(2, 4), (4, 2)]:
        mesh = make_forecast_analysis_mesh(*layout, devices=CPU8)
        step = port_step(mesh, 3)
        one = step(*args)
        chain = step(one, *args[1:])
        name = f"{layout[0]}x{layout[1]}"
        for rank in (0, 1):
            got = dict(np.load(tmp_path / f"rank{rank}.npz"))
            for form in ("", "_blocks"):
                np.testing.assert_array_equal(got[name + form], one.numpy())
            np.testing.assert_array_equal(got[name + "_chain"],
                                          chain.numpy())
            assert got[name + "_uneven"][0] == 1
