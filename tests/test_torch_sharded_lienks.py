"""
The port's grid-sharded localized IEnKS step
(tpu_assim_torch.parallel.lienks.sharded_lienks_step) against the JAX
package's ``make_lienks_step`` auto-partitioned over its 8 virtual CPU
devices (``NamedSharding(mesh, P(None, "grid"))``, tests/conftest.py) and
against the port's own local step, on the same numpy inputs in f64. The
port runs on ``make_grid_mesh(8, devices=["cpu"] * 8)``: 8 virtual shards.

- JAX's case (tests/test_parallel.py::test_lienks_step_auto_shards: g 64,
  k 10, 3 RK4 steps, tau 0.8, window of 18, GC r = 4, an observation at
  every second point): within 1e-10 of JAX, both kinds; so are halos
  narrower than a shard, of several shards that wrap the ring, and of
  ``L + R >= g``.
- Port against port: within 1e-12 of max|local|. The bundle holds that
  bar on shards of 32 columns, where it is bit for bit; on shards of 8 or
  4 columns torch's CPU mean over members sums in another order than on
  the whole grid (an ulp), which the bundle's 1 / eps = 1e4 lifts to
  ~2e-12 of max, so those shards are held to JAX's 1e-10 only.
- The strict window's NaN columns, the routes without a forecast (no
  exchange), a custom obs operator and a forcing that varies over the
  grid (the whole pseudo-ensemble), GlobalTensor inputs, an uneven grid
  (ValueError before any exchange).
- The segment forecast alone equals the whole ring's bit for bit, in f64
  (the integrator's steps) and f32 (K2's plain version).
- The K3 gate sees each shard's batch: 256 columns a shard go to K3's
  plain version (the gate opened to CPU tensors), 128 to LAPACK.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_assim.analysis import make_lienks_step as j_make_lienks_step
from tpu_assim.models import Lorenz96 as JLorenz96
from tpu_assim.models import RK4Integrator as JRK4
from tpu_assim.ops.localization import GaspariCohn as JGaspariCohn
from tpu_assim.parallel import make_grid_mesh as j_grid_mesh

from tpu_assim_torch import analysis as TA
from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.models import Lorenz96, RK4Integrator
from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops.cuda import svd as k3
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.parallel import lienks as plk
from tpu_assim_torch.parallel import make_grid_mesh, sharded_lienks_step
from tpu_assim_torch.parallel import multihost as mh

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10          # against JAX: the JAX test's own bar
PORT_TOL = 1e-12     # against the port's local step, of max|local|
CPU8 = ["cpu"] * 8
DT = 0.05

# halo against shard size: (g, RK4 steps); 8 shards
HALOS = {
    "narrower than a shard": (256, 2),      # L 16, R 8; 32 a shard
    "several shards, wrapping": (64, 3),    # L 24, R 12; 8 a shard
    "L + R >= g": (32, 3),                  # L 24, R 12; 4 a shard
}


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def of_max(port, ref, tol=PORT_TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    ok = ~np.isnan(ref)
    err = np.abs(port[ok] - ref[ok]).max()
    assert err <= tol * np.abs(ref[ok]).max(), err


def case(rng, g, k=10):
    """JAX's case at grid ``g``: (state, obs_vals, obs_var, obs_idx,
    grid_coords, obs_coords) as numpy, an observation every 2nd point."""
    obs_idx = np.arange(0, g, 2, dtype=np.int32)
    grid = np.arange(g, dtype=np.float64)[:, None]
    return (rng.normal(size=(k, g)) + 2.0, rng.normal(size=g // 2),
            np.full(g // 2, 0.5), obs_idx, grid, grid[obs_idx])


def torch_args(w):
    return [torch.from_numpy(np.asarray(a)) for a in w]


def opts(kind, max_obs=18):
    return dict(n_outer=2, kind=kind, tau=0.8, max_obs=max_obs,
                selection="window")


def port_step(n_int, kind, mesh=None, integrator="l96", **kw):
    integ = RK4Integrator(Lorenz96(), DT) if integrator == "l96" \
        else integrator
    loc = GaspariCohn((4.0,), coord1_distance)
    return sharded_lienks_step(mesh or make_grid_mesh(8, devices=CPU8), loc,
                               integ, n_int, **{**opts(kind), **kw})


def local_step(n_int, kind, integrator="l96", **kw):
    integ = RK4Integrator(Lorenz96(), DT) if integrator == "l96" \
        else integrator
    return TA.make_lienks_step(GaspariCohn((4.0,), coord1_distance), integ,
                               n_int, **{**opts(kind), **kw})


def jax_sharded(w, n_int, kind, **kw):
    """JAX's step on its 8 devices with the state split over the grid."""
    step = j_make_lienks_step(JGaspariCohn((4.0,), jax_coord1),
                              JRK4(JLorenz96(), DT), n_int,
                              **{**opts(kind), **kw})
    state = jax.device_put(jnp.asarray(w[0]),
                           NamedSharding(j_grid_mesh(8), P(None, "grid")))
    return np.asarray(step(state, *map(jnp.asarray, w[1:])))


# -- against JAX --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["transform", "bundle"])
def test_matches_jax_auto_sharded(rng, kind):
    """tests/test_parallel.py::test_lienks_step_auto_shards through the
    port: its halo of 24 left and 12 right spans three shards left and two
    right, and shard 0's comes from shards 7, 6 and 5."""
    w = case(rng, 64)
    out = port_step(3, kind)(*torch_args(w))
    assert out.shape == (10, 64) and out.dtype == torch.float64
    close(out, jax_sharded(w, 3, kind))
    sources, _ = plk.segment_plan(64, 8, 24, 12)[0]
    assert sources == [0, 1, 2, 5, 6, 7]


@pytest.mark.parametrize("kind", ["transform", "bundle"])
@pytest.mark.parametrize("halo", sorted(HALOS))
def test_halo_against_shard_size(rng, halo, kind):
    g, n_int = HALOS[halo]
    w = case(rng, g)
    close(port_step(n_int, kind)(*torch_args(w)), jax_sharded(w, n_int, kind))


@pytest.mark.parametrize("halo,kind", [
    (h, "transform") for h in sorted(HALOS)] + [
    ("narrower than a shard", "bundle")])
def test_equals_local_step(rng, halo, kind):
    g, n_int = HALOS[halo]
    args = torch_args(case(rng, g))
    of_max(port_step(n_int, kind)(*args), local_step(n_int, kind)(*args))


def test_segment_plan_covers_the_ring():
    """Every segment column maps to its global column, for each halo."""
    for g, n_int in HALOS.values():
        left, right = 8 * n_int, 4 * n_int
        size = g // 8
        for s, (sources, index) in enumerate(plk.segment_plan(g, 8, left,
                                                              right)):
            laid = np.concatenate([np.arange(src * size, (src + 1) * size)
                                   for src in sources])
            want = (s * size - left + np.arange(left + size + right)) % g
            np.testing.assert_array_equal(laid[index], want)


# -- the segment forecast -----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("halo", sorted(HALOS))
def test_segment_forecast_is_the_ring_forecast(rng, halo, dtype):
    """Each shard's segment, stepped and cut to its interior, equals the
    whole ring's forecast of its columns bit for bit (f32 takes K2's plain
    version through ``fused_rk4_steps``)."""
    g, n_int = HALOS[halo]
    integ = RK4Integrator(Lorenz96(), DT)
    x = torch.as_tensor(rng.normal(size=(10, g)) + 2.0, dtype=dtype)
    ring = TA._forecast(integ, n_int, x)
    left, right = plk.ring_reach(integ, n_int)
    size = g // 8
    blocks = list(x.split(size, dim=1))
    for s, (sources, index) in enumerate(plk.segment_plan(g, 8, left,
                                                          right)):
        segment = torch.cat([blocks[i] for i in sources], dim=1)[:, index]
        got = TA._forecast(integ, n_int, segment)[:, left:left + size]
        assert torch.equal(got, ring[:, s * size:(s + 1) * size])


def test_ring_reach():
    assert plk.ring_reach(RK4Integrator(Lorenz96(), DT), 3) == (24, 12)
    assert plk.ring_reach(RK4Integrator(Lorenz96(torch.tensor(8.0)), DT),
                          1) == (8, 4)
    assert plk.ring_reach(RK4Integrator(Lorenz96(torch.full((16,), 8.0)),
                                        DT), 1) is None
    assert plk.ring_reach(RK4Integrator(lambda x: -x, DT), 1) is None


# -- strict window, routes and edge cases -------------------------------------

@pytest.mark.parametrize("kind", ["transform", "bundle"])
def test_strict_window_nan_columns(rng, kind):
    """With ``max_obs`` two below the in-support maximum, the sharded step
    is NaN at exactly the local step's NaN columns and equals it
    elsewhere (10 columns a shard)."""
    g, o, k = 80, 40, 8
    obs_idx = np.sort(rng.choice(g, size=o, replace=False)).astype(np.int32)
    grid = np.arange(g, dtype=np.float64)[:, None]
    w = (rng.normal(size=(k, g)) + 2.0, rng.normal(size=o) + 2.0,
         np.full(o, 0.5), obs_idx, grid, obs_idx.astype(np.float64)[:, None])
    from tpu_assim.ops.pallas.letkf import max_in_support_1d
    nb = max_in_support_1d(w[5][:, 0], w[4][:, 0], 4.0) - 2
    args = torch_args(w)
    ref = local_step(3, kind, max_obs=nb)(*args).numpy()
    out = port_step(3, kind, max_obs=nb)(*args).numpy()
    nan_cols = np.isnan(ref).any(axis=0)
    assert 0 < nan_cols.sum() < g
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    close(out, ref)


@pytest.mark.parametrize("integrator,n_int", [(None, 3), ("l96", 0)])
def test_no_forecast_makes_no_exchange(rng, monkeypatch, integrator, n_int):
    def no_exchange(*args, **kwargs):
        raise AssertionError("the step exchanged a halo")

    monkeypatch.setattr(plk, "exchange_blocks", no_exchange)
    args = torch_args(case(rng, 64))
    close(port_step(n_int, "transform", integrator=integrator)(*args),
          local_step(n_int, "transform", integrator=integrator)(*args))


def test_custom_obs_operator(rng):
    """A custom obs operator gets the whole pseudo-ensemble: equal to the
    local step with the same operator, and to JAX's."""
    w = case(rng, 64)
    idx = w[3]
    op = lambda x: 0.5 * x[:, idx] ** 2                      # noqa: E731
    args = torch_args(w)
    out = port_step(3, "transform", obs_operator=op)(*args)
    of_max(out, local_step(3, "transform", obs_operator=op)(*args))
    ref = j_make_lienks_step(JGaspariCohn((4.0,), jax_coord1),
                             JRK4(JLorenz96(), DT), 3,
                             obs_operator=lambda x: 0.5 * x[:, idx] ** 2,
                             **opts("transform"))(*map(jnp.asarray, w))
    close(out, ref)


def test_forcing_over_the_grid_takes_the_whole_ring(rng, monkeypatch):
    """A forcing that varies over the grid has no known reach: the step
    forecasts the whole pseudo-ensemble, with no halo exchange."""
    monkeypatch.setattr(plk, "exchange_blocks", None)
    forcing = torch.as_tensor(rng.uniform(6.0, 10.0, size=64))
    integ = RK4Integrator(Lorenz96(forcing), DT)
    args = torch_args(case(rng, 64))
    of_max(port_step(3, "transform", integrator=integ)(*args),
           local_step(3, "transform", integrator=integ)(*args))


def test_global_tensor_inputs_give_this_process_blocks(rng):
    mesh = make_grid_mesh(8, devices=CPU8)
    args = torch_args(case(rng, 64))
    step = port_step(3, "bundle", mesh=mesh)
    whole = step(*args)
    glob = step(mh.host_local_to_global(mesh, args[0], axis=1), *args[1:4],
                mh.host_local_to_global(mesh, args[4], axis=0), args[5])
    assert isinstance(glob, mh.GlobalTensor) and len(glob.blocks) == 8
    assert glob.dims == (1,)
    assert torch.equal(glob.gather(), whole)


def test_uneven_grid_raises_before_any_exchange(rng, monkeypatch):
    def no_call(*args, **kwargs):
        raise AssertionError("an exchange before the check")

    monkeypatch.setattr(plk, "exchange_blocks", no_call)
    monkeypatch.setattr(plk, "all_blocks", no_call)
    with pytest.raises(ValueError, match="split evenly"):
        port_step(3, "transform")(*torch_args(case(rng, 60)))


def test_bad_options_raise():
    with pytest.raises(ValueError, match="kind"):
        port_step(3, "newton")
    with pytest.raises(ValueError, match="selection"):
        port_step(3, "transform", selection="nearest")


# -- the K3 gate at shard shapes ----------------------------------------------

@pytest.mark.parametrize("shards,k3_calls", [(8, 32), (16, 0)])
def test_k3_gate_sees_the_shard_batch(rng, monkeypatch, shards, k3_calls):
    """f32 at g 2048 with the gate opened to CPU tensors: 8 shards of 256
    columns give K3's plain version 4 batches of [256, 10, 10] a shard
    (2 outer iterations), 16 shards of 128 take LAPACK; both equal the
    local step, whose one batch of 2048 takes K3, within 1e-5 of max."""
    monkeypatch.setattr(tl, "JACOBI_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.delenv("TPU_ASSIM_JACOBI", raising=False)
    calls = []
    plain = k3.svd_jacobi_plain
    monkeypatch.setattr(k3, "svd_jacobi_plain",
                        lambda a, sweeps=20: calls.append(tuple(a.shape))
                        or plain(a, sweeps))
    w = case(rng, 2048)
    args = [a.float() if a.is_floating_point() else a
            for a in torch_args(w)]
    mesh = make_grid_mesh(shards, devices=["cpu"] * shards)
    out = port_step(4, "transform", mesh=mesh, max_obs=8)(*args)
    assert calls == [(256, 10, 10)] * k3_calls
    calls.clear()
    ref = local_step(4, "transform", max_obs=8)(*args)
    assert calls == [(2048, 10, 10)] * 4
    assert out.dtype == torch.float32
    of_max(out, ref, 1e-5)
