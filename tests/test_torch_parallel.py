"""
The port's parallel layer (tpu_assim_torch.parallel: mesh, grid-sharded
LETKF, and the halo exchanges with kernel K8's wrapper) against the JAX
package on the same numpy inputs. JAX runs on its 8-device CPU mesh
(tests/conftest.py), the port on ``make_grid_mesh(8, devices=["cpu"] *
8)``: 8 virtual shards.

- Meshes: the same axis names and extents; ``convert.from_tpu_assim``
  carries a JAX mesh across.
- Sharded weights and analysis: within 1e-10 of JAX in f64.
- The halo exchange: ``ring_halo_plain`` equals JAX's ``_ring_halo_rdma``
  in interpret mode (and ``_ring_halo``) exactly, for rings of 2, 3 and 8
  and halos 1 and 2; ``ring_halo_rdma`` on CPU shards is the plain version
  and launches nothing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from tpu_assim.ops import etkf as je
from tpu_assim.ops.localization import GaspariCohn as JGaspariCohn
from tpu_assim.parallel import halo as jh
from tpu_assim.parallel import letkf as jpl
from tpu_assim.parallel import mesh as jmesh

from tpu_assim_torch import _build, convert
from tpu_assim_torch.parallel import cuda_halo, halo as th
from tpu_assim_torch.parallel import (
    letkf as tpl,
    make_forecast_analysis_mesh,
    make_grid_mesh,
    replicate,
    shard_state,
)
from tpu_assim_torch.parallel.mesh import Mesh
from tpu_assim_torch.state import EnsembleState

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

TOL = 1e-10
CPU8 = ["cpu"] * 8


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def t(a):
    return torch.from_numpy(np.asarray(a))


# -- meshes -------------------------------------------------------------------

def test_grid_mesh_shape_and_devices():
    mesh = make_grid_mesh(8, devices=CPU8)
    ref = jmesh.make_grid_mesh(8)
    assert mesh.axis_names == ref.axis_names == ("grid",)
    assert mesh.shape == dict(ref.shape) == {"grid": 8}
    assert mesh.devices.shape == (8,) and mesh.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert make_grid_mesh(devices=CPU8[:3]).shape == {"grid": 3}


def test_forecast_analysis_mesh():
    mesh = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    ref = jmesh.make_forecast_analysis_mesh(2, 4)
    assert mesh.shape == dict(ref.shape) == {"ens": 2, "grid": 4}
    assert mesh.axis_names == ref.axis_names
    with pytest.raises(ValueError, match="devices"):
        make_forecast_analysis_mesh(3, 4, devices=CPU8)


def test_mesh_errors():
    with pytest.raises(ValueError, match="devices"):
        make_grid_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(CPU8, ("grid", "ens"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_grid_mesh(8)


def test_convert_jax_mesh():
    ref = JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("grid", "aux"))
    mesh = convert.from_tpu_assim(ref, device="cpu")
    assert isinstance(mesh, Mesh)
    assert mesh.axis_names == ref.axis_names
    assert mesh.shape == dict(ref.shape)
    assert mesh.devices.shape == ref.devices.shape


def test_shard_state_and_replicate(rng):
    data = rng.randn(1, 2, 4, 16)
    state = EnsembleState(t(data), grid_coords=torch.arange(16.0)[:, None])
    shards = shard_state(state, make_grid_mesh(8, devices=CPU8))
    assert len(shards) == 8 and all(s.valid for s in shards)
    close(torch.cat([s.data for s in shards], dim=-1), data)
    close(torch.cat([s.grid_coords for s in shards]), state.grid_coords)
    # a 2-axis mesh: each position holds the block of its grid coordinate
    mesh2 = make_forecast_analysis_mesh(2, 4, devices=CPU8)
    shards2 = shard_state(state, mesh2)
    assert len(shards2) == 8
    for e in range(2):
        close(torch.cat([s.data for s in shards2[e * 4:(e + 1) * 4]], -1),
              data)
    with pytest.raises(ValueError):
        shard_state(state.replace(data=state.data[..., :15]),
                    make_grid_mesh(8, devices=CPU8))
    copies = replicate(state.data, mesh2)
    assert len(copies) == 8 and all(torch.equal(c, state.data)
                                    for c in copies)


# -- grid-sharded LETKF -------------------------------------------------------

@pytest.fixture
def problem(rng):
    """tests/test_parallel.py's problem."""
    k, l, g = 10, 24, 64
    perts = rng.randn(k, l)
    innov = rng.randn(l)
    grid_info = np.hstack([np.zeros((g, 1)), np.arange(g)[:, None] * 1.0])
    obs_info = np.hstack([np.zeros((l, 1)), rng.uniform(0, g, size=(l, 1))])
    return perts, innov, grid_info, obs_info


def meshes():
    """The port's and JAX's 1-D mesh of 8, and a 2-axis one."""
    return [
        (make_grid_mesh(8, devices=CPU8), jmesh.make_grid_mesh(8)),
        (make_forecast_analysis_mesh(2, 4, devices=CPU8),
         jmesh.make_forecast_analysis_mesh(2, 4)),
    ]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("localized", [True, False])
def test_sharded_weights_match_jax(problem, which, localized):
    port_mesh, jax_mesh = meshes()[which]
    jl = JGaspariCohn((8.0,), jax_coord1) if localized else None
    tl = convert.from_tpu_assim(jl) if localized else None
    ref = jpl.sharded_letkf_weights(jax_mesh, jl,
                                    *map(jnp.asarray, problem), 1.1)
    out = tpl.sharded_letkf_weights(port_mesh, tl, *map(t, problem), 1.1)
    assert out.shape == (64, 10, 10)
    close(out, ref)


@pytest.mark.parametrize("chunksize", [None, 3])
def test_sharded_analysis_matches_jax_and_local(problem, rng, chunksize):
    perts, innov, grid_info, obs_info = problem
    state = rng.randn(2, 1, 10, 64)
    jl = JGaspariCohn((8.0,), jax_coord1)
    ref = jpl.sharded_letkf_analysis(
        jmesh.make_grid_mesh(8), jl, jnp.asarray(state),
        *map(jnp.asarray, problem), 1.1, chunksize=chunksize)
    out = tpl.sharded_letkf_analysis(
        make_grid_mesh(8, devices=CPU8), convert.from_tpu_assim(jl), t(state),
        *map(t, problem), 1.1, chunksize=chunksize)
    close(out, ref)
    # the local oracle: the dense weights applied on the whole grid
    w_loc = jl.taper_weights(jnp.asarray(grid_info), jnp.asarray(obs_info))
    weights = np.asarray(je.letkf_weights_dense(
        jnp.asarray(perts), jnp.asarray(innov), w_loc, 1.1))
    mean = state.mean(axis=2, keepdims=True)
    close(out, mean + np.einsum("vtkg,gkm->vtmg", state - mean, weights))


def test_sharded_grid_must_split_evenly(problem):
    perts, innov, grid_info, obs_info = problem
    with pytest.raises(ValueError, match="evenly"):
        tpl.sharded_letkf_weights(make_grid_mesh(8, devices=CPU8), None,
                                  t(perts), t(innov), t(grid_info[:60]),
                                  t(obs_info), 1.0)


# -- the halo exchange --------------------------------------------------------

@pytest.mark.parametrize("n,halo", [(2, 1), (2, 2), (3, 1), (3, 2), (8, 1),
                                    (8, 2)])
def test_ring_halo_matches_jax_rdma(rng, n, halo):
    """Slot j+1 of shard s holds the block of shard (s - off_j): the port's
    plain exchange against JAX's RDMA kernel (interpret mode) and its
    ppermute ring, bit for bit; aliased hops on rings of 2 and 3 come once."""
    rows, o_ps = 8, 16
    packed = rng.randn(rows, n * o_ps)
    mesh = JMesh(np.array(jax.devices()[:n]), ("grid",))

    def via(fn):
        return np.asarray(jax.jit(jax.shard_map(
            lambda p: fn(p, "grid", n, halo), mesh=mesh,
            in_specs=P(None, "grid"), out_specs=P(None, "grid"),
            check_vma=False))(jnp.asarray(packed)))

    ref = via(jh._ring_halo_rdma)
    np.testing.assert_array_equal(ref, via(jh._ring_halo))
    blocks = [t(packed[:, s * o_ps:(s + 1) * o_ps]).contiguous()
              for s in range(n)]
    out = cuda_halo.ring_halo_plain(blocks, n, halo)
    width = out[0].shape[1]
    assert width == (1 + len(jh._halo_offsets(n, halo))) * o_ps
    np.testing.assert_array_equal(torch.cat(out, dim=1).numpy(), ref)
    before = dict(cuda_halo.LAUNCHES)
    rdma = cuda_halo.ring_halo_rdma(blocks, n, halo)
    assert cuda_halo.LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(rdma, out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int32])
def test_ring_halo_layout_per_dtype(dtype):
    n, rows, cols = 5, 3, 4
    blocks = [torch.arange(rows * cols).reshape(rows, cols).to(dtype) + 100 * s
              for s in range(n)]
    out = cuda_halo.ring_halo_rdma(blocks, n, 2)
    offsets = cuda_halo._halo_offsets(n, 2)
    assert offsets == [1, 4, 2, 3]
    for s in range(n):
        assert out[s].dtype == dtype and out[s].shape == (rows, 5 * cols)
        expect = [s] + [(s - off) % n for off in offsets]
        for j, src in enumerate(expect):
            assert torch.equal(out[s][:, j * cols:(j + 1) * cols], blocks[src])


@pytest.mark.parametrize("n,halo", [(1, 1), (1, 3), (4, 0)])
def test_ring_halo_without_offsets_returns_blocks(rng, n, halo):
    blocks = [t(rng.randn(3, 4)) for _ in range(n)]
    assert th._halo_offsets(n, halo) == jh._halo_offsets(n, halo) == []
    for fn in (cuda_halo.ring_halo_plain, cuda_halo.ring_halo_rdma):
        out = fn(blocks, n, halo)
        assert all(a is b for a, b in zip(out, blocks))


def test_ring_halo_rejects_bad_blocks(rng):
    blocks = [t(rng.randn(3, 4)) for _ in range(4)]
    with pytest.raises(ValueError, match="4 blocks"):
        cuda_halo.ring_halo_rdma(blocks, 5, 1)
    with pytest.raises(ValueError, match="one shape"):
        cuda_halo.ring_halo_rdma(blocks[:3] + [t(rng.randn(3, 5))], 4, 1)
    with pytest.raises(ValueError, match="one shape"):
        cuda_halo.ring_halo_plain(blocks[:3] + [blocks[3].float()], 4, 1)


def test_halo_offsets_equal_jax():
    for n in range(1, 10):
        for halo in range(0, 5):
            assert th._halo_offsets(n, halo) == jh._halo_offsets(n, halo)


def test_halo_ring_is_a_registered_kernel():
    assert "halo_ring" in _build.KERNELS
    assert (_build.CSRC / "halo_ring.cu").is_file()
    assert cuda_halo.LAUNCHES.keys() == {"halo_ring"}
