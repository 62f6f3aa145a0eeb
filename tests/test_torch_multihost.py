"""
The port's multi-process layer (tpu_assim_torch.parallel.multihost) against
the JAX package and against the port in one process.

- One process: the counterparts of tests/test_multihost.py's helpers
  (``process_info``, ``global_grid_mesh``, ``host_local_to_global``, the
  no-op ``initialize_multihost``); GlobalTensor inputs give the halo and
  grid-sharded analyses the whole-tensor results bit for bit;
  ``comm="rdma"`` on a mesh that spans processes raises.
- Two processes (gloo on the CPU, 4 shards of ``"cpu"`` each), started by
  subprocess: the windowed, top-k eigh, ``use_pallas`` (K4's plain
  version) and 2-D halo analyses and ``sharded_letkf_analysis``, from
  whole tensors and from ``host_local_to_global`` blocks, each equal bit
  for bit to the port's one-process 8-shard analysis; the eigh routes
  equal JAX's on its 8 virtual CPU devices within 1e-10, the f32 kernel
  routes within 1e-5 of max|ref| (their tolerance in
  tests/test_torch_halo.py); the sharded weight checkpoint (DCP) written
  by both processes loads whole and by mesh; a strict-window violation
  raises on both ranks and neither hangs.
- Every run of two processes has a process-group timeout of 60 s and a
  join limit of 120 s, after which the children are killed and the test
  fails.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

import tpu_assim.ops.pallas.letkf as jpk
from tpu_assim.ops.localization import GaspariCohn as JGaspariCohn
from tpu_assim.parallel import halo as jh
from tpu_assim.parallel import letkf as jpl
from tpu_assim.parallel import multihost as jmh
from tpu_assim.parallel.mesh import make_grid_mesh as jax_grid_mesh

from tpu_assim_torch.convert import coord1_distance
from tpu_assim_torch.ops.localization import GaspariCohn
from tpu_assim_torch.parallel import halo as th
from tpu_assim_torch.parallel import letkf as tpl
from tpu_assim_torch.parallel import make_grid_mesh
from tpu_assim_torch.parallel import multihost as mh
from tpu_assim_torch.parallel.mesh import Mesh
from tpu_assim_torch.utils import checkpoint as ckpt

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10
KERNEL_TOL = 1e-5
CPU8 = ["cpu"] * 8
GROUP_TIMEOUT = 60      # seconds: the process group's timeout
JOIN_LIMIT = 120        # seconds: the children's join, then they are killed
RADIUS, R2 = 4.0, 3.0


def close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def rel_close(port, ref, tol=KERNEL_TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    err = np.abs(port - ref).max()
    assert err <= tol * np.abs(ref).max(), err


def jax_coord1(gc, oi):
    return jnp.abs(oi[:, 1] - gc[1])[None, :]


def jax_dist2d(gc, oi):
    return jnp.abs(oi[:, 1:3] - gc[1:3][None, :]).T


def dist2d(gc, oi):
    return torch.abs(oi[:, 1:3] - gc[1:3][None, :]).T


def inputs(seed=7):
    """The 1-D workload of tests/test_torch_halo.py (ens 10, grid 128, 48
    obs, f64) sharded over 8, the 2-D one (16 x 24, 60 obs) over 2 x 4
    tiles, and the grid-sharded problem of tests/test_torch_parallel.py."""
    rng = np.random.RandomState(seed)
    state = rng.normal(size=(10, 128))
    idx = np.sort(rng.choice(128, size=48, replace=False))
    grid = np.arange(128, dtype=np.float64)[:, None]
    sh = th.shard_observations(rng.normal(size=48), rng.uniform(0.3, 1.5, 48),
                               idx, grid[idx], 128, 8)
    state2 = rng.normal(size=(8, 16, 24))
    flat = rng.choice(16 * 24, size=60, replace=False)
    ij = np.stack([flat // 24, flat % 24], 1).astype(np.int32)
    rr, cc = np.meshgrid(np.arange(16.0), np.arange(24.0), indexing="ij")
    grid2 = np.stack([rr, cc], axis=-1)
    sh2 = th.shard_observations_2d(rng.normal(size=60),
                                   rng.uniform(0.4, 1.2, 60), ij,
                                   grid2[ij[:, 0], ij[:, 1]], (16, 24),
                                   (2, 4))
    k, l, g = 10, 24, 64
    return {
        "state": state, "vals": sh[0], "var": sh[1], "lidx": sh[2],
        "ocoords": sh[3], "valid": sh[4], "grid": grid,
        "state2": state2, "vals2": sh2[0], "var2": sh2[1], "lidx2": sh2[2],
        "ocoords2": sh2[3], "valid2": sh2[4], "grid2": grid2,
        "data": rng.normal(size=(2, 1, k, g)), "perts": rng.randn(k, l),
        "innov": rng.randn(l),
        "ginfo": np.hstack([np.zeros((g, 1)), np.arange(g)[:, None] * 1.0]),
        "oinfo": np.hstack([np.zeros((l, 1)),
                            rng.uniform(0, g, size=(l, 1))]),
    }


def args1(w):
    return [w[n] for n in ("state", "vals", "var", "lidx", "ocoords",
                           "valid", "grid")]


def args2(w):
    return [w[n] for n in ("state2", "vals2", "var2", "lidx2", "ocoords2",
                           "valid2", "grid2")]


# The analyses each process runs, by name: (options, 1-D or 2-D). The
# kernel routes pin their degree; max_obs covers the in-support maximum.
ANALYSES = {
    "window": (dict(max_obs=32, halo_width=1, inf_factor=1.1,
                    local_method="window", cheb_degree=12), 1),
    "topk_eigh": (dict(max_obs=32, halo_width=1, inf_factor=1.1), 1),
    "pallas": (dict(max_obs=32, halo_width=1, inf_factor=1.1,
                    use_pallas=True, cheb_degree=12), 1),
    "topk_2d": (dict(max_obs=32, grid_shape=(16, 24), halo=(1, 1),
                     inf_factor=1.1), 2),
    "pallas_auto": (dict(max_obs=32, halo_width=1, inf_factor=1.1,
                         use_pallas=True), 1),
    "window_2d": (dict(max_obs=40, grid_shape=(16, 24), halo=(1, 1),
                       inf_factor=1.1, local_method="window",
                       obs_block=-(-9 * len(inputs()["vals2"]) // 64) * 8,
                       cheb_degree=12), 2),
    "pallas_2d_auto": (dict(max_obs=32, grid_shape=(16, 24), halo=(1, 1),
                            inf_factor=1.1, use_pallas=True), 2),
}

WORKER = textwrap.dedent("""
    import ast, json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    rank, port, out, mode = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    sys.path.insert(0, sys.argv[5])
    sys.modules["jax"] = None
    from tpu_assim_torch.convert import coord1_distance
    from tpu_assim_torch.ops.localization import GaspariCohn
    from tpu_assim_torch.parallel import halo as th, letkf as tpl
    from tpu_assim_torch.parallel import multihost as mh
    from tpu_assim_torch.parallel.mesh import Mesh
    from tpu_assim_torch.utils import checkpoint as ckpt
    if mode in ("strict", "cards"):
        # torchrun's env:// variables, set by the test
        mh.initialize_multihost(timeout=float(sys.argv[6]))
    else:
        mh.initialize_multihost(f"tcp://localhost:{port}", 2, rank,
                                timeout=float(sys.argv[6]))
    if mode == "cards":
        # a host of two cards seen by both processes, as torchrun leaves
        # them: each contributes its own card to the default mesh
        torch.cuda.is_available = lambda: True
        torch.cuda.device_count = lambda: 2
        own = mh.global_grid_mesh()
        with open(os.path.join(out, f"cards{rank}.json"), "w") as f:
            json.dump({"devices": [str(d) for d in own.devices],
                       "owners": own.owners.tolist(),
                       "info": mh.process_info()}, f)
        sys.exit(0)
    spec = ast.literal_eval(sys.argv[7])
    w = dict(np.load(os.path.join(out, "inputs.npz")))
    t = {n: torch.from_numpy(a) for n, a in w.items()}
    mesh = mh.global_grid_mesh(devices=["cpu"] * 4)
    assert mesh.owners.tolist() == [0] * 4 + [1] * 4, mesh.owners
    mesh2 = Mesh(mesh.devices.reshape(2, 4), ("row", "col"),
                 owners=mesh.owners.reshape(2, 4))
    loc = GaspariCohn((4.0,), coord1_distance)
    loc2 = GaspariCohn((3.0,),
                       lambda gc, oi: torch.abs(oi[:, 1:3] - gc[1:3][None]).T)
    one = [t[n] for n in ("state", "vals", "var", "lidx", "ocoords",
                          "valid", "grid")]
    two = [t[n] for n in ("state2", "vals2", "var2", "lidx2", "ocoords2",
                          "valid2", "grid2")]
    local = lambda a, dim: a.narrow(dim, rank * a.shape[dim] // 2,
                                    a.shape[dim] // 2)
    res = {}
    if mode == "strict":
        fn = th.halo_letkf_analysis(mesh, loc, max_obs=2, halo_width=1,
                                    inf_factor=1.1, local_method="window")
        for label, args in (("whole", one), ("global", [
                mh.host_local_to_global(mesh, local(a, d), axis=d)
                for a, d in zip(one, (1, 0, 0, 0, 0, 0, 0))])):
            try:
                fn(*args)
                res[label] = "returned"
            except ValueError as exc:
                res[label] = "raised: " + str(exc)
        with open(os.path.join(out, f"strict{rank}.json"), "w") as f:
            json.dump(res, f)
        sys.exit(0)
    info = mh.process_info(devices=["cpu"] * 4)
    assert info == {"process_index": rank, "process_count": 2,
                    "local_devices": 4, "global_devices": 8}, info
    for name, (opts, dims) in spec.items():
        if dims == 1:
            fn = th.halo_letkf_analysis(mesh, loc, **opts)
            res[name] = fn(*one)
            glob = fn(*[mh.host_local_to_global(mesh, local(a, d), axis=d)
                        for a, d in zip(one, (1, 0, 0, 0, 0, 0, 0))])
        else:
            fn = th.halo_letkf_analysis_2d(mesh2, loc2, **opts)
            res[name] = fn(*two)
            rows = lambda a, d: mh.host_local_to_global(
                mesh2, local(a, d), axis=(d, d + 1),
                axis_name=("row", "col"))
            glob = fn(rows(two[0], 1), *[mh.host_local_to_global(
                mesh2, local(a, 0), axis=0, axis_name=(("row", "col"),))
                for a in two[1:6]], rows(two[6], 0))
        assert sorted(glob.blocks) == sorted(
            k for k in glob.keys() if glob.owner(k) == rank), glob
        res[name + "_global"] = glob.gather()
    sh = (mesh, loc, t["data"], t["perts"], t["innov"])
    res["sharded"] = tpl.sharded_letkf_analysis(*sh, t["ginfo"], t["oinfo"],
                                                1.1)
    res["sharded_global"] = tpl.sharded_letkf_analysis(
        mesh, loc, mh.host_local_to_global(mesh, local(t["data"], 3),
                                           axis=3),
        t["perts"], t["innov"], t["ginfo"], t["oinfo"], 1.1).gather()
    weights = tpl.sharded_letkf_weights(
        mesh, loc, t["perts"], t["innov"],
        mh.host_local_to_global(mesh, local(t["ginfo"], 0), axis=0),
        t["oinfo"], 1.1)
    ckpt.save_weights_sharded(os.path.join(out, "weights"), weights)
    torch.distributed.barrier()
    back = ckpt.load_weights_sharded(os.path.join(out, "weights"),
                                     mesh=mesh)
    res["weights"] = weights.gather()
    res["weights_by_mesh"] = back.gather()
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{n: v.numpy() for n, v in res.items()})
    torch.distributed.destroy_process_group()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two(out, mode, spec=None, command=None):
    """Runs WORKER (or ``command``) as ranks 0 and 1 on the CPU, with
    torchrun's env:// variables set; kills both and fails when they
    outlive JOIN_LIMIT. Returns their standard outputs."""
    port = str(free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                   MASTER_PORT=port, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            command or [sys.executable, "-c", WORKER, str(rank), port,
                        str(out), mode, REPO, str(GROUP_TIMEOUT),
                        repr(spec or {})],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    try:
        results = [p.communicate(timeout=JOIN_LIMIT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the two processes ({mode}) did not end within "
                    f"{JOIN_LIMIT} s")
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-4000:]
    return [out_ for out_, _ in results]


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """Both ranks' results of every analysis, and the inputs."""
    out = tmp_path_factory.mktemp("multihost")
    w = inputs()
    np.savez(out / "inputs.npz", **w)
    run_two(out, "analyses", ANALYSES)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in (0, 1)]
    return w, ranks, out


# -- one process --------------------------------------------------------------

def test_process_info_single_process():
    info = mh.process_info(devices=CPU8)
    ref = jmh.process_info()
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 8, "global_devices": 8}
    assert (info["process_count"], info["global_devices"]) == (
        ref["process_count"], ref["global_devices"])


def test_global_grid_mesh():
    mesh = mh.global_grid_mesh(devices=CPU8)
    ref = jmh.global_grid_mesh()
    assert mesh.axis_names == ref.axis_names == ("grid",)
    assert mesh.size == ref.devices.size == 8
    assert mesh.owners is None and not mesh.spans_processes


def test_host_local_to_global_roundtrip(rng):
    mesh = mh.global_grid_mesh(devices=CPU8)
    local = rng.normal(size=(4, 64))
    arr = mh.host_local_to_global(mesh, local, axis=-1)
    ref = jmh.host_local_to_global(jmh.global_grid_mesh(), local, axis=-1)
    assert tuple(arr.shape) == ref.shape == (4, 64)
    assert sorted(arr.blocks) == [(s,) for s in range(8)]
    assert all(b.shape == (4, 8) for b in arr.blocks.values())
    np.testing.assert_array_equal(arr.gather().numpy(), local)
    np.testing.assert_array_equal(np.asarray(ref), local)
    assert ref.sharding.spec[-1] == "grid" and arr.axes == (("grid",),)


def test_initialize_multihost_single_process_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mh.initialize_multihost()
    assert not torch.distributed.is_initialized()
    assert (mh.process_index(), mh.process_count()) == (0, 1)


def test_host_local_to_global_needs_a_contiguous_block(rng):
    mesh = Mesh(CPU8, ("grid",), owners=[0, 1] * 4)
    with pytest.raises(ValueError, match="contiguous"):
        mh.host_local_to_global(mesh, rng.normal(size=(4, 32)))


@pytest.mark.parametrize("name", ["window", "topk_eigh", "pallas", "topk_2d",
                                  "window_2d"])
def test_global_inputs_equal_whole_in_one_process(name):
    """GlobalTensor inputs in one process: the whole analysis's blocks,
    bit for bit."""
    w = {n: torch.from_numpy(a) for n, a in inputs().items()}
    opts, dims = ANALYSES[name]
    if dims == 1:
        mesh = make_grid_mesh(8, devices=CPU8)
        fn = th.halo_letkf_analysis(mesh, GaspariCohn((RADIUS,),
                                                      coord1_distance), **opts)
        args = args1(w)
        glob = [mh.host_local_to_global(mesh, a, axis=d)
                for a, d in zip(args, (1, 0, 0, 0, 0, 0, 0))]
    else:
        mesh = Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4),
                    ("row", "col"))
        fn = th.halo_letkf_analysis_2d(mesh, GaspariCohn((R2,), dist2d),
                                       **opts)
        args = args2(w)
        tiles = dict(axis_name=("row", "col"))
        glob = ([mh.host_local_to_global(mesh, args[0], axis=(1, 2),
                                         **tiles)]
                + [mh.host_local_to_global(mesh, a, axis=0,
                                           axis_name=(("row", "col"),))
                   for a in args[1:6]]
                + [mh.host_local_to_global(mesh, args[6], axis=(0, 1),
                                           **tiles)])
    whole = fn(*args)
    out = fn(*glob)
    assert isinstance(out, mh.GlobalTensor) and len(out.blocks) == 8
    assert torch.equal(out.gather(), whole)


def test_rdma_on_a_mesh_across_processes_raises():
    mesh = Mesh(CPU8, ("grid",), owners=[0] * 4 + [1] * 4)
    with pytest.raises(NotImplementedError, match="peer pointers"):
        th.halo_letkf_analysis(mesh, GaspariCohn((RADIUS,), coord1_distance),
                               max_obs=32, use_pallas=True, comm="rdma")


def test_exchange_blocks_in_one_process_copies(rng):
    blocks = [torch.as_tensor(rng.normal(size=(2, 3))) for _ in range(4)]
    got = mh.exchange_blocks(blocks, [[(s + 1) % 4, (s - 1) % 4]
                                      for s in range(4)])
    for s in range(4):
        assert got[s][0] is blocks[(s + 1) % 4]
        assert torch.equal(got[s][1], blocks[(s - 1) % 4])


def test_sharded_weights_round_trip_one_process(tmp_path, rng):
    weights = torch.as_tensor(rng.normal(size=(16, 5, 5)))
    mesh = make_grid_mesh(4, devices=CPU8[:4])
    ckpt.save_weights_sharded(tmp_path / "a", mh.host_local_to_global(
        mesh, weights, axis=0))
    assert torch.equal(ckpt.load_weights_sharded(tmp_path / "a",
                                                 device="cpu"), weights)
    by_mesh = ckpt.load_weights_sharded(tmp_path / "a", mesh=mesh)
    assert sorted(by_mesh.blocks) == [(s,) for s in range(4)]
    assert torch.equal(by_mesh.gather(), weights)
    # another shard count re-slices; a whole tensor is refused
    mesh8 = make_grid_mesh(8, devices=CPU8)
    assert torch.equal(ckpt.load_weights_sharded(tmp_path / "a",
                                                 mesh=mesh8).gather(),
                       weights)
    with pytest.raises(ValueError, match="GlobalTensor"):
        ckpt.save_weights_sharded(tmp_path / "b", weights)


# -- two processes ------------------------------------------------------------

def one_process(w, name):
    """The port's one-process 8-shard analysis."""
    opts, dims = ANALYSES[name]
    t = {n: torch.from_numpy(a) for n, a in w.items()}
    if dims == 1:
        return th.halo_letkf_analysis(
            make_grid_mesh(8, devices=CPU8),
            GaspariCohn((RADIUS,), coord1_distance), **opts)(*args1(t))
    return th.halo_letkf_analysis_2d(
        Mesh(np.asarray(CPU8, dtype=object).reshape(2, 4), ("row", "col")),
        GaspariCohn((R2,), dist2d), **opts)(*args2(t))


@pytest.fixture
def cheb_interpret(monkeypatch):
    """JAX's K4 in interpret mode (no TPU here), as tests/test_halo.py."""
    orig = jpk.letkf_nbh_analysis_cheb

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(jpk, "letkf_nbh_analysis_cheb", interp)


def jax_analysis(w, name):
    opts, dims = ANALYSES[name]
    if dims == 1:
        return np.asarray(jh.halo_letkf_analysis(
            jax_grid_mesh(8), JGaspariCohn((RADIUS,), jax_coord1), **opts)(
            *map(jnp.asarray, args1(w))))
    mesh = JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("row", "col"))
    return np.asarray(jh.halo_letkf_analysis_2d(
        mesh, JGaspariCohn((R2,), jax_dist2d), **opts)(
        *map(jnp.asarray, args2(w))))


@pytest.mark.parametrize("form", ["", "_global"])
@pytest.mark.parametrize("name", sorted(ANALYSES))
def test_two_processes_equal_one_process(two_process, name, form):
    w, ranks, _ = two_process
    ref = one_process(w, name).numpy()
    for res in ranks:
        np.testing.assert_array_equal(res[name + form], ref)


@pytest.mark.parametrize("name", sorted(ANALYSES))
def test_two_processes_match_jax(two_process, cheb_interpret, name):
    w, ranks, _ = two_process
    ref = jax_analysis(w, name)
    if name in ("topk_eigh", "topk_2d"):
        close(ranks[0][name], ref)
    else:
        rel_close(ranks[0][name], ref)


@pytest.mark.parametrize("form", ["", "_global"])
def test_two_processes_sharded_letkf(two_process, form):
    w, ranks, _ = two_process
    t = {n: torch.from_numpy(a) for n, a in w.items()}
    loc = GaspariCohn((RADIUS,), coord1_distance)
    ref = tpl.sharded_letkf_analysis(
        make_grid_mesh(8, devices=CPU8), loc, t["data"], t["perts"],
        t["innov"], t["ginfo"], t["oinfo"], 1.1).numpy()
    for res in ranks:
        np.testing.assert_array_equal(res["sharded" + form], ref)
    jax_ref = jpl.sharded_letkf_analysis(
        jax_grid_mesh(8), JGaspariCohn((RADIUS,), jax_coord1),
        *map(jnp.asarray, (w["data"], w["perts"], w["innov"], w["ginfo"],
                           w["oinfo"])), 1.1)
    close(ranks[0]["sharded" + form], jax_ref)


def test_two_processes_checkpoint(two_process):
    """The DCP checkpoint written by both processes: loaded whole here, it
    equals the one-process weights bit for bit and JAX's within 1e-10; each
    process's load by mesh gave its blocks back."""
    w, ranks, out = two_process
    t = {n: torch.from_numpy(a) for n, a in w.items()}
    loc = GaspariCohn((RADIUS,), coord1_distance)
    ref = tpl.sharded_letkf_weights(make_grid_mesh(8, devices=CPU8), loc,
                                    t["perts"], t["innov"], t["ginfo"],
                                    t["oinfo"], 1.1)
    whole = ckpt.load_weights_sharded(out / "weights", device="cpu")
    assert torch.equal(whole, ref)
    for res in ranks:
        np.testing.assert_array_equal(res["weights"], ref.numpy())
        np.testing.assert_array_equal(res["weights_by_mesh"], ref.numpy())
    close(whole, jpl.sharded_letkf_weights(
        jax_grid_mesh(8), JGaspariCohn((RADIUS,), jax_coord1),
        *map(jnp.asarray, (w["perts"], w["innov"], w["ginfo"], w["oinfo"])),
        1.1))


def test_strict_window_raises_on_both_ranks(tmp_path):
    """max_obs=2 is below the in-support count: both ranks raise the same
    ValueError, from whole inputs and from GlobalTensor ones (whose check
    meets in a MAX all_reduce), and both end. The group forms from
    torchrun's env:// variables (``initialize_multihost()`` without
    arguments)."""
    np.savez(tmp_path / "inputs.npz", **inputs())
    run_two(tmp_path, "strict")
    for rank in (0, 1):
        res = json.loads((tmp_path / f"strict{rank}.json").read_text())
        for label in ("whole", "global"):
            assert res[label].startswith("raised: a grid column may see"), \
                res[label]


def test_torchrun_default_mesh_takes_each_process_card(tmp_path):
    """Under torchrun's variables (LOCAL_WORLD_SIZE=2) on a host whose two
    cards both processes see, the default mesh holds each process's own
    card once: as many positions as the processes' own devices."""
    run_two(tmp_path, "cards")
    for rank in (0, 1):
        res = json.loads((tmp_path / f"cards{rank}.json").read_text())
        assert res["devices"] == ["cuda:0", "cuda:1"]
        assert res["owners"] == [0, 1]
        assert res["info"] == {"process_index": rank, "process_count": 2,
                               "local_devices": 1, "global_devices": 2}


def test_scaling_example_across_two_processes(tmp_path):
    """``examples/torch_scaling.py`` as ``torchrun --nproc-per-node 2``
    would run it on the CPU: a mesh of 2 processes, rank 0 prints a row per
    shard count."""
    script = os.path.join(REPO, "examples", "torch_scaling.py")
    outs = run_two(tmp_path, "example", command=[
        sys.executable, script, "--device", "cpu", "--grid-per-dev", "32",
        "--reps", "1", "--shards", "2,4", "--ens", "10"])
    rows = [json.loads(line) for line in outs[0].split("\n") if line]
    assert [(r["devices"], r["processes"], r["grid"]) for r in rows] == [
        (2, 2, 128), (4, 2, 128)]
    assert "CAVEAT" in rows[1] and outs[1] == ""
