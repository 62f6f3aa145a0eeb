"""
The port's native host runtime (tpu_assim_torch.runtime) against the JAX
package's and against numpy:

- The CPU LETKF, ETKF, bucketing and taper of the port's copy of
  ``letkf_cpu.cpp`` against their numpy twins, against the JAX package's
  runtime and against the port's torch solvers; the numpy fallbacks
  against the native library.
- TAOB files: each package reads the other's, byte for byte.
- ``ObsLoader``: its batches in ``shard_observations``' layout (the JAX
  package's and the port's), native and numpy fallback, and as tensors on
  a device; its capacity error.
- The slot race the JAX package's loader has (ROADMAP, "Before the
  queues"): 6 files at depth 3 over many passes in a subprocess with a
  time limit, every batch in file order and holding exactly its file's
  observations.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpu_assim.parallel.halo import shard_observations as jax_shard_obs
from tpu_assim.runtime import native as jrt
from tpu_assim.runtime import obs_pipeline as jop

from tpu_assim_torch.ops.etkf import etkf_weights, letkf_weights_dense
from tpu_assim_torch.parallel.halo import shard_observations
from tpu_assim_torch.runtime import native as rt
from tpu_assim_torch.runtime import obs_pipeline as op

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-9, atol=1e-11)
RACE_LIMIT = 60      # seconds for the whole multi-pass run


def test_native_builds_from_the_ports_copy():
    assert rt.native_available()
    assert rt._SRC.parent == op._SRC.parent
    assert rt._SRC.parent.name == "cpp"
    assert op._lib() is not None


def problem(rng, k=8, o=30, g=17):
    perts = rng.normal(size=(k, o))
    perts -= perts.mean(axis=0, keepdims=True)
    innov = rng.normal(size=o)
    obs_w = np.where(rng.uniform(size=(g, o)) < 0.4, 0.0,
                     rng.uniform(0.1, 1.0, size=(g, o)))
    return perts, innov, obs_w


def test_letkf_weights_match_numpy_twin_jax_and_torch(rng):
    perts, innov, obs_w = problem(rng)
    ours = rt.letkf_weights_dense_cpu(perts, innov, obs_w, 1.2)
    np.testing.assert_allclose(ours, rt._letkf_weights_dense_numpy(
        perts, innov, obs_w, 1.2), **TOL)
    np.testing.assert_allclose(ours, jrt.letkf_weights_dense_cpu(
        perts, innov, obs_w, 1.2), **TOL)
    np.testing.assert_allclose(ours, letkf_weights_dense(
        *map(torch.as_tensor, (perts, innov, obs_w)), 1.2).numpy(), **TOL)


def test_etkf_weights_match_torch(rng):
    perts, innov, _ = problem(rng, k=10, o=25)
    ours = rt.etkf_weights_cpu(perts, innov, 1.1)
    np.testing.assert_allclose(ours, etkf_weights(
        torch.as_tensor(perts), torch.as_tensor(innov), 1.1).numpy(), **TOL)
    np.testing.assert_allclose(ours, jrt.etkf_weights_cpu(perts, innov, 1.1),
                               **TOL)


def test_all_zero_weights_column(rng):
    perts, innov, _ = problem(rng, k=6, o=12)
    out = rt.letkf_weights_dense_cpu(perts, innov, np.zeros((1, 12)), 1.44)
    np.testing.assert_allclose(out[0], 1.2 * np.eye(6), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("fallback", [False, True])
def test_bucket_and_taper_match_jax(rng, monkeypatch, fallback):
    obs_idx = rng.choice(128, size=50).astype(np.int32)
    grid = rng.uniform(0, 100, size=40)
    obs = rng.uniform(0, 100, size=30)
    ref_order, ref_counts, ref_max = jrt.bucket_obs_cpu(obs_idx, 128, 8)
    ref_gc = jrt.gaspari_cohn_cpu(grid, obs, 10.0)
    if fallback:
        monkeypatch.setattr(rt, "_load", lambda: None)
    order, counts, maxc = rt.bucket_obs_cpu(obs_idx, 128, 8)
    np.testing.assert_array_equal(counts, ref_counts)
    assert maxc == ref_max
    np.testing.assert_array_equal(obs_idx[order] // 16,
                                  obs_idx[ref_order] // 16)
    np.testing.assert_allclose(rt.gaspari_cohn_cpu(grid, obs, 10.0), ref_gc,
                               rtol=1e-12, atol=1e-12)


def test_numpy_fallback_matches_native(rng, monkeypatch):
    perts, innov, obs_w = problem(rng, k=6, o=20, g=5)
    native = rt.letkf_weights_dense_cpu(perts, innov, obs_w, 1.1)
    monkeypatch.setattr(rt, "_load", lambda: None)
    np.testing.assert_allclose(rt.letkf_weights_dense_cpu(
        perts, innov, obs_w, 1.1), native, rtol=1e-9, atol=1e-11)


# -- TAOB files and the loader ------------------------------------------------

def batch(rng, n_grid, o, d=1):
    vals = rng.randn(o)
    var = rng.uniform(0.5, 1.5, size=o)
    gidx = rng.choice(n_grid, size=o, replace=False).astype(np.int64)
    coords = gidx.astype(np.float64)[:, None] * np.ones((1, d))
    return vals, var, gidx, coords


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_taob_files_cross_packages(rng, tmp_path, writer):
    b = batch(rng, 64, 20, d=2)
    path = str(tmp_path / "obs.taob")
    (op if writer == "port" else jop).write_obs_file(path, *b)
    for reader in (op, jop):
        for got, want in zip(reader.read_obs_file(path), b):
            np.testing.assert_array_equal(got, want)
    other = str(tmp_path / "other.taob")
    (jop if writer == "port" else op).write_obs_file(other, *b)
    assert open(path, "rb").read() == open(other, "rb").read()


@pytest.mark.parametrize("fallback", [False, True])
def test_loader_batches_match_shard_observations(rng, tmp_path, fallback,
                                                 monkeypatch):
    if fallback:
        monkeypatch.setattr(op, "_lib", lambda: None)
    n_grid, n_shards, o = 128, 8, 40
    vals, var, gidx, coords = batch(rng, n_grid, o)
    path = str(tmp_path / "b0.taob")
    jop.write_obs_file(path, vals, var, gidx, coords)
    ref = jax_shard_obs(vals, var, gidx, coords, n_grid, n_shards)
    port = shard_observations(vals, var, gidx, coords, n_grid, n_shards)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a, b)
    ref_v, ref_r, ref_l, ref_c, ref_valid, p = ref
    with op.ObsLoader([path], n_grid, n_shards, cap=p) as loader:
        (idx, lv, lr, ll, lc, lvalid), = list(loader)
    assert idx == 0
    np.testing.assert_array_equal(lv, ref_v)
    np.testing.assert_array_equal(lvalid, ref_valid)
    np.testing.assert_array_equal(ll, ref_l)
    np.testing.assert_array_equal(lc[:, 0][lvalid > 0],
                                  ref_c[:, 0][ref_valid > 0])
    np.testing.assert_array_equal(lr[lvalid > 0], ref_r[ref_valid > 0])


def test_loader_hands_tensors_to_a_device(rng, tmp_path):
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"c{i}.taob"))
        op.write_obs_file(paths[-1], *batch(rng, 64, 12))
    numpy_batches = list(op.ObsLoader(paths, 64, 4, cap=12, depth=2))
    tensor_batches = list(op.ObsLoader(paths, 64, 4, cap=12, depth=2,
                                       device="cpu"))
    for a, b in zip(numpy_batches, tensor_batches):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
            np.testing.assert_array_equal(x, y.numpy())


def test_cap_overflow_raises(rng, tmp_path):
    gidx = np.arange(10, dtype=np.int64)
    path = str(tmp_path / "o.taob")
    op.write_obs_file(path, rng.randn(10), np.ones(10), gidx,
                      gidx.astype(np.float64)[:, None])
    with pytest.raises(ValueError, match="cap"):
        with op.ObsLoader([path], 64, 4, cap=4) as loader:
            list(loader)


RACE = textwrap.dedent("""
    import os, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    sys.modules["jax"] = None
    from tpu_assim_torch.runtime.obs_pipeline import ObsLoader, write_obs_file

    rng = np.random.RandomState(0)
    paths, files = [], []
    for i in range(6):
        gidx = rng.choice(64, size=12, replace=False).astype(np.int64)
        vals = rng.randn(12)
        paths.append(os.path.join(sys.argv[2], f"c{i}.taob"))
        write_obs_file(paths[-1], vals, np.ones(12), gidx,
                       gidx.astype(float)[:, None])
        files.append(np.sort(vals))
    passes = int(sys.argv[3])
    for n in range(passes):
        with ObsLoader(paths, 64, 4, cap=12, depth=3) as loader:
            seen = [(idx, np.sort(lv[lvalid > 0]))
                    for idx, lv, _r, _l, _c, lvalid in loader]
        assert [i for i, _ in seen] == list(range(6)), (n, seen)
        for i, got in seen:
            assert np.array_equal(got, files[i]), (n, i)
    print(passes, flush=True)
""")


def test_loader_race_repaired(tmp_path):
    """The JAX package's loader hung within a few passes of this loop
    (scripts/obs_loader_race.py); the port's makes every pass, each batch
    in file order and exactly its file's observations."""
    passes = 300
    proc = subprocess.run(
        [sys.executable, "-c", RACE, REPO, str(tmp_path), str(passes)],
        capture_output=True, text=True, timeout=RACE_LIMIT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[-1] == str(passes)
