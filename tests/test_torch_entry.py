"""
The port's driver entry points (tpu_assim_torch.entry) against the JAX
package's ``__graft_entry__.py``, on the CPU.

- ``entry()``'s arguments equal JAX's ``_build_problem`` draws exactly;
  its step, built in f64 on both sides, within 1e-10 of JAX's ``entry()``
  step; its eigh batch is the 256 matrices of 20 x 20 that K3's gate takes
  (one call of K3's plain version with the gate opened to CPU tensors).
- ``dryrun_multichip`` runs to its end on 8 and 3 CPU positions (the 2 x
  4 members x grid mesh and the 1-D grid mesh), and raises when a check
  fails.
- Without a card and without devices both raise: nothing falls back to
  the CPU.
- ``python -m tpu_assim_torch.entry --device cpu`` runs without JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as ge

from tpu_assim_torch import entry as te
from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops.cuda import svd as k3

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_arguments_equal_jax_draws(dtype):
    port = te._build_problem(20, 256, 64, dtype, "cpu")
    ref = ge._build_problem(20, 256, 64, dtype)
    assert len(port) == len(ref) == 6
    for a, b in zip(port, ref):
        b = np.asarray(b)
        assert a.device.type == "cpu" and a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def test_entry_arguments_are_jax_entry_arguments():
    _, port = te.entry("cpu")
    _, ref = ge.entry()
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_step_matches_jax_entry_in_f64():
    step, args = te.entry("cpu", dtype="float64")
    fn, _ = ge.entry()
    ref = np.asarray(fn(*ge._build_problem(20, 256, 64, "float64")))
    out = step(*args)
    assert out.shape == (20, 256) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_step_eigh_batch_meets_the_k3_gate(monkeypatch):
    """f32: the analysis's one eigh batch, [256, 20, 20], goes to K3 (its
    plain version, the gate opened to CPU tensors), within 1e-5 of max of
    the LAPACK route."""
    step, args = te.entry("cpu")
    lapack = step(*args)
    monkeypatch.setattr(tl, "JACOBI_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.delenv("TPU_ASSIM_JACOBI", raising=False)
    calls = []
    plain = k3.svd_jacobi_plain
    monkeypatch.setattr(k3, "svd_jacobi_plain",
                        lambda a, sweeps=20: calls.append(tuple(a.shape))
                        or plain(a, sweeps))
    out = step(*args)
    assert calls == [(256, 20, 20)]
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    err = float((out - lapack).abs().max())
    assert err <= 1e-5 * float(lapack.abs().max()), err


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_runs_to_its_end(n):
    te.dryrun_multichip(n, devices=["cpu"] * n)


def test_dryrun_raises_on_a_failed_check(monkeypatch):
    """A sharded step that is off by 1e-3 fails the dryrun's check."""
    real = te.sharded_cycle_step

    def off(*a, **kw):
        step = real(*a, **kw)
        return lambda *args: step(*args) + 1e-3

    monkeypatch.setattr(te, "sharded_cycle_step", off)
    with pytest.raises(AssertionError, match="unsharded"):
        te.dryrun_multichip(4, devices=["cpu"] * 4)


def test_dryrun_needs_enough_devices():
    with pytest.raises(ValueError, match="need 8 devices"):
        te.dryrun_multichip(8, devices=["cpu"] * 4)


def test_no_card_no_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.dryrun_multichip(2)


def test_module_runs_without_jax():
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.argv = ['entry', '--device', 'cpu']; "
            "runpy.run_module('tpu_assim_torch.entry', run_name='__main__')")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split("\n")[:2] == ["(20, 256)", "dryrun ok"]
