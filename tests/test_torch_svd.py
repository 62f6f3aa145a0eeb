"""
The port's one-sided Jacobi SVD (tpu_assim_torch.ops.cuda.svd: the plain
version of kernel K3 and the eigendecomposition through it) and the
dispatch of tpu_assim_torch.ops.linalg.svd / eigh_psd, against the JAX
package on the same numpy inputs.

U and V are compared only through sign-invariant quantities (singular
values, reconstruction, orthogonality), except where both sides run the
same rotations in f64. On the CPU ``svd_jacobi`` runs its plain version,
so these tests reach the algorithm but not the CUDA kernel, which
chip_smoke.py holds against the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_assim.ops import linalg as jl
from tpu_assim.ops.pallas.svd import eigh_svd_jacobi as jax_eigh_svd
from tpu_assim.ops.pallas.svd import svd_jacobi as jax_svd_jacobi

from tpu_assim_torch.ops import linalg as tl
from tpu_assim_torch.ops.cuda import jacobi as k7
from tpu_assim_torch.ops.cuda import svd as k3

# One intra-op thread: the suite runs in several worker processes, and
# torch's spinning OpenMP threads would compete with JAX's for the cores.
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.asarray(a))


def rec(u, s, v):
    return np.einsum("...ik,...k,...jk->...ij", np.asarray(u), np.asarray(s),
                     np.asarray(v))


def orth_err(q):
    q = np.asarray(q)
    eye = np.eye(q.shape[-1])
    return np.abs(np.swapaxes(q, -1, -2) @ q - eye).max()


def span_batch(rng, b, k, smallest, dtype=np.float64):
    """Random K x K matrices with singular values log-spaced from 1 down
    to ``smallest``."""
    q1 = np.linalg.qr(rng.normal(size=(b, k, k)))[0]
    q2 = np.linalg.qr(rng.normal(size=(b, k, k)))[0]
    sv = np.logspace(0, np.log10(smallest), k)
    return np.einsum("bik,k,bjk->bij", q1, sv, q2).astype(dtype), sv


# -- svd_jacobi_plain --------------------------------------------------------

@pytest.mark.parametrize("k,b", [(8, 5), (40, 3), (13, 4)])
def test_plain_matches_jax_kernel_and_lapack_f64(rng, k, b):
    """s within rtol 1e-9 of JAX's interpret-mode kernel and of
    jnp.linalg.svd; reconstruction and orthogonality within 1e-10."""
    a = rng.normal(size=(b, k, k))
    u, s, v = k3.svd_jacobi_plain(t(a))
    _, s_jax, _ = jax_svd_jacobi(jnp.asarray(a), tile=8, interpret=True)
    s_lapack = jnp.linalg.svd(jnp.asarray(a), compute_uv=False)
    np.testing.assert_allclose(s, s_jax, rtol=1e-9)
    np.testing.assert_allclose(s, s_lapack, rtol=1e-9)
    np.testing.assert_allclose(rec(u, s, v), a, atol=1e-10)
    assert orth_err(u) < 1e-10 and orth_err(v) < 1e-10


def test_plain_multidimensional_batch(rng):
    a = rng.normal(size=(2, 3, 6, 6))
    u, s, v = k3.svd_jacobi_plain(t(a))
    assert u.shape == (2, 3, 6, 6) and s.shape == (2, 3, 6)
    np.testing.assert_allclose(
        s, jnp.linalg.svd(jnp.asarray(a), compute_uv=False), rtol=1e-9)
    np.testing.assert_allclose(rec(u, s, v), a, atol=1e-10)


def test_plain_near_singular_relative_accuracy(rng):
    """Singular values down to 1e-8 agree with JAX's kernel to 1e-9
    relative, and with the constructed ones to the 1e-16 rounding of the
    construction."""
    a, sv = span_batch(rng, 4, 10, 1e-8)
    _, s, _ = k3.svd_jacobi_plain(t(a))
    _, s_jax, _ = jax_svd_jacobi(jnp.asarray(a), tile=8, interpret=True)
    np.testing.assert_allclose(s, s_jax, rtol=1e-9)
    np.testing.assert_allclose(s, np.broadcast_to(sv, (4, 10)), rtol=1e-9,
                               atol=1e-15)


def test_sigma_span_needs_cap_20_in_f32(rng):
    """A sigma span of 1e4 in f32 converges under the cap of 20 sweeps
    (U orthogonal to 1e-4); a cap of 10 leaves U visibly non-orthogonal."""
    a, _ = span_batch(rng, 32, 40, 1e-4, np.float32)
    u, s, v = k3.svd_jacobi_plain(t(a))
    assert orth_err(u) < 1e-4 and orth_err(v) < 1e-4
    np.testing.assert_allclose(rec(u, s, v), a, atol=1e-5)
    u10, _, _ = k3.svd_jacobi_plain(t(a), sweeps=10)
    assert orth_err(u10) > 1e-2


def test_exact_zero_singular_value_gives_zero_u_column(rng):
    a = rng.normal(size=(3, 7, 7))
    a[:, :, 4] = 0.0
    u, s, v = k3.svd_jacobi_plain(t(a))
    assert (s[:, -1] == 0).all() and (u[:, :, -1] == 0).all()
    np.testing.assert_allclose(rec(u, s, v), a, atol=1e-12)
    assert orth_err(u[:, :, :-1]) < 1e-12 and orth_err(v) < 1e-12


def test_nan_matrix_terminates_and_leaves_neighbours_exact(rng):
    a = rng.normal(size=(3, 8, 8))
    bad = a.copy()
    bad[1, 2, 5] = np.nan
    u, s, v = k3.svd_jacobi_plain(t(bad))
    u_j, s_j, v_j = jax_svd_jacobi(jnp.asarray(bad), tile=8, interpret=True)
    for port, ref in ((u, u_j), (s, s_j), (v, v_j)):
        assert np.array_equal(np.isnan(np.asarray(port)),
                              np.isnan(np.asarray(ref)))
    assert torch.isnan(s[1]).all() and torch.isfinite(s[[0, 2]]).all()
    for i in (0, 2):
        for port, alone in zip((u, s, v), k3.svd_jacobi_plain(t(a[i]))):
            assert torch.equal(port[i], alone)


def test_cpu_dispatch_takes_the_plain_version(rng):
    a = t(rng.normal(size=(4, 6, 6)).astype(np.float32))
    before = dict(k3.LAUNCHES)
    for x, y in zip(k3.svd_jacobi(a), k3.svd_jacobi_plain(a)):
        assert torch.equal(x, y)
    assert k3.LAUNCHES == before
    with pytest.raises(ValueError, match="square"):
        k3.svd_jacobi(a[:, :5])


# -- eigh through the SVD -----------------------------------------------------

def _spd(rng):
    z = rng.normal(size=(5, 12, 8))
    return np.einsum("bki,bmi->bkm", z, z) + 2 * np.eye(12)


def _rank_deficient(rng):
    z = rng.normal(size=(4, 10, 3))
    return np.einsum("bki,bmi->bkm", z, z)


def _degenerate_cluster(rng):
    q = np.linalg.qr(rng.normal(size=(3, 10, 10)))[0]
    evals = np.concatenate([np.full(6, 2.5), np.linspace(0.1, 9, 4)])
    return np.einsum("bik,k,bjk->bij", q, evals, q)


def _indefinite_separated(rng):
    q = np.linalg.qr(rng.normal(size=(4, 6, 6)))[0]
    evals = np.array([-3.0, -1.2, 0.4, 2.0, 5.0, 7.7])
    return np.einsum("bik,k,bjk->bij", q, evals, q)


@pytest.mark.parametrize("make", [_spd, _rank_deficient, _degenerate_cluster,
                                  _indefinite_separated])
def test_eigh_svd_jacobi_matches_jax(rng, make):
    """Eigenvalues against JAX's interpret-mode eigh-through-SVD and
    jnp.linalg.eigh at 1e-9; reconstruction and orthogonality at 1e-9 (the
    inputs of tests/test_linalg.py: no +lambda/-lambda magnitude ties)."""
    a = make(rng)
    ev, evec = k3.eigh_svd_jacobi(t(a))
    ev_jax, _ = jax_eigh_svd(jnp.asarray(a), tile=8, interpret=True)
    ev_lapack, _ = jnp.linalg.eigh(jnp.asarray(a))
    np.testing.assert_allclose(ev, ev_jax, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ev, ev_lapack, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(rec(evec, ev, evec), a, atol=1e-9)
    assert orth_err(evec) < 1e-9


# -- linalg: svd, rev_svd and the dispatch gate -------------------------------

@pytest.mark.parametrize("reg", [0.0, 0.3])
def test_linalg_svd_and_rev_svd_match_jax(rng, reg):
    a = rng.normal(size=(3, 7, 7))
    u, s, v = tl.svd(t(a), reg)
    u_j, s_j, v_j = jl.svd(jnp.asarray(a), reg, use_jacobi=False)
    np.testing.assert_allclose(s, s_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.rev_svd(u, s - reg, v), a, atol=1e-10)
    np.testing.assert_allclose(tl.rev_svd(u, 1.0 / s, v),
                               jl.rev_svd(u_j, 1.0 / s_j, v_j), atol=1e-10)


@pytest.fixture
def cpu_is_a_kernel_device(monkeypatch):
    """Let the gate take CPU tensors, so that it routes them to the plain
    version of the kernel."""
    monkeypatch.setattr(tl, "JACOBI_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.delenv("TPU_ASSIM_JACOBI", raising=False)
    monkeypatch.delenv("TPU_ASSIM_EIGH_KERNEL", raising=False)
    yield
    tl.set_jacobi_dispatch(None)


@pytest.mark.parametrize("shape,dtype,taken", [
    ((256, 8, 8), torch.float32, True),
    ((4, 64, 64, 64), torch.float32, True),
    ((256, 8, 8), torch.float64, False),
    ((256, 65, 65), torch.float32, False),
    ((255, 8, 8), torch.float32, False),
    ((256, 8, 7), torch.float32, False),
    ((8, 8), torch.float32, False),
])
def test_gate_conditions(cpu_is_a_kernel_device, shape, dtype, taken):
    x = torch.zeros(shape, dtype=dtype)
    assert tl._takes_jacobi(x, None) is taken
    assert tl._takes_jacobi(x, False) is False


def test_gate_sends_nothing_on_the_cpu_by_default():
    assert tl.JACOBI_DEVICE_TYPES == ("cuda",)
    assert not tl._takes_jacobi(torch.zeros(256, 8, 8), True)


def test_gate_controls(cpu_is_a_kernel_device, monkeypatch):
    x = torch.zeros(256, 8, 8)
    tl.set_jacobi_dispatch(False)
    assert not tl.jacobi_dispatch_enabled() and not tl._takes_jacobi(x, None)
    assert tl._takes_jacobi(x, True)
    tl.set_jacobi_dispatch(None)
    monkeypatch.setenv("TPU_ASSIM_JACOBI", "0")
    assert not tl._takes_jacobi(x, None)
    monkeypatch.setenv("TPU_ASSIM_JACOBI", "1")
    assert tl._takes_jacobi(x, None)


def test_routes_reach_the_plain_kernel(cpu_is_a_kernel_device, rng,
                                       monkeypatch):
    """Through the gate, svd and eigh_psd call the kernel wrapper, which on
    the CPU runs the plain version; f32 results agree with LAPACK's."""
    calls = []
    plain = k3.svd_jacobi_plain
    monkeypatch.setattr(k3, "svd_jacobi_plain",
                        lambda a, sweeps=20: calls.append(a.shape)
                        or plain(a, sweeps))
    a = rng.normal(size=(256, 6, 6)).astype(np.float32)
    _, s, _ = tl.svd(t(a))
    g = np.einsum("bik,bjk->bij", a, a)
    ev, _ = tl.eigh_psd(t(g))
    assert calls == [(256, 6, 6), (256, 6, 6)]
    np.testing.assert_allclose(s, np.linalg.svd(a, compute_uv=False),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(g), rtol=1e-4,
                               atol=1e-4)


def test_twosided_eigh_routes_to_k7(cpu_is_a_kernel_device, monkeypatch):
    """TPU_ASSIM_EIGH_KERNEL=twosided sends eigh_psd's batches on the gate to
    the two-sided kernel's wrapper (its plain version on the CPU) with the
    JAX dispatch's 7 sweeps, exact on a +lambda/-lambda tie; off the gate
    the variable is not read, as in the JAX package."""
    calls = []
    plain = k7.eigh_jacobi_plain
    monkeypatch.setattr(
        k7, "eigh_jacobi_plain",
        lambda a, sweeps=7, with_sweeps=False: calls.append(
            (tuple(a.shape), sweeps)) or plain(a, sweeps, with_sweeps))
    monkeypatch.setenv("TPU_ASSIM_EIGH_KERNEL", "twosided")
    q = np.linalg.qr(np.random.RandomState(5).normal(size=(256, 4, 4)))[0]
    a = np.einsum("bik,k,bjk->bij", q, [-2.0, -1.0, 1.0, 2.0], q)
    ev, evec = tl.eigh_psd(t(a.astype(np.float32)))
    assert calls == [((256, 4, 4), 7)]
    np.testing.assert_allclose(ev, np.broadcast_to([-2.0, -1, 1, 2],
                                                   (256, 4)), atol=1e-5)
    np.testing.assert_allclose(rec(evec, ev, evec), a, atol=1e-5)
    ev, _ = tl.eigh_psd(torch.eye(4, dtype=torch.float64)[None])
    assert torch.equal(ev, torch.ones(1, 4, dtype=torch.float64))
    assert len(calls) == 1
